#!/bin/sh
# Build the native fastio runtime (auto-invoked by ipp_tpu.native on first
# import; this script exists for manual/CI builds).
set -e
cd "$(dirname "$0")"
g++ -O3 -std=c++17 -shared -fPIC -pthread fastio.cpp -o libfastio.so -lz \
    -l:libzstd.so.1
echo "built $(pwd)/libfastio.so"

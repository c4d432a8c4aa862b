"""A/B the tile executor's lagged fetch (IPP_TPU_EXEC_ASYNC) on the device.

Interleaves serialized and lagged passes of the bench preprocess stage
(24x1024^2 destripe via batch_filter) so drift cancels; prints per-pass
wall times and medians.  Run:
  python scripts/exec_async_ab.py
"""
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ipp_tpu.utils.jaxconfig import enable_persistent_cache

enable_persistent_cache()

from ipp_tpu.io import tiff as tio  # noqa: E402
from ipp_tpu.ops.process import ProcessConfig  # noqa: E402
from ipp_tpu.pipeline import pystripe_cli  # noqa: E402

rng = np.random.default_rng(0)
td = tempfile.TemporaryDirectory()
src = Path(td.name) / "src"
src.mkdir()
n_tiles = 24
for i in range(n_tiles):
    tio.imwrite(src / f"t{i:03d}.tif",
                rng.integers(0, 40000, (1024, 1024)).astype(np.uint16))
cfg = ProcessConfig(sigma=(128, 128), wavelet="db9", dark=100.0)

# warm compile
pystripe_cli.batch_filter(src, Path(td.name) / "warm", cfg, batch_size=8)

times = {"lag": [], "ser": []}
k = 0
for rep in range(4):
    for mode in ("ser", "lag"):
        os.environ["IPP_TPU_EXEC_ASYNC"] = "1" if mode == "lag" else "0"
        out = Path(td.name) / f"out_{mode}_{rep}"
        t0 = time.time()
        pystripe_cli.batch_filter(src, out, cfg, batch_size=8)
        dt = time.time() - t0
        times[mode].append(dt)
        k += 1
        print(f"pass {k}: {mode} {dt:.2f}s", file=sys.stderr)

mpix = n_tiles * 1024 * 1024 / 1e6
med_l = statistics.median(times["lag"])
med_s = statistics.median(times["ser"])
print(f"serialized: {['%.2f' % t for t in times['ser']]} median {med_s:.2f}s"
      f" ({mpix / med_s:.1f} Mpix/s)")
print(f"lagged:     {['%.2f' % t for t in times['lag']]} median {med_l:.2f}s"
      f" ({mpix / med_l:.1f} Mpix/s)")
print(f"lagged/serialized: {med_l / med_s:.3f}")

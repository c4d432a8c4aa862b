"""Compile-warmup tool (VERDICT r4 item 2): inventory + completeness.

The completeness test is the strong one: with the persistent-cache
store-everything threshold (IPP_TPU_XLA_CACHE_MIN_COMPILE=0), a warmup
subprocess primes a fresh cache directory, then the REAL process_images
CLI runs in a second subprocess against the same cache — and must add no
new cache entries.  Any executable the warmup enumeration misses shows
up as a new entry and fails the test, which is what keeps the inventory
honest as the pipeline evolves.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.synth import cut_tiles, make_phantom, write_tile_grid

REPO = Path(__file__).resolve().parent.parent
CH = "Ex_488_Em_525"


def _dataset(tmp_path):
    rng = np.random.default_rng(3)
    vol = make_phantom(rng, (6, 200, 200), smooth=6.0)
    stripes = 1.0 + 0.25 * np.sin(
        np.arange(vol.shape[2]) / 3.0)[None, None, :]
    # jitter=0: alignment lands on the stage grid, so the nominal layout
    # the warmup primes IS the placed layout.  The 70 px grid step is a
    # multiple of 10 so stage positions are EXACT in tenths-of-um at
    # 0.41 um/px (70 * 4.1 = 287) — any other step quantizes the nominal
    # extent a pixel off the placed one, which is precisely the
    # layout-dependence the warmup tool documents
    tiles, _ = cut_tiles(vol * stripes, 2, 2, (120, 120), 50, jitter=0,
                         rng=np.random.default_rng(4))
    ch_dir = tmp_path / "raw" / CH
    ch_dir.mkdir(parents=True)
    write_tile_grid(ch_dir, tiles, overlap_nominal_px=50,
                    voxel_um=(0.41, 0.41, 0.2))
    return tmp_path / "raw"


def _args(raw, tmp_path):
    return [
        "--input", str(raw),
        "--preprocessed", str(tmp_path / "pre"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x",
        "--sigma1", "24", "--sigma2", "24", "--wavelet", "db3",
        "--search-radius", "6", "--subvol-dim", "6",
        "--downsampled-voxel", "4.0",
        "--skip-inspection",
    ]


def _run(mod_args, cache_dir, timeout=900):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    env["IPP_TPU_XLA_CACHE_MIN_COMPILE"] = "0"
    env["IPP_TPU_PROGRESS"] = "off"
    r = subprocess.run([sys.executable, "-m"] + mod_args, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    return r


def _cache_entries(cache_dir: Path):
    return {p.name for p in Path(cache_dir).glob("*") if p.is_file()}


@pytest.mark.slow
def test_warmup_stitch_inventory_completeness(tmp_path):
    raw = _dataset(tmp_path)
    cache = tmp_path / "xla_cache"
    cache.mkdir()
    args = _args(raw, tmp_path)

    r = _run(["ipp_tpu.pipeline.warmup", "stitch"] + args, cache)
    assert "warmup complete" in r.stdout + r.stderr
    primed = _cache_entries(cache)
    assert primed, "warmup stored nothing in the persistent cache"

    _run(["ipp_tpu.pipeline.process_images"] + args, cache)
    leaked = _cache_entries(cache) - primed
    assert not leaked, (
        f"{len(leaked)} executables compiled in-run that warmup missed — "
        f"extend stitch_programs() (cache keys: {sorted(leaked)[:8]})")


@pytest.mark.slow
def test_warmup_stitch_completeness_8bit_dark(tmp_path):
    """Same completeness bar for the dark/8-bit device-post path (the
    _dark_to8 mirror in warmup's prime_merge)."""
    raw = _dataset(tmp_path)
    cache = tmp_path / "xla_cache"
    cache.mkdir()
    args = _args(raw, tmp_path) + ["--convert-to-8bit", "--bit-shift",
                                   "4", "--dark", "60"]
    r = _run(["ipp_tpu.pipeline.warmup", "stitch"] + args, cache)
    assert "warmup complete" in r.stdout + r.stderr
    primed = _cache_entries(cache)
    _run(["ipp_tpu.pipeline.process_images"] + args, cache)
    leaked = _cache_entries(cache) - primed
    assert not leaked, (
        f"{len(leaked)} executables compiled in-run that warmup missed "
        f"on the 8bit/dark path (cache keys: {sorted(leaked)[:8]})")


@pytest.mark.slow
def test_warmup_stitch_mip_completeness(tmp_path):
    """--stitch-mip (single-plane MIP stacks, subvol_dim forced to 1, no
    npz) goes through resolve_channels' MIP branch — same zero-new-
    entries bar."""
    rng = np.random.default_rng(9)
    vol = make_phantom(rng, (1, 200, 200), smooth=6.0)
    tiles, _ = cut_tiles(vol * 300, 2, 2, (120, 120), 50, jitter=0,
                         rng=np.random.default_rng(2))
    ch_dir = tmp_path / "raw" / (CH + "_MIP")
    ch_dir.mkdir(parents=True)
    write_tile_grid(ch_dir, tiles, overlap_nominal_px=50,
                    voxel_um=(0.41, 0.41, 0.2))
    cache = tmp_path / "xla_cache"
    cache.mkdir()
    args = ["--input", str(tmp_path / "raw"),
            "--preprocessed", str(tmp_path / "pre"),
            "--stitched", str(tmp_path / "st"), "--objective", "15x",
            "--sigma1", "24", "--sigma2", "24", "--wavelet", "db3",
            "--search-radius", "6", "--stitch-mip", "--skip-inspection"]
    _run(["ipp_tpu.pipeline.warmup", "stitch"] + args, cache)
    primed = _cache_entries(cache)
    _run(["ipp_tpu.pipeline.process_images"] + args, cache)
    leaked = _cache_entries(cache) - primed
    assert not leaked, (
        f"stitch-mip leaked {len(leaked)}: {sorted(leaked)[:8]}")


@pytest.mark.slow
def test_warmup_decon_inventory_completeness(tmp_path):
    from ipp_tpu.io import tiff as tio

    rng = np.random.default_rng(0)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for z in range(10):
        tio.imwrite(in_dir / f"img_{z:06d}.tif",
                    (rng.random((64, 64)) * 1000).astype(np.uint16))
    cache = tmp_path / "xla_cache"
    cache.mkdir()
    args = ["--input", str(in_dir), "--output", str(tmp_path / "dec"),
            "--niter", "4", "--max-block-mvox", "0.25",
            "--no-strict-accuracy"]

    _run(["ipp_tpu.pipeline.warmup", "decon"] + args, cache)
    primed = _cache_entries(cache)
    assert primed

    _run(["ipp_tpu.pipeline.deconvolve"] + args, cache)
    leaked = _cache_entries(cache) - primed
    assert not leaked, (
        f"{len(leaked)} executables compiled in-run that warmup missed — "
        f"extend decon_programs() (cache keys: {sorted(leaked)[:8]})")

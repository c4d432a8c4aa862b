"""Kill/resume fault injection through the full CLIs (VERDICT r4 item 1,
CI-scale): SIGKILL a run mid-stage, resume it, and require the final
outputs to EQUAL an uninterrupted run's.  The multi-gigavoxel endurance
variant of the same drive lives in scripts/endurance.py; this test pins
the crash-consistency semantics (atomic tmp->rename commits + resume
skip) at a size the suite can afford.

Reference semantics under test: pystripe --resume skip
(pystripe/core.py:1511), LsDeconv brick claim/resume
(LsDeconv.m:697-814).
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from ipp_tpu.io import tiff as tio
from tests.synth import cut_tiles, make_phantom, write_tile_grid

REPO = Path(__file__).resolve().parent.parent
CH = "Ex_488_Em_525"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    env["JAX_PLATFORMS"] = "cpu"
    env["IPP_TPU_PROGRESS"] = "off"
    return env


def _launch(mod, args):
    return subprocess.Popen([sys.executable, "-m", mod] + args,
                            env=_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _run(mod, args, timeout=600):
    r = subprocess.run([sys.executable, "-m", mod] + args, env=_env(),
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])


def _kill_when(proc, predicate, timeout=300):
    """SIGKILL `proc` as soon as predicate() is true; fail if the process
    finishes first (the kill must land mid-run to test anything)."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if predicate():
            proc.send_signal(signal.SIGKILL)
            proc.wait(30)
            return
        if proc.poll() is not None:
            pytest.fail("run finished before the kill window opened")
        time.sleep(0.05)
    proc.kill()
    pytest.fail("kill predicate never fired")


def _series_equal(dir_a: Path, dir_b: Path):
    pa = sorted(p.name for p in dir_a.glob("img_*.tif"))
    pb = sorted(p.name for p in dir_b.glob("img_*.tif"))
    assert pa and pa == pb, (pa[:3], pb[:3])
    for name in pa:
        np.testing.assert_array_equal(
            np.asarray(tio.imread(dir_a / name)),
            np.asarray(tio.imread(dir_b / name)), err_msg=name)


@pytest.mark.slow
def test_process_images_kill_resume_equals_clean(tmp_path):
    rng = np.random.default_rng(11)
    vol = make_phantom(rng, (12, 260, 260), smooth=6.0)
    stripes = 1.0 + 0.3 * np.sin(np.arange(vol.shape[2]) / 2.5)[None, None, :]
    tiles, _ = cut_tiles((vol * stripes * 400).astype(np.uint16),
                         2, 2, (160, 160), 50, jitter=1,
                         rng=np.random.default_rng(12))
    for d in ("clean", "crash"):
        ch = tmp_path / d / "raw" / CH
        ch.mkdir(parents=True)
        write_tile_grid(ch, tiles, overlap_nominal_px=50,
                        voxel_um=(0.41, 0.41, 0.2))

    def args(d):
        b = tmp_path / d
        return ["--input", str(b / "raw"),
                "--preprocessed", str(b / "pre"),
                "--stitched", str(b / "st"), "--objective", "15x",
                "--sigma1", "16", "--sigma2", "16", "--wavelet", "db3",
                "--search-radius", "5", "--subvol-dim", "6",
                "--downsampled-voxel", "4.0", "--skip-inspection"]

    _run("ipp_tpu.pipeline.process_images", args("clean"))

    # crash run: SIGKILL once a few preprocessed tiles are committed
    pre = tmp_path / "crash" / "pre" / CH
    proc = _launch("ipp_tpu.pipeline.process_images", args("crash"))
    _kill_when(proc, lambda: len(list(pre.glob("*/*/*.tif"))) >= 4)
    assert proc.returncode != 0
    # resume and finish
    _run("ipp_tpu.pipeline.process_images", args("crash") + ["--resume"])

    _series_equal(tmp_path / "clean" / "st" / CH,
                  tmp_path / "crash" / "st" / CH)
    a = np.load(tmp_path / "clean" / "st" / f"{CH}_zyx4.0um.npz",
                allow_pickle=True)
    b = np.load(tmp_path / "crash" / "st" / f"{CH}_zyx4.0um.npz",
                allow_pickle=True)
    np.testing.assert_allclose(a["I"], b["I"], rtol=1e-6, atol=1e-4)


@pytest.mark.slow
def test_deconvolve_kill_resume_equals_clean(tmp_path):
    from ipp_tpu.ops.psf import gaussian_psf
    from scipy.ndimage import convolve as ndi_convolve

    rng = np.random.default_rng(5)
    truth = np.zeros((16, 192, 192), np.float32)
    truth[rng.integers(2, 14, 60), rng.integers(8, 184, 60),
          rng.integers(8, 184, 60)] = 4000.0
    psf = gaussian_psf((5, 5, 5), (1.1, 1.3, 1.3))
    blurred = np.clip(ndi_convolve(truth, psf, mode="constant"), 0, 65535)
    for d in ("clean", "crash"):
        in_dir = tmp_path / d / "in"
        in_dir.mkdir(parents=True)
        for z in range(truth.shape[0]):
            tio.imwrite(in_dir / f"img_{z:06d}.tif",
                        blurred[z].astype(np.uint16))

    def args(d):
        b = tmp_path / d
        return ["--input", str(b / "in"), "--output", str(b / "dec"),
                "--niter", "5", "--max-block-mvox", "0.25",
                "--no-strict-accuracy"]

    _run("ipp_tpu.pipeline.deconvolve", args("clean"))
    bricks_clean = len(list(
        (tmp_path / "clean" / "dec" / "bricks").glob("block_*.npy")))
    assert bricks_clean >= 3, "fixture too small to interrupt meaningfully"

    bricks = tmp_path / "crash" / "dec" / "bricks"
    proc = _launch("ipp_tpu.pipeline.deconvolve", args("crash"))
    _kill_when(proc, lambda: len(list(bricks.glob("block_*.npy"))) >= 1)
    assert proc.returncode != 0
    _run("ipp_tpu.pipeline.deconvolve", args("crash") + ["--resume"])

    _series_equal(tmp_path / "clean" / "dec", tmp_path / "crash" / "dec")

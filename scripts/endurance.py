"""Multi-gigavoxel endurance drive with kill/resume fault injection
(VERDICT r4 item 1).

Synthesizes a multi-Gvox SmartSPIM-style dataset (N channels x RxC grid
of 1024^2 x Z u16 tiles with consistent overlaps, streamed z-plane by
z-plane so synthesis RAM stays at one plane), then drives the FULL
process_images + deconvolve CLIs through it twice:

  clean  — uninterrupted, per-stage walls + peak RSS recorded
  crash  — SIGKILLed once mid-preprocess and once mid-decon, resumed
           with --resume; final outputs must EQUAL the clean run's

The RAM admission gate runs under a constrained budget
(IPP_TPU_RAM_BUDGET_GB) so it actually binds.  Results append to
docs/ENDURANCE.md and land in <root>/endurance_report.json.

usage:
  python scripts/endurance.py --root /tmp/endurance --gvox 2.5 \
      [--channels 2] [--platform gpu|cpu]

The parent never imports JAX: each CLI runs in its own subprocess, which
then has the card to itself.

Reference operating regime being rehearsed: 10^4-10^5 tiles, 835.7-Gvox
decon (LsDeconvolveMultiGPU/README.md:58), resume semantics
(LsDeconv.m:697-814, pystripe/core.py:1511).
"""

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CHANNELS = ("Ex_488_Em_525", "Ex_561_Em_600")
TILE = 1024
OVERLAP = 150  # px; step 874 -> non-trivial blend regions


def synthesize(root: Path, rows: int, cols: int, nz: int, n_channels: int,
               seed: int = 7) -> None:
    """Stream a consistent-overlap tile grid to disk, one z plane at a
    time (synthesis RAM = one full-plane slab)."""
    from scipy.ndimage import gaussian_filter

    from ipp_tpu.io import tiff as tio

    step = TILE - OVERLAP
    H = W = step * (max(rows, cols) - 1) + TILE
    rng = np.random.default_rng(seed)
    for ci in range(n_channels):
        ch = CHANNELS[ci]
        dirs = {}
        for r in range(rows):
            for c in range(cols):
                x_tenths = int(c * step * 10 * 0.41)
                y_tenths = int(r * step * 10 * 0.41)
                d = (root / ch / f"{x_tenths:06d}"
                     / f"{x_tenths:06d}_{y_tenths:06d}")
                d.mkdir(parents=True, exist_ok=True)
                dirs[(r, c)] = d
        # AR(1)-correlated smooth planes: structure persists across z so
        # NCC has signal in every subvolume
        state = gaussian_filter(rng.standard_normal((H, W)), 24.0)
        t0 = time.time()
        for z in range(nz):
            state = 0.9 * state + 0.45 * gaussian_filter(
                rng.standard_normal((H, W)).astype(np.float32), 24.0)
            plane = state - state.min()
            plane = plane / max(plane.max(), 1e-6)
            stripes = 1.0 + 0.2 * np.sin(np.arange(W) / 2.7)[None, :]
            img = np.clip(plane * 12000.0 * stripes + 80.0, 0,
                          65535).astype(np.uint16)
            for (r, c), d in dirs.items():
                y0, x0 = r * step, c * step
                tio.imwrite(d / f"{z:06d}.tif",
                            img[y0:y0 + TILE, x0:x0 + TILE])
            if z % 8 == 0:
                print(f"  {ch}: plane {z}/{nz} "
                      f"({(z + 1) / max(time.time() - t0, 1e-9):.1f} pl/s)",
                      flush=True)


class RssWatch:
    """Peak VmRSS of a child (plus its direct children) by polling."""

    def __init__(self, pid: int):
        self.pid = pid
        self.peak = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _pids(self):
        yield self.pid
        try:
            for t in Path(f"/proc/{self.pid}/task").iterdir():
                for child in (t / "children").read_text().split():
                    yield int(child)
        except OSError:
            return

    def _run(self):
        while not self._stop.is_set():
            total = 0
            for pid in self._pids():
                try:
                    with open(f"/proc/{pid}/status") as f:
                        for line in f:
                            if line.startswith("VmRSS:"):
                                total += int(line.split()[1]) * 1024
                                break
                except OSError:
                    pass
            self.peak = max(self.peak, total)
            time.sleep(0.5)

    def stop(self) -> int:
        self._stop.set()
        self._t.join(2)
        return self.peak


def run_cli(mod, args, env, kill_when=None, timeout=3 * 3600):
    """Run a CLI; with kill_when, SIGKILL once the predicate fires and
    report rc.  Returns (rc, wall_s, peak_rss, tail)."""
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-m", mod] + args, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watch = RssWatch(proc.pid)
    tail = []

    def pump():
        for line in proc.stdout:
            tail.append(line)
            del tail[:-400]

    pt = threading.Thread(target=pump, daemon=True)
    pt.start()
    if kill_when is not None:
        while proc.poll() is None:
            if kill_when():
                proc.send_signal(signal.SIGKILL)
                break
            if time.time() - t0 > timeout:
                proc.kill()
                raise TimeoutError(mod)
            time.sleep(0.2)
    proc.wait(timeout)
    pt.join(5)
    return proc.returncode, time.time() - t0, watch.stop(), "".join(tail)


def series_hash(d: Path, pattern="img_*.tif") -> str:
    from ipp_tpu.io import tiff as tio

    h = hashlib.sha256()
    names = sorted(p.name for p in d.glob(pattern))
    assert names, f"no series in {d}"
    for n in names:
        arr = np.asarray(tio.imread(d / n))
        h.update(n.encode())
        h.update(arr.tobytes())
    return f"{len(names)}:{h.hexdigest()[:16]}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--gvox", type=float, default=2.5,
                    help="total voxels across channels (1e9)")
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="JAX_PLATFORMS for the CLI subprocesses")
    ap.add_argument("--ram-budget-gb", type=float, default=24.0)
    ap.add_argument("--skip-synth", action="store_true")
    ap.add_argument("--grid", type=int, default=4, help="grid rows=cols")
    ap.add_argument("--decon-args", default="",
                    help="extra args appended to the deconvolve CLI "
                         "(e.g. '--no-strict-accuracy' for smoke scales)")
    ap.add_argument("--mode", choices=["both", "clean"], default="both",
                    help="'clean' skips the crash/resume legs (throughput "
                         "only)")
    args = ap.parse_args()

    rows = cols = args.grid
    per_tile = TILE * TILE
    nz = int(round(args.gvox * 1e9 / (args.channels * rows * cols
                                      * per_tile)))
    nz = max(16, nz)
    total = args.channels * rows * cols * per_tile * nz
    print(f"dataset: {args.channels} ch x {rows}x{cols} x {TILE}^2 x "
          f"{nz}z = {total / 1e9:.2f} Gvox "
          f"({total * 2 / 2**30:.1f} GiB u16)", flush=True)

    raw = args.root / "raw"
    if not args.skip_synth:
        synthesize(raw, rows, cols, nz, args.channels)

    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    env["JAX_PLATFORMS"] = args.platform
    env["IPP_TPU_PROGRESS"] = "log"
    env["IPP_TPU_RAM_BUDGET_GB"] = str(args.ram_budget_gb)

    def pi_args(tag, resume=False):
        b = args.root / tag
        a = ["--input", str(raw), "--preprocessed", str(b / "pre"),
             "--stitched", str(b / "st"), "--objective", "15x",
             "--sigma1", "250", "--sigma2", "250", "--wavelet", "db9",
             "--search-radius", "20", "--subvol-dim", str(min(64, nz)),
             "--downsampled-voxel", "10.0", "--skip-inspection"]
        return a + (["--resume"] if resume else [])

    def dec_args(tag, resume=False):
        b = args.root / tag
        a = ["--input", str(b / "st" / CHANNELS[0]),
             "--output", str(b / "dec"), "--niter", "6"]
        a += args.decon_args.split()
        return a + (["--resume"] if resume else [])

    report = {"total_gvox": total / 1e9, "platform": args.platform,
              "grid": f"{rows}x{cols}x{nz}z x{args.channels}ch",
              "ram_budget_gb": args.ram_budget_gb}

    # ---- clean run -----------------------------------------------------
    print("== clean process_images ==", flush=True)
    rc, wall, rss, tail = run_cli("ipp_tpu.pipeline.process_images",
                                  pi_args("clean"), env)
    assert rc == 0, tail[-3000:]
    report["clean_stitch_s"] = round(wall, 1)
    report["clean_stitch_peak_rss_gb"] = round(rss / 2**30, 2)
    report["clean_stitch_mvox_s"] = round(total / wall / 1e6, 2)
    print(tail[-1500:], flush=True)
    print("== clean deconvolve ==", flush=True)
    rc, wall, rss, tail = run_cli("ipp_tpu.pipeline.deconvolve",
                                  dec_args("clean"), env)
    assert rc == 0, tail[-3000:]
    ch_vox = rows * cols * per_tile * nz  # approx (overlaps merge)
    report["clean_decon_s"] = round(wall, 1)
    report["clean_decon_peak_rss_gb"] = round(rss / 2**30, 2)
    report["clean_decon_mvox_s"] = round(ch_vox / wall / 1e6, 2)
    print(tail[-1500:], flush=True)

    if args.mode == "clean":
        for ch in CHANNELS[:args.channels]:
            report[f"stitch_hash_{ch}"] = series_hash(
                args.root / "clean" / "st" / ch)
        report["decon_hash"] = series_hash(args.root / "clean" / "dec")
        out = args.root / "endurance_report.json"
        out.write_text(json.dumps(report, indent=2))
        print(json.dumps(report, indent=2))
        print(f"report -> {out}")
        return 0

    # ---- crash run -----------------------------------------------------
    pre = args.root / "crash" / "pre" / CHANNELS[0]
    print("== crash process_images (SIGKILL mid-preprocess) ==",
          flush=True)
    rc, wall1, _, _ = run_cli(
        "ipp_tpu.pipeline.process_images", pi_args("crash"), env,
        kill_when=lambda: len(list(pre.glob("*/*/*.tif"))) >= rows * cols
        * max(4, nz // 4))
    assert rc != 0, "kill did not land"
    rc, wall2, rss, tail = run_cli("ipp_tpu.pipeline.process_images",
                                   pi_args("crash", resume=True), env)
    assert rc == 0, tail[-3000:]
    report["crash_stitch_s"] = round(wall1 + wall2, 1)
    bricks = args.root / "crash" / "dec" / "bricks"
    print("== crash deconvolve (SIGKILL mid-decon) ==", flush=True)
    rc, wall1, _, _ = run_cli(
        "ipp_tpu.pipeline.deconvolve", dec_args("crash"), env,
        kill_when=lambda: len(list(bricks.glob("block_*.npy"))) >= 2)
    assert rc != 0, "kill did not land"
    rc, wall2, _, tail = run_cli("ipp_tpu.pipeline.deconvolve",
                                 dec_args("crash", resume=True), env)
    assert rc == 0, tail[-3000:]
    report["crash_decon_s"] = round(wall1 + wall2, 1)

    # ---- equality ------------------------------------------------------
    for ch in CHANNELS[:args.channels]:
        ha = series_hash(args.root / "clean" / "st" / ch)
        hb = series_hash(args.root / "crash" / "st" / ch)
        report[f"stitch_hash_{ch}"] = ha
        assert ha == hb, (ch, ha, hb)
    ha = series_hash(args.root / "clean" / "dec")
    hb = series_hash(args.root / "crash" / "dec")
    report["decon_hash"] = ha
    assert ha == hb, (ha, hb)
    report["outputs_equal"] = True

    out = args.root / "endurance_report.json"
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    print(f"report -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

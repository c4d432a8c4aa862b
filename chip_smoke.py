#!/usr/bin/env python3
"""Drive the system's main path once on a GPU and check every result.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # the multi-card paths on four GPUs

One GPU: the kernels at production widths, each against a float64
numpy/scipy reference (destripe of 2000x2000 SmartSPIM tiles, 6-iteration
Richardson-Lucy, NCC maps of the (12, 150, 1024) MIP class, the lightsheet
correction of a 2048^2 plane); the stitching CLI on a seeded 3x3 grid of
2000x2000x32 tiles; the deconvolution CLI on a seeded 256x2048x2048
series; and the per-block decon chain at the block the planner picks for
the LsDeconv benchmark volume.  Four GPUs: the mesh paths (deconvolution
blocks, stitch steps 2 and 6, z-sharded RL), each against a one-device
run of the same input in the same process.

Each phase prints its wall and compile times, peak device memory and
every comparison with its tolerance.  The last line of standard output is
one JSON object, printed only when every phase passed; the exit status is
non-zero when a phase failed or JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# the LsDeconv benchmark volume (LsDeconvolveMultiGPU/README.md:58-61)
REFERENCE_VOLUME = (7912, 12778, 8266)
# the reference's optics defaults (deconvolve CLI), PSF in (z, y, x)
OPTICS = dict(dxy=406.0, dz=800.0, NA=0.4, n=1.45, lambda_ex=488.0,
              lambda_em=525.0, fcyl=80000.0, slitwidth=12000.0)


class PhaseFailed(AssertionError):
    pass


class Phase:
    """Collects one phase's printed measurements and checks."""

    def __init__(self, name: str):
        self.name = name
        self.failed = []

    def say(self, msg: str) -> None:
        print(f"[{self.name}] {msg}", flush=True)

    def check(self, what: str, value: float, limit: float, why: str,
              higher_is_better: bool = False) -> None:
        ok = value >= limit if higher_is_better else value <= limit
        rel = ">=" if higher_is_better else "<="
        self.say(f"CHECK {what} = {value:.6g} {rel} {limit:g} ({why}): "
                 f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(what)

    def require(self, what: str, ok: bool) -> None:
        self.say(f"CHECK {what}: {'PASS' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(what)

    def done(self) -> None:
        if self.failed:
            raise PhaseFailed(f"{self.name}: {', '.join(self.failed)}")


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

_COMPILE_SECS = [0.0]


def _count_compiles() -> None:
    import jax

    def listener(event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            _COMPILE_SECS[0] += secs

    jax.monitoring.register_event_duration_secs_listener(listener)


def peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def fmt_bytes(n) -> str:
    return "n/a" if n is None else f"{n / 2 ** 30:.2f} GiB"


def compile_and_time(ph: Phase, label: str, fn, *args, reps: int = 3):
    """jit + lower + compile `fn` (compile time kept apart), print the
    compiled program's memory, then time steady-state calls with
    block_until_ready.  Returns the output of the last call."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = "n/a" if ma is None else (
        f"args {fmt_bytes(ma.argument_size_in_bytes)}, out "
        f"{fmt_bytes(ma.output_size_in_bytes)}, temp "
        f"{fmt_bytes(ma.temp_size_in_bytes)}")
    out = jax.block_until_ready(compiled(*args))  # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        best = min(best, time.perf_counter() - t0)
    ph.say(f"{label}: compile {t_compile:.2f} s, steady {best * 1e3:.2f} ms "
           f"(best of {reps}), memory_analysis: {mem}, peak_bytes_in_use "
           f"{fmt_bytes(peak_bytes())}")
    return out, best


def nrmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def reference_psf() -> np.ndarray:
    from ipp_tpu.ops.psf import make_psf

    psf_xyz, _, _ = make_psf(**OPTICS)
    return np.transpose(psf_xyz, (2, 1, 0)).astype(np.float32)


# ---------------------------------------------------------------------------
# float64 references
# ---------------------------------------------------------------------------


def _circ_filter(x: np.ndarray, h: np.ndarray, correlate: bool) -> np.ndarray:
    """Circular correlation (sum_k h[k] x[i+k]) or convolution
    (sum_k h[k] x[i-k]) along the last axis, float64 via the FFT."""
    n = x.shape[-1]
    hp = np.zeros(n)
    np.add.at(hp, np.arange(len(h)) % n, h)
    H = np.fft.rfft(hp)
    return np.fft.irfft(np.fft.rfft(x) * (np.conj(H) if correlate else H), n)


def _ref_dwt(x, lo, hi):
    return (_circ_filter(x, lo, True)[..., ::2],
            _circ_filter(x, hi, True)[..., ::2])


def _ref_idwt(ca, cd, lo, hi):
    up = np.zeros(ca.shape[:-1] + (2 * ca.shape[-1],))
    ya = up.copy()
    ya[..., ::2] = ca
    up[..., ::2] = cd
    return _circ_filter(ya, lo, False) + _circ_filter(up, hi, False)


def ref_filter_streaks(img: np.ndarray, sigma: float, wavelet: str):
    """float64 destripe of one tile with the semantics of
    ops.destripe.filter_streaks(sigma=(s, s)) at its defaults: log1p,
    wrap pad, periodized wavedec2, sigma/2 complex-bin notch of every cH
    along x, waverec2, expm1, round and clip."""
    from ipp_tpu.ops import wavelets as wv
    from ipp_tpu.ops.destripe import _plan_padding

    _, _, lo, hi = wv.filter_bank(wavelet)
    bp, (py, px), _, level = _plan_padding(img.shape, (sigma, sigma), 0,
                                           wavelet)
    x = np.pad(np.log1p(img.astype(np.float64)),
               ((bp, bp + py), (bp, bp + px)), mode="wrap")
    H = x.shape[0]
    rolls = wv._parity_rolls(len(lo), level)
    details = []
    a = x
    for lv in range(level):
        if rolls[lv]:
            a = np.roll(a, 1, axis=(0, 1))
        a1, d1 = _ref_dwt(a, lo, hi)                  # along x
        aa, da = (t.T for t in _ref_dwt(a1.T, lo, hi))  # along y
        ad, dd = (t.T for t in _ref_dwt(d1.T, lo, hi))
        n = da.shape[-1]
        s = da.shape[-2] * (sigma / H) * 0.5
        g = 1.0 - np.exp(-np.arange(n // 2 + 1) ** 2 / (2.0 * s * s))
        da = np.fft.irfft(np.fft.rfft(da) * g, n)
        details.append((da, ad, dd))
        a = aa
    for lv in reversed(range(level)):
        da, ad, dd = details[lv]
        a1 = _ref_idwt(a.T, da.T, lo, hi).T
        d1 = _ref_idwt(ad.T, dd.T, lo, hi).T
        a = _ref_idwt(a1, d1, lo, hi)
        if rolls[lv]:
            a = np.roll(a, -1, axis=(0, 1))
    a = a[bp:bp + img.shape[0], bp:bp + img.shape[1]]
    return np.clip(np.rint(np.expm1(a)), 0, 65535)


def ref_richardson_lucy(vol, psf, niter: int, fft_shape):
    """float64 scipy.fft twin of ops.deconv.richardson_lucy (classic RL,
    full-volume edge taper, centered zero pad, OTF rolled to the PSF
    center, ratio floor at float32 eps)."""
    import scipy.fft as sfft

    from ipp_tpu.ops.deconv import make_taper

    vol = np.asarray(vol, np.float64)
    psf = np.asarray(psf, np.float64)
    psf = psf / psf.sum()
    # edge taper: mask*vol + (1-mask)*blur, blur = 'same' conv, replicate
    halves = [k // 2 for k in psf.shape]
    vp = np.pad(vol, [(h, h) for h in halves], mode="edge")
    lin = [s + k - 1 for s, k in zip(vp.shape, psf.shape)]
    full = sfft.irfftn(sfft.rfftn(vp, lin, workers=-1)
                       * sfft.rfftn(psf, lin, workers=-1), lin, workers=-1)
    blur = full[tuple(slice(2 * h, 2 * h + n)
                      for h, n in zip(halves, vol.shape))]
    mask = np.ones((), np.float64)
    for d in range(3):
        tw = min(max(8, int(round(psf.shape[d] / 2))), vol.shape[d] // 2)
        shape = [1, 1, 1]
        shape[d] = vol.shape[d]
        mask = mask * make_taper(vol.shape[d], tw).astype(np.float64
                                                          ).reshape(shape)
    vol = mask * vol + (1.0 - mask) * blur
    pre = [(t - s) // 2 for t, s in zip(fft_shape, vol.shape)]
    y = np.pad(vol, [(p, t - s - p) for p, t, s in
                     zip(pre, fft_shape, vol.shape)])
    kp = [(t - s) // 2 for t, s in zip(fft_shape, psf.shape)]
    otf_pad = np.pad(psf, [(p, t - s - p) for p, t, s in
                           zip(kp, fft_shape, psf.shape)])
    center = [p + s // 2 for p, s in zip(kp, psf.shape)]
    otf = sfft.rfftn(np.roll(otf_pad, [-c for c in center], axis=(0, 1, 2)),
                     workers=-1)
    eps = float(np.finfo(np.float32).eps)
    bl = y
    for _ in range(niter):
        buf = sfft.irfftn(sfft.rfftn(bl, workers=-1) * otf, fft_shape,
                          workers=-1)
        ratio = y / np.maximum(buf, eps)
        bl = np.abs(bl * sfft.irfftn(sfft.rfftn(ratio, workers=-1)
                                     * np.conj(otf), fft_shape, workers=-1))
    return bl[tuple(slice(p, p + s) for p, s in zip(pre, vol.shape))]


def ref_ncc(m1, m2, du: int, dv: int) -> np.ndarray:
    """Direct float64 port of the reference compute_NCC (TeraStitcher
    compute_funcs.cu): per shift, overlap windows with their means
    removed; batched over the leading axis."""
    B, U, V = m1.shape
    out = np.zeros((B, 2 * du + 1, 2 * dv + 1))
    m1 = m1.astype(np.float64)
    m2 = m2.astype(np.float64)
    for u in range(-du, du + 1):
        for v in range(-dv, dv + 1):
            a = m1[:, max(0, u):U + min(0, u), max(0, v):V + min(0, v)]
            b = m2[:, max(0, -u):U + min(0, -u), max(0, -v):V + min(0, -v)]
            a = a - a.mean(axis=(1, 2), keepdims=True)
            b = b - b.mean(axis=(1, 2), keepdims=True)
            den = np.sqrt((a * a).sum(axis=(1, 2)) * (b * b).sum(axis=(1, 2)))
            out[:, du + u, dv + v] = np.where(
                den > 0, (a * b).sum(axis=(1, 2)) / np.maximum(den, 1e-300),
                0.0)
    return out


def _ref_grid_percentile(img, selem, spacing, step, q):
    """Percentile of each subsampled window on the coarse grid, then
    scipy.ndimage.zoom(order=1) back to full size (the windows of
    ops.lightsheet.grid_percentile: edge-padded, centered on the grid).

    Also returns the largest deviation the device form allows by design:
    for windows of >= 1024 samples it returns the upper of the two order
    statistics around the quantile, found by 11 bisection passes, so it
    may sit (1 - f) of their gap plus range/2^11 above np.quantile; the
    K-ary search of smaller windows resolves range/2^20."""
    from scipy.ndimage import zoom

    h, w = img.shape
    (sh, sw), (gy, gx), (ty, tx) = selem, spacing, step
    n_cy, n_cx = h // gy, w // gx
    cy = (h - (n_cy - 1) * gy) // 2 + np.arange(n_cy) * gy
    cx = (w - (n_cx - 1) * gx) // 2 + np.arange(n_cx) * gx
    xp = np.pad(img.astype(np.float64),
                ((sh // 2, sh - sh // 2), (sw // 2, sw - sw // 2)),
                mode="edge")
    ry = np.arange(0, sh, ty)
    rx = np.arange(0, sw, tx)
    k = len(ry) * len(rx)
    pos = q * (k - 1)
    r0, f = int(np.floor(pos)), pos - np.floor(pos)
    vals = np.empty((n_cy, n_cx))
    allowed = 0.0
    for i, c in enumerate(cy):
        rows = xp[c + ry]                          # (ky, Wp)
        win = rows[:, cx[:, None] + rx[None, :]]   # (ky, n_cx, kx)
        win = win.transpose(1, 0, 2).reshape(n_cx, -1)
        vals[i] = np.quantile(win, q, axis=1)
        span = win.max(axis=1) - win.min(axis=1) + 1.0
        if k >= 1024:
            part = np.partition(win, (r0, min(r0 + 1, k - 1)), axis=1)
            gap = part[:, min(r0 + 1, k - 1)] - part[:, r0]
            allowed = max(allowed, float(np.max(
                (1.0 - f) * gap + span * 1.002 / 2 ** 11)))
        else:
            allowed = max(allowed, float(np.max(span)) / 2 ** 19)
    return (zoom(vals, (h / n_cy, w / n_cx), order=1, mode="nearest"),
            allowed)


def ref_correct_lightsheet(img, percentile=0.25, artifact_length=150,
                           window=200, spacing=(25, 25), step=(2, 2),
                           ls_vs_bg=2.0):
    """float64 twin of ops.lightsheet.correct_lightsheet at its defaults;
    returns (output, the largest output deviation the device's percentile
    searches allow by design, plus one count of rounding)."""
    ls, ls_tol = _ref_grid_percentile(img, (1, artifact_length),
                                      (1, artifact_length), (1, 1),
                                      percentile)
    bg, bg_tol = _ref_grid_percentile(img, (window, window), spacing, step,
                                      percentile)
    x = img.astype(np.float64)
    out = x - np.minimum(x, np.minimum(ls, bg * ls_vs_bg))
    return (np.clip(np.rint(out), 0, 65535),
            max(ls_tol, bg_tol * ls_vs_bg) + 1.0)


# ---------------------------------------------------------------------------
# synthetic inputs
# ---------------------------------------------------------------------------


def striped_tiles(rng, shape):
    """u16 tiles: smooth texture, horizontal stripes, shot-like noise."""
    b, h, w = shape
    base = rng.random((b, h // 16 + 1, w // 16 + 1)) * 3000 + 500
    tiles = np.repeat(np.repeat(base, 16, axis=1), 16, axis=2)[:, :h, :w]
    tiles = tiles * (1.0 + 0.3 * (rng.random((b, h, 1)) > 0.97))
    tiles += rng.normal(0, 30, (b, h, w))
    return np.clip(tiles, 0, 65535).astype(np.uint16)


def smooth_field(rng, shape, factor: int, peak: float = 40000.0):
    """Smooth positive u16 3D texture: a gaussian-filtered random field on
    a grid `factor` times coarser in y and x, linearly upsampled by two
    matmuls per plane."""
    from scipy.ndimage import gaussian_filter

    from ipp_tpu.ops.lightsheet import _resize_linear_weights

    d, h, w = shape
    lo = gaussian_filter(rng.standard_normal(
        (d, h // factor + 2, w // factor + 2)).astype(np.float32),
        (1.0, 1.0, 1.0))
    lo -= lo.min()
    lo *= peak / lo.max()
    ay = _resize_linear_weights(lo.shape[1], h)
    ax = _resize_linear_weights(lo.shape[2], w).T.copy()
    out = np.empty(shape, np.uint16)
    for z in range(d):
        out[z] = np.clip(ay @ lo[z] @ ax, 0, 65535)
    return out


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_destripe(shape=(16, 2000, 2000), n_ref: int = 2, seed: int = 0):
    """filter_streaks on a batch of SmartSPIM-preset tiles, sigma 250, db9,
    against the float64 reference on `n_ref` tiles of the batch."""
    import jax.numpy as jnp

    from ipp_tpu.ops.destripe import filter_streaks

    ph = Phase("destripe")
    tiles = striped_tiles(np.random.default_rng(seed), shape)
    out, t = compile_and_time(
        ph, f"filter_streaks {shape} u16 sigma (250, 250) db9",
        lambda x: filter_streaks(x, sigma=(250, 250), wavelet="db9"),
        jnp.asarray(tiles))
    ph.say(f"rate {shape[0] / t:.1f} tiles/s")
    out = np.asarray(out)
    ph.require(f"shape {out.shape} dtype {out.dtype}",
               out.shape == shape and out.dtype == np.uint16)
    worst = 0
    for i in range(n_ref):
        ref = ref_filter_streaks(tiles[i], 250.0, "db9")
        worst = max(worst, int(np.abs(out[i].astype(np.int64) - ref).max()))
    ph.check(f"max |out - float64 reference| over {n_ref} tiles (u16 counts)",
             worst, 1, "float32 DWT/notch vs float64 may flip the final "
             "rounding by one count")
    ph.done()


def phase_rl(shapes=((256, 256, 256), (512, 512, 256)), niter: int = 6,
             seed: int = 1):
    """richardson_lucy, 6 iterations (the LsDeconv benchmark count),
    against the float64 scipy.fft twin."""
    import jax.numpy as jnp

    from ipp_tpu.ops.deconv import fft_shape_for, richardson_lucy

    ph = Phase("rl")
    psf = reference_psf()
    rng = np.random.default_rng(seed)
    for shape in shapes:
        vol = (rng.random(shape, dtype=np.float32) * 1000 + 100)
        fs = fft_shape_for(shape, psf.shape)
        out, t = compile_and_time(
            ph, f"richardson_lucy {shape} niter {niter} fft {fs}",
            lambda v, p: richardson_lucy(v, p, niter=niter, fft_shape=fs),
            jnp.asarray(vol), jnp.asarray(psf))
        ph.say(f"rate {np.prod(shape) / t / 1e6:.1f} Mvox/s")
        t0 = time.perf_counter()
        ref = ref_richardson_lucy(vol, psf, niter, fs)
        ph.say(f"float64 reference in {time.perf_counter() - t0:.1f} s")
        ph.check(f"RL {shape} NRMSE vs float64", nrmse(out, ref), 1e-4,
                 "float32 FFTs over 6 iterations")
    ph.done()


def phase_ncc(shape=(12, 150, 1024), radius: int = 12, seed: int = 2):
    """ncc_maps_batched on MIP pairs of the (12, 150, 1024) class against
    the float64 compute_NCC port: same argmax, max |delta| <= 1e-4."""
    import jax.numpy as jnp

    from ipp_tpu.ops.ncc import ncc_maps_batched

    ph = Phase("ncc")
    rng = np.random.default_rng(seed)
    m1 = rng.random(shape, dtype=np.float32) * 100
    shift = (min(4, radius), -min(6, radius))
    m2 = (np.roll(m1, shift, axis=(1, 2))
          + rng.random(shape, dtype=np.float32) * 20).astype(np.float32)
    out, _ = compile_and_time(
        ph, f"ncc_maps_batched {shape} radius {radius}",
        lambda a, b: ncc_maps_batched(a, b, radius, radius),
        jnp.asarray(m1), jnp.asarray(m2))
    out = np.asarray(out, np.float64)
    ref = ref_ncc(m1, m2, radius, radius)
    ph.check("NCC max |delta| vs float64", float(np.abs(out - ref).max()),
             1e-4, "float32 FFT correlation and integral images")
    am = out.reshape(shape[0], -1).argmax(1)
    ar = ref.reshape(shape[0], -1).argmax(1)
    ph.require(f"argmax equal in all {shape[0]} pairs", bool((am == ar).all()))
    ph.done()


def phase_lightsheet(shape=(2048, 2048), seed: int = 3):
    """correct_lightsheet on one u16 plane against the float64 twin."""
    import jax.numpy as jnp

    from ipp_tpu.ops.lightsheet import correct_lightsheet

    ph = Phase("lightsheet")
    rng = np.random.default_rng(seed)
    img = striped_tiles(rng, (1,) + tuple(shape))[0]
    out, _ = compile_and_time(ph, f"correct_lightsheet {shape} u16",
                              correct_lightsheet, jnp.asarray(img))
    ref, bound = ref_correct_lightsheet(img)
    ph.check("max |out - float64 reference| (u16 counts)",
             int(np.abs(np.asarray(out).astype(np.int64) - ref).max()),
             bound, "the background percentile is the upper order "
             "statistic to range/2^11 by design (x2 through "
             "lightsheet_vs_background), plus rounding")
    ph.done()


def phase_convs(vol_shape=(256, 256, 256), tiles=(16, 2000, 2000),
                seed: int = 10):
    """Every conv_general_dilated call site of the main path (single-
    channel separable and 3x3x3 convolutions, which go to cuDNN on the
    GPU) at production widths against scipy.ndimage in float64."""
    import jax.numpy as jnp
    from scipy import ndimage as ndi

    from ipp_tpu.ops import deconv as dc
    from ipp_tpu.ops.intensity import _gaussian_kernel1d, gaussian_blur2d
    from ipp_tpu.ops.resample import _gauss_blur_axis

    ph = Phase("convs")
    rng = np.random.default_rng(seed)
    vol = rng.random(vol_shape, dtype=np.float32) * 1000
    img = rng.random(tiles, dtype=np.float32) * 1000

    def separable(x, taps, axes, mode):
        x = x.astype(np.float64)
        for ax in axes:
            x = ndi.correlate1d(x, taps.astype(np.float64), axis=ax,
                                mode=mode)
        return x

    g = dc._gauss_kernel(0.5)
    r = dc._tikhonov_kernel()
    k2 = _gaussian_kernel1d(1.0, 2)
    aa = 3.5  # anti-alias sigma of an 8x downsample (resample._aa_sigma)
    ka = np.exp(-0.5 * (np.arange(-14, 15) / aa) ** 2)
    cases = [
        ("gauss3d sigma 0.5 (decon prefilter)", lambda v: dc.gauss3d(v, 0.5),
         vol, lambda: separable(vol, g[::-1], (0, 1, 2), "nearest")),
        ("3x3x3 Tikhonov conv (RL regularization)",
         lambda v: dc._conv3d_zero(v, jnp.asarray(r)), vol,
         lambda: ndi.convolve(vol.astype(np.float64), r, mode="constant")),
        ("gaussian_blur2d sigma 1 r 2 (tile prefilter)",
         lambda x: gaussian_blur2d(x, 1.0, radius=2), img,
         lambda: separable(img, k2, (2, 1), "mirror")),
        ("anti-alias blur sigma 3.5 (downsample)",
         lambda x: _gauss_blur_axis(x, aa, -1), img,
         lambda: separable(img, ka / ka.sum(), (2,), "mirror")),
    ]
    for label, fn, x, ref in cases:
        out, _ = compile_and_time(ph, f"{label} {x.shape}", fn, jnp.asarray(x))
        ph.check(f"{label}: relative max |delta| vs float64",
                 float(np.abs(np.asarray(out) - ref()).max() / 1000.0), 1e-5,
                 "float32 at HIGHEST precision")
    ph.done()


def _stitch_input(root: Path, tile: int, depth: int, grid: int, seed: int):
    """SmartSPIM tree of a grid x grid tile set cut from one phantom with
    ~10% overlap and +-4 px jitter; returns (phantom, true offsets)."""
    from tests.synth import cut_tiles, write_tile_grid

    overlap = tile // 10
    side = grid * tile - (grid - 1) * overlap + 8
    rng = np.random.default_rng(seed)
    vol = smooth_field(rng, (depth, side, side), factor=2)
    tiles, offsets = cut_tiles(vol, grid, grid, (tile, tile), overlap,
                               jitter=4, rng=rng)
    ch = root / "raw" / "Ex_488_Em_525"
    ch.mkdir(parents=True)
    # 15x objective voxel size, so the CLI derives the stage overlap
    grid_ = write_tile_grid(ch, tiles, overlap_nominal_px=overlap,
                            voxel_um=(0.41, 0.41, 0.1))
    dirs = [[s.dir_name for s in row] for row in grid_.stacks]
    return vol, offsets, dirs


def phase_stitch(tile: int = 2000, depth: int = 32, grid: int = 3,
                 sigma: float = 250.0, search: int = 20, seed: int = 4):
    """process_images.main: preprocess (destripe) -> NCC align ->
    placement -> blend-merge (8-bit) -> downsampled NPZ -> TeraFly."""
    from ipp_tpu.geometry.stacks import TileGrid
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.pipeline.process_images import main as process_images

    ph = Phase("stitch")
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        t0 = time.perf_counter()
        vol, offsets, dirs = _stitch_input(td, tile, depth, grid, seed)
        ph.say(f"input {grid}x{grid} tiles of {tile}x{tile}x{depth} u16 "
               f"written in {time.perf_counter() - t0:.1f} s")
        c0 = _COMPILE_SECS[0]
        t0 = time.perf_counter()
        rc = process_images([
            "--input", str(td / "raw"), "--stitched", str(td / "stitched"),
            "--objective", "15x", "--sigma1", str(sigma),
            "--sigma2", str(sigma), "--wavelet", "db9",
            "--search-radius", str(search),
            "--subvol-dim", str(min(depth, 100)),
            "--convert-to-8bit", "--downsampled-voxel", "10.0",
            "--terafly", "--skip-inspection", "--noprogressbar"])
        wall = time.perf_counter() - t0
        ph.say(f"process_images wall {wall:.1f} s, of which XLA compile "
               f"{_COMPILE_SECS[0] - c0:.1f} s; peak_bytes_in_use "
               f"{fmt_bytes(peak_bytes())}")
        ph.require("process_images exit code 0", rc == 0)
        st = td / "stitched"
        g = TileGrid.from_xml(st / "Ex_488_Em_525_placement.xml")
        got = np.array([[(s.abs_h, s.abs_v) for s in row]
                        for row in g.stacks])
        truth = np.array([[o[:2] for o in row] for row in offsets])
        delta = got - truth
        ph.require(f"recovered offsets equal the truth (up to one global "
                   f"shift): {delta.reshape(-1, 2).tolist()}",
                   bool((delta == delta[0, 0]).all()))
        planes = sorted((st / "Ex_488_Em_525").glob("img_*.tif"))
        ph.require(f"{len(planes)} of {depth} stitched planes written",
                   len(planes) == depth)
        npz = list(st.glob("Ex_488_Em_525_zyx*um.npz"))
        ph.require("downsampled NPZ written", len(npz) == 1)
        tf = st / "Ex_488_Em_525_terafly"
        ph.require("TeraFly tree written",
                   tf.exists() and any(tf.iterdir()))
        # the phantom as the stitcher receives it: every tile destriped by
        # the preprocess stage, laid at its true position
        pre = td / "raw_preprocessed" / "Ex_488_Em_525"
        dx, dy = -delta[0, 0]
        worst = 0.0
        for z in (0, depth // 2, depth - 1):
            canvas = np.zeros(vol.shape[1:], np.float64)
            for r in range(grid):
                for c in range(grid):
                    x0, y0, _ = offsets[r][c]
                    canvas[y0:y0 + tile, x0:x0 + tile] = tio.imread(
                        pre / dirs[r][c] / f"{z:06d}.tif")
            m = tio.imread(planes[z]).astype(np.float64)
            hh = min(m.shape[0], canvas.shape[0] - dy)
            ww = min(m.shape[1], canvas.shape[1] - dx)
            m = m[:hh, :ww]
            p = np.floor(canvas[dy:dy + hh, dx:dx + ww] / 256.0)
            raw = vol[z, dy:dy + hh, dx:dx + ww] / 256.0
            mask = (m > 0) & (p > 0)
            err = float(np.abs(m[mask] - p[mask]).mean() / p[mask].mean())
            dev = float(np.abs(m[mask] - raw[mask]).mean() / raw[mask].mean())
            ph.say(f"plane {z}: mean relative error {err:.4f} vs the "
                   f"destriped tiles, {dev:.4f} vs the raw phantom")
            worst = max(worst, err)
        ph.check("stitched planes vs the destriped phantom (8-bit), mean "
                 "relative error", worst, 0.02, "blend of overlaps whose "
                 "tiles were destriped apart, plus 8-bit rounding")
    ph.done()


def _decon_input(in_dir: Path, shape, psf, seed: int, n_beads: int):
    """Seeded bead volume: gaussian beads (the truth) and the same beads
    blurred by the PSF, stamped at random positions on a background;
    the blurred series is written as u16 TIFF planes."""
    from scipy.ndimage import convolve, gaussian_filter

    from ipp_tpu.io import tiff as tio

    rng = np.random.default_rng(seed)
    bead = np.zeros((7, 7, 7))
    bead[3, 3, 3] = 1.0
    bead = gaussian_filter(bead, 1.0)
    blurred_bead = convolve(np.pad(bead, 8), psf.astype(np.float64))
    truth = np.full(shape, 100.0, np.float32)
    blurred = np.full(shape, 100.0, np.float32)
    pos = rng.integers(12, np.array(shape) - 12, (n_beads, 3))
    amp = rng.uniform(2000, 20000, n_beads)
    for stamp, vol in ((bead, truth), (blurred_bead, blurred)):
        r = [s // 2 for s in stamp.shape]
        for (z, y, x), a in zip(pos, amp):
            sl = tuple(slice(c - h, c - h + s)
                       for c, h, s in zip((z, y, x), r, stamp.shape))
            sub = tuple(slice(max(0, -s.start), stamp.shape[i] - max(
                0, s.stop - shape[i])) for i, s in enumerate(sl))
            sl = tuple(slice(max(0, s.start), min(shape[i], s.stop))
                       for i, s in enumerate(sl))
            vol[sl] += a * stamp[sub]
    in_dir.mkdir(parents=True)
    for z in range(shape[0]):
        blurred[z] += rng.normal(0, 5, shape[1:]).astype(np.float32)
        tio.imwrite(in_dir / f"img_{z:06d}.tif",
                    np.clip(blurred[z], 0, 65535).astype(np.uint16))
    return truth, blurred


def phase_decon(shape=(256, 2048, 2048), niter: int = 6,
                n_beads: int = 40000, seed: int = 5, extra=()):
    """deconvolve.main on a seeded bead series under the default block
    plan: every plane written, finite rescale stats, and the output
    correlates with the truth better than the input does."""
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.pipeline.deconvolve import (autosplit, fft_work_shape,
                                             main as deconvolve)

    ph = Phase("decon")
    psf = reference_psf()
    plans, halo, planned = autosplit(shape, psf.shape)
    ph.say(f"default plan for {shape}: {len(plans)} blocks of "
           f"{planned} (work shape {fft_work_shape(plans, halo)}), halo "
           f"{halo}")
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        t0 = time.perf_counter()
        truth, blurred = _decon_input(td / "in", shape, psf, seed, n_beads)
        ph.say(f"input written in {time.perf_counter() - t0:.1f} s")
        c0 = _COMPILE_SECS[0]
        t0 = time.perf_counter()
        rc = deconvolve(["--input", str(td / "in"), "--output",
                         str(td / "out"), "--niter", str(niter),
                         "--gaussian-sigma", "0.5", "0.5", "0.5"]
                        + list(extra))
        wall = time.perf_counter() - t0
        rate = np.prod(shape) / wall / 1e6
        ph.say(f"deconvolve wall {wall:.1f} s, of which XLA compile "
               f"{_COMPILE_SECS[0] - c0:.1f} s; {rate:.1f} Mvox/s end to "
               f"end; peak_bytes_in_use {fmt_bytes(peak_bytes())}")
        ph.require("deconvolve exit code 0", rc == 0)
        outs = sorted((td / "out").glob("img_*.tif"))
        ph.require(f"{len(outs)} of {shape[0]} planes written",
                   len(outs) == shape[0])
        man = json.loads((td / "out" / "blocks_manifest.json").read_text())
        ph.require(f"rescale stats finite ({man['deconvmin']:.4g}, "
                   f"{man['deconvmax']:.4g})",
                   bool(np.isfinite([man["deconvmin"],
                                     man["deconvmax"]]).all()))
        zs = slice(shape[0] // 2 - 16, shape[0] // 2 + 16)
        dec = np.stack([tio.imread(p) for p in outs[zs]]).astype(np.float64)
        t, b = truth[zs].ravel(), blurred[zs].ravel()
        c_blur = float(np.corrcoef(b, t)[0, 1])
        c_dec = float(np.corrcoef(dec.ravel(), t)[0, 1])
        ph.say(f"correlation with the truth: input {c_blur:.4f}, "
               f"deconvolved {c_dec:.4f}")
        ph.check("sharpening: corr(decon, truth) - corr(input, truth)",
                 c_dec - c_blur, 0.02, "6 RL iterations must move the "
                 "blurred beads measurably toward the truth",
                 higher_is_better=True)
    ph.done()


def phase_planned_block(vol_shape=REFERENCE_VOLUME, niter: int = 6,
                        sigma=(0.5, 0.5, 0.5)):
    """The per-block decon chain (u16 upload, f32, gaussian prefilter,
    RL, crop + u16 quantize) at the block the planner picks for the
    LsDeconv benchmark volume: time and memory only."""
    import jax
    import jax.numpy as jnp

    from ipp_tpu.ops.deconv import gauss3d, richardson_lucy
    from ipp_tpu.pipeline.deconvolve import (RL_BYTES_PER_VOXEL, autosplit,
                                             fft_work_shape)

    ph = Phase("planned_block")
    psf = jnp.asarray(reference_psf())
    plans, halo, planned = autosplit(vol_shape, tuple(psf.shape))
    work = fft_work_shape(plans, halo)
    ph.say(f"plan for {vol_shape}: {len(plans)} blocks of {planned}, work "
           f"shape {work}, halo {halo}, budget {RL_BYTES_PER_VOXEL} B/vox")
    core = tuple(slice(h, u - h) for h, u in zip(halo, work))

    def block_chain(raw):
        x = gauss3d(raw.astype(jnp.float32), sigma)
        dec = richardson_lucy(x, psf, niter=niter, fft_shape=work)[core]
        lo, hi = jnp.min(dec), jnp.max(dec)
        q = jnp.rint((dec - lo) * (65535.0 / jnp.maximum(hi - lo, 1e-30)))
        return jnp.clip(q, 0, 65535).astype(jnp.uint16), lo, hi

    raw = jax.random.randint(jax.random.key(6), work, 0, 4000,
                             jnp.int32).astype(jnp.uint16)
    gauss_only = jax.jit(lambda r: gauss3d(r.astype(jnp.float32), sigma))
    _, t_g = compile_and_time(ph, f"gauss3d prefilter {work}", gauss_only,
                              raw, reps=2)
    (q, lo, hi), t = compile_and_time(
        ph, f"block chain {work} niter {niter}", block_chain, raw, reps=2)
    n_core = np.prod([u - 2 * h for h, u in zip(halo, work)])
    ph.say(f"{t:.3f} s per block ({t_g:.3f} s of it the prefilter), "
           f"{n_core / t / 1e6:.1f} core Mvox/s, whole volume "
           f"{len(plans) * t / 60:.1f} min on one card at this rate")
    ph.require("block output finite",
               bool(np.isfinite([float(lo), float(hi)]).all()))
    ph.done()


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def _mesh(n: int):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("data", "z"))


def phase_mesh_decon(shape=(96, 1024, 1024), max_block_mvox: float = 12.0,
                     n_dev: int = 4, seed: int = 7):
    """deconvolve_volume over an n-device mesh against the one-device run
    of the same input: the same u16 output planes."""
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.pipeline.deconvolve import (autosplit, block_elems_arg,
                                             deconvolve_volume)

    ph = Phase("mesh_decon")
    psf = reference_psf()
    budget = block_elems_arg(max_block_mvox)
    plans, _, planned = autosplit(shape, psf.shape, budget)
    ph.say(f"{len(plans)} blocks of {planned} over {n_dev} devices")
    ph.require(f"at least 8 blocks planned ({len(plans)})", len(plans) >= 8)
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        _decon_input(td / "in", shape, psf, seed, n_beads=4000)
        outs = {}
        for label, mesh in (("mesh", _mesh(n_dev)), ("one", False)):
            t0 = time.perf_counter()
            deconvolve_volume(td / "in", td / label, psf, niter=6,
                              gaussian_sigma=(0.5, 0.5, 0.5),
                              max_block_elems=budget, mesh=mesh)
            ph.say(f"{label}: {time.perf_counter() - t0:.1f} s")
            outs[label] = np.stack([tio.imread(p) for p in sorted(
                (td / label).glob("img_*.tif"))]).astype(np.int64)
        ph.check("max |mesh - one device| (u16 counts)",
                 int(np.abs(outs["mesh"] - outs["one"]).max()), 2,
                 "same per-block math compiled as two programs; the brick "
                 "quantization and the final rescale may each flip a count")
        ph.check("mesh vs one device, relative error (NRMSE)",
                 nrmse(outs["mesh"], outs["one"]), 1e-3,
                 "the pipeline's output tolerance (BASELINE.md)")
    ph.done()


def phase_mesh_stitch(tile: int = 512, depth: int = 16, grid: int = 3,
                      n_dev: int = 4, seed: int = 8):
    """Stitch steps 2 (NCC) and 6 (merge) over an n-device mesh against
    the one-device run: identical placement and identical planes."""
    from ipp_tpu.geometry.stacks import TileGrid
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.parallel.mesh import make_mesh
    from ipp_tpu.pipeline.process_images import process_channel

    ph = Phase("mesh_stitch")
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        _stitch_input(td, tile, depth, grid, seed)
        ch = td / "raw" / "Ex_488_Em_525"
        res = {}
        for label, mesh in (("mesh", make_mesh(n_dev, z_parallel=1)),
                            ("one", make_mesh(1, z_parallel=1))):
            out = td / label / "Ex_488_Em_525"
            t0 = time.perf_counter()
            process_channel(ch, td / label / "pre", out, (0.41, 0.41, 1.0),
                            (tile, tile), None, search_radius=12,
                            subvol_dim=depth, skip_inspection=True,
                            mesh=mesh)
            ph.say(f"{label}: {time.perf_counter() - t0:.1f} s")
            g = TileGrid.from_xml(td / label / "Ex_488_Em_525_placement.xml")
            res[label] = (
                [(s.abs_h, s.abs_v, s.abs_d) for s in g.flattened()],
                np.stack([tio.imread(p) for p in sorted(out.glob(
                    "img_*.tif"))]))
        ph.require("placement identical", res["mesh"][0] == res["one"][0])
        ph.check("max |mesh - one device| merged planes (counts)",
                 int(np.abs(res["mesh"][1].astype(np.int64)
                            - res["one"][1]).max()), 0,
                 "blend is elementwise per plane")
    ph.done()


def phase_sharded_rl(shape=(256, 512, 512), n_dev: int = 4, halo: int = 24,
                     seed: int = 9):
    """richardson_lucy_sharded_z over n devices (z slabs with exchanged
    real-data halos) against single-device RL of the whole volume,
    compared away from the volume's z faces."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ipp_tpu.ops.deconv import richardson_lucy, richardson_lucy_sharded_z

    ph = Phase("sharded_rl")
    psf = reference_psf()
    vol = (np.random.default_rng(seed).random(shape, dtype=np.float32)
           * 1000 + 100)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("z",))
    t0 = time.perf_counter()
    out = np.asarray(richardson_lucy_sharded_z(jnp.asarray(vol),
                                               jnp.asarray(psf), mesh,
                                               niter=6, halo=halo))
    ph.say(f"sharded over {n_dev}: {time.perf_counter() - t0:.1f} s "
           "(incl. compile)")
    ref = np.asarray(richardson_lucy(jnp.asarray(vol), jnp.asarray(psf),
                                     niter=6))
    inner = slice(halo, shape[0] - halo)
    ph.check("z-sharded vs one-device RL NRMSE (away from z faces)",
             nrmse(out[inner], ref[inner]), 1e-4,
             f"overlap-save halo of {halo} planes")
    ph.done()


ONE_CARD = [phase_destripe, phase_lightsheet, phase_ncc, phase_rl,
            phase_convs, phase_stitch, phase_decon, phase_planned_block]
FOUR_CARDS = [phase_mesh_decon, phase_mesh_stitch, phase_sharded_rl]


def header(devices) -> None:
    import jax

    from ipp_tpu import native
    from ipp_tpu.utils.jaxconfig import cache_dir

    smi = shutil.which("nvidia-smi")
    card = (subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip() if smi
        else "nvidia-smi not found")
    print(card, flush=True)
    print(f"jax {jax.__version__}, platform {devices[0].platform}, "
          f"device_kind {devices[0].device_kind}, devices {len(devices)}, "
          f"XLA_FLAGS {os.environ.get('XLA_FLAGS')!r}, compile cache "
          f"{cache_dir()}, native codec loaded {native.available()}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from ipp_tpu.utils.jaxconfig import enable_persistent_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r}); nothing was run", file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    enable_persistent_cache()
    _count_compiles()
    header(devices)
    failed = []
    for phase in (FOUR_CARDS if args.four_cards else ONE_CARD):
        t0 = time.perf_counter()
        try:
            phase()
            status = "ok"
        except Exception as exc:  # report every phase, fail the run
            traceback.print_exc()
            failed.append(phase.__name__)
            status = f"FAILED ({type(exc).__name__}: {exc})"
        print(f"== {phase.__name__}: {status} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for i, d in enumerate(devices[:want]):
        print(f"device {i} ({d.device_kind}) peak_bytes_in_use "
              f"{fmt_bytes(peak_bytes(d))}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

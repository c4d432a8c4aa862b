"""Richardson-Lucy deconvolution — FFT-domain, sharded over devices.

Re-design of the reference's MATLAB/CUDA deconvolution core
(LsDeconvolveMultiGPU/decon.m:1-374, gauss3d_gpu.cu, conv3d_gpu.cu,
edgetaper_3d.m, make_taper.m):

- `richardson_lucy` runs the exact iteration of deconFFT (decon.m:127-204):
  OTF = fftn(ifftshift(pad(psf))); per iter 2 rFFT + 2 irFFT (the reference
  uses complex fftn; real-to-complex halves bandwidth), ratio with epsilon
  floor, optional Tikhonov-damped regularization every regularize_interval
  iterations (3^3 mean kernel with zero center), early stop on relative
  L2-norm change, final abs().
- `edge_taper_3d` reproduces edgetaper_3d.m: blend toward the PSF-blurred
  volume near faces with separable linear ramps of width max(8, psf_dim/2).
- `gauss3d` is the separable 3D gaussian of gauss3d_gpu.cu /
  imgaussfilt3 (kernel 2*ceil(2*sigma)+1, replicate padding).
- Everything is jittable; `richardson_lucy` accepts a jax.sharding.Sharding
  so blocks shard over a device mesh, with XLA inserting the FFT collectives
  (the LsDeconv multi-GPU semaphore work-stealing runtime is replaced by
  data-parallel block scheduling in ipp_tpu.pipeline.deconvolve).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .fftutil import next_fast_len

__all__ = [
    "gauss3d",
    "gauss3d_batched",
    "make_taper",
    "edge_taper_3d",
    "pad_to_shape",
    "unpad",
    "fft_shape_for",
    "richardson_lucy",
    "richardson_lucy_batched",
    "richardson_lucy_wiener",
    "richardson_lucy_spatial",
]


def _gauss_kernel(sigma: float) -> np.ndarray:
    """imgaussfilt3-compatible taps: size 2*ceil(2*sigma)+1."""
    radius = int(math.ceil(2.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d_axis(vol: jnp.ndarray, taps: np.ndarray, axis: int) -> jnp.ndarray:
    """'same' 1D convolution along axis with replicate padding."""
    radius = len(taps) // 2
    x = jnp.moveaxis(vol, axis, -1)
    pad = [(0, 0)] * (x.ndim - 1) + [(radius, radius)]
    xp = jnp.pad(x, pad, mode="edge")
    lhs = xp.reshape(-1, 1, xp.shape[-1])
    rhs = jnp.asarray(taps[::-1].copy(), x.dtype)[None, None, :]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, (1,), "VALID", dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    out = out.reshape(x.shape)
    return jnp.moveaxis(out, -1, axis)


def gauss3d(vol: jnp.ndarray, sigma) -> jnp.ndarray:
    """Separable 3D gaussian, replicate boundary (reference gauss3d_gpu.cu;
    MATLAB-compatible kernel size)."""
    if np.isscalar(sigma):
        sigma = (float(sigma),) * 3
    out = vol
    for ax, s in enumerate(sigma):
        if s > 0:
            out = _conv1d_axis(out, _gauss_kernel(s), ax)
    return out


def gauss3d_batched(vols: jnp.ndarray, sigma) -> jnp.ndarray:
    """gauss3d over a (B, D, H, W) batch: separable convs on axes 1..3."""
    if np.isscalar(sigma):
        sigma = (float(sigma),) * 3
    out = vols
    for ax, s in enumerate(sigma):
        if s > 0:
            out = _conv1d_axis(out, _gauss_kernel(s), ax + 1)
    return out


def make_taper(dimsz: int, taper_width: int) -> np.ndarray:
    """1D edge taper: 0->1 ramp, plateau, 1->0 ramp
    (reference make_taper.m:1-36)."""
    taper_width = int(min(taper_width, dimsz // 2))
    if taper_width <= 0:
        return np.ones(dimsz, np.float32)
    ramp = np.linspace(0.0, 1.0, taper_width + 1)
    if 2 * taper_width < dimsz:
        plateau = np.ones(dimsz - 2 * taper_width)
        taper = np.concatenate([ramp, plateau, ramp[:-1][::-1]])
    else:
        taper = np.concatenate([ramp, ramp[:-1][::-1]])
    taper = taper.astype(np.float32)
    if len(taper) > dimsz:
        taper = taper[:dimsz]
    elif len(taper) < dimsz:
        taper = np.concatenate([taper, np.ones(dimsz - len(taper), np.float32)])
    return taper


def edge_taper_3d(vol: jnp.ndarray, psf: jnp.ndarray,
                  face_slabs: bool = True) -> jnp.ndarray:
    """bll = mask*bl + (1-mask)*blur(bl) with separable ramps of width
    max(8, psf_dim/2) per axis (reference edgetaper_3d.m:1-46).

    The blurred volume only matters where mask < 1 — within taper_width of
    a face — so the blur runs on six face slabs (each extended by the PSF
    support) instead of the whole volume: ~95% less conv work for a 264^3
    block.  Each slab conv is an FFT convolution (a direct single-channel
    3D conv of a PSF-sized kernel costs ~PSF-volume FMAs per voxel)."""
    psf = psf / jnp.sum(psf)
    # the effective ramp width is capped at half the axis (make_taper);
    # slab bookkeeping must use the same cap
    tws = [min(max(8, int(round(psf.shape[d] / 2))), vol.shape[d] // 2)
           for d in range(3)]
    mask = jnp.ones((), vol.dtype)
    for d in range(3):
        taper = jnp.asarray(make_taper(vol.shape[d], tws[d]), vol.dtype)
        shape = [1, 1, 1]
        shape[d] = vol.shape[d]
        mask = mask * taper.reshape(shape)
    if (not face_slabs
            or any(tw + k > s for tw, k, s in zip(tws, psf.shape, vol.shape))):
        # face_slabs=False (sharded callers: slab slicing would fight the
        # z sharding) or a slab would not fit: blur the full volume
        blur = _fft_conv_same(vol, psf)
        return mask * vol + (1.0 - mask) * blur
    out = mask * vol
    inv = 1.0 - mask
    for d in range(3):
        k = psf.shape[d]
        tw = tws[d]
        ext = tw + k  # slab depth incl. conv support
        for side in (0, 1):
            sl_read = [slice(None)] * 3
            sl_read[d] = slice(0, ext) if side == 0 else \
                slice(vol.shape[d] - ext, vol.shape[d])
            slab = vol[tuple(sl_read)]
            blur = _fft_conv_same(slab, psf)
            sl_keep = [slice(None)] * 3
            sl_keep[d] = slice(0, tw) if side == 0 else slice(ext - tw, ext)
            sl_write = [slice(None)] * 3
            sl_write[d] = slice(0, tw) if side == 0 else \
                slice(vol.shape[d] - tw, vol.shape[d])
            # avoid double-adding corner/edge regions shared with slabs of
            # earlier axes by zeroing their contribution here
            contrib = inv[tuple(sl_write)] * blur[tuple(sl_keep)]
            for dd in range(d):
                z = jnp.ones_like(contrib)
                tw_dd = tws[dd]
                sl_z_lo = [slice(None)] * 3
                sl_z_lo[dd] = slice(0, tw_dd)
                sl_z_hi = [slice(None)] * 3
                sl_z_hi[dd] = slice(contrib.shape[dd] - tw_dd, None)
                z = z.at[tuple(sl_z_lo)].set(0.0)
                z = z.at[tuple(sl_z_hi)].set(0.0)
                contrib = contrib * z
            out = out.at[tuple(sl_write)].add(contrib)
    return out


def _fft_conv_same(vol: jnp.ndarray, kern: jnp.ndarray) -> jnp.ndarray:
    """'same' conv via FFT with edge-replicate padding by kernel half-size."""
    halves = [k // 2 for k in kern.shape]
    vp = jnp.pad(vol, [(h, h) for h in halves], mode="edge")
    shape = tuple(next_fast_len(s + k - 1)
                  for s, k in zip(vp.shape, kern.shape))
    fv = jnp.fft.rfftn(vp, s=shape)
    fk = jnp.fft.rfftn(kern.astype(vol.dtype), s=shape)
    full = jnp.fft.irfftn(fv * fk, s=shape)
    start = [2 * h for h in halves]
    return jax.lax.dynamic_slice(full, start, vol.shape)


def fft_shape_for(shape: Sequence[int], psf_shape: Sequence[int],
                  pad_mode: str = "min") -> Tuple[int, int, int]:
    """FFT work shape: block + PSF half-extents, rounded up to 2,3,5,7-smooth
    sizes (reference decon_pad_size/next_fast_len, LsDeconv.m:387-419)."""
    return tuple(next_fast_len(int(s) + int(p) // 2 * 2)
                 for s, p in zip(shape, psf_shape))


def _make_convolver(psf: jnp.ndarray, fft_shape):
    """(conv, conv_conj_ratio, update) closures over cuFFT/XLA rffts:
    `conv(x)` is the circular PSF convolution; `conv_conj_ratio(num, den)`
    is the adjoint convolution of the RL ratio num / max(den, eps)
    (decon.m:169); `update(bl, num, den)` is the full multiplicative RL
    step |bl * conv^T(ratio)| (decon.m:169-171).  Input arrays may carry
    leading batch dims."""
    otf = _make_otf(psf, fft_shape)
    eps = jnp.float32(np.finfo(np.float32).eps)
    otf_c = jnp.conj(otf)
    axes = (-3, -2, -1)

    def conv(x):
        return jnp.fft.irfftn(jnp.fft.rfftn(x, axes=axes) * otf,
                              s=fft_shape, axes=axes)

    def conv_conj_ratio(num, den):
        ratio = num / jnp.maximum(den, eps)
        return jnp.fft.irfftn(jnp.fft.rfftn(ratio, axes=axes) * otf_c,
                              s=fft_shape, axes=axes)

    def update(bl, num, den):
        return jnp.abs(bl * conv_conj_ratio(num, den))

    return conv, conv_conj_ratio, update


def pad_to_shape(vol: jnp.ndarray, target: Sequence[int], mode: str = "constant"):
    """Center-pad to target (reference pad_block_to_fft_shape,
    decon.m:323-345).  Returns (padded, pad_pre, pad_post)."""
    missing = [t - s for t, s in zip(target, vol.shape)]
    assert all(m >= 0 for m in missing), (vol.shape, target)
    pre = [m // 2 for m in missing]
    post = [m - p for m, p in zip(missing, pre)]
    out = jnp.pad(vol, list(zip(pre, post)), mode=mode)
    return out, tuple(pre), tuple(post)


def unpad(vol: jnp.ndarray, pre: Sequence[int], post: Sequence[int]):
    sl = tuple(slice(p, s - q) for p, q, s in zip(pre, post, vol.shape))
    return vol[sl]


def _tikhonov_kernel() -> np.ndarray:
    """3x3x3 mean kernel with zero center (reference decon.m:44-46)."""
    R = np.full((3, 3, 3), 1.0 / 26.0, np.float32)
    R[1, 1, 1] = 0.0
    return R


def _make_otf(psf: jnp.ndarray, fft_shape) -> jnp.ndarray:
    """rFFT of the PSF with its center voxel rolled exactly to index 0.

    The reference uses ifftshift(padarray(psf)) (decon.m:140-142), which for
    even FFT sizes parks an odd-sized PSF's center one voxel off origin; we
    roll by the true center so H is exactly the zero-phase blur operator."""
    otf_pad, pre, _ = pad_to_shape(psf, fft_shape)
    center = tuple(p + s // 2 for p, s in zip(pre, psf.shape))
    return jnp.fft.rfftn(jnp.roll(otf_pad, tuple(-c for c in center),
                                  axis=(0, 1, 2)))


@partial(jax.jit, static_argnames=(
    "niter", "fft_shape", "stop_criterion", "regularize_interval", "lam",
    "classic"))
def _rl_fft_iterations(bl, psf, *, niter, fft_shape, lam, stop_criterion,
                       regularize_interval, classic):
    """The deconFFT loop (decon.m:127-204), expressed as lax.while_loop so
    early stopping works under jit.

    classic=False reproduces the reference exactly: the ratio numerator is
    the *current estimate* (decon.m:169 'buf = bl ./ buf'), a memory-saving
    variant that sharpens for ~4-6 iterations then diverges.  classic=True
    keeps the observed volume as the RL numerator (textbook
    Richardson-Lucy), which converges monotonically — measured 0.016 vs
    0.063 NRMSE at 12 iterations on a synthetic phantom.
    """
    conv, conv_conj_ratio, update = _make_convolver(psf, fft_shape)
    eps = jnp.float32(np.finfo(np.float32).eps)
    R = jnp.asarray(_tikhonov_kernel())
    apply_reg = 0 < regularize_interval < niter
    y_obs = bl

    def body(carry):
        i, bl, delta_prev, done = carry
        if not apply_reg:  # common path: one fully fused RL step
            num_src = y_obs if classic else bl
            buf = conv(bl)
            bl = update(bl, num_src, buf)
        else:
            is_reg = jnp.logical_and(
                apply_reg,
                jnp.logical_and(jnp.logical_and(i > 1, i < niter),
                                (i % regularize_interval) == 0))
            bl = jax.lax.cond(is_reg, lambda v: gauss3d(v, 0.5),
                              lambda v: v, bl)
            # the RL ratio numerator must see the POST-smoothing estimate
            # (reference decon.m:160-169 computes `buf = bl ./ buf` with the
            # already-smoothed bl) — capture num_src only after the cond
            num_src = y_obs if classic else bl
            buf = conv(bl)
            buf = conv_conj_ratio(num_src, buf)

            def with_reg(args):
                bl_, buf_ = args
                reg = _conv3d_zero(bl_, R)
                return bl_ * buf_ * (1.0 - lam) + reg * lam

            def no_reg(args):
                bl_, buf_ = args
                return bl_ * buf_

            use_reg = jnp.logical_and(is_reg, lam > 0)
            bl = jax.lax.cond(use_reg, with_reg, no_reg, (bl, buf))
            bl = jnp.abs(bl)
        if stop_criterion > 0:  # static: skip the norm passes otherwise
            delta_cur = jnp.linalg.norm(bl.reshape(-1))
            rel = (jnp.abs(delta_prev - delta_cur)
                   / jnp.maximum(delta_prev, eps) * 100.0)
            done = jnp.logical_and(i > 1, rel <= stop_criterion)
        else:
            delta_cur = delta_prev
            done = jnp.bool_(False)
        return i + 1, bl, delta_cur, done

    def cond(carry):
        i, _, _, done = carry
        return jnp.logical_and(i <= niter, jnp.logical_not(done))

    delta0 = (jnp.linalg.norm(bl.reshape(-1)) if stop_criterion > 0
              else jnp.float32(0))
    _, bl, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(1), bl, delta0, jnp.bool_(False)))
    return bl


def _conv3d_zero(vol: jnp.ndarray, kern: jnp.ndarray) -> jnp.ndarray:
    """3D 'same' convolution with zero boundary (MATLAB convn 'same')."""
    kd, kh, kw = kern.shape
    lhs = vol[None, None]
    rhs = kern[::-1, ::-1, ::-1][None, None].astype(vol.dtype)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, (1, 1, 1),
        [(kd // 2, kd - 1 - kd // 2), (kh // 2, kh - 1 - kh // 2),
         (kw // 2, kw - 1 - kw // 2)],
        dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
        precision=jax.lax.Precision.HIGHEST)
    return out[0, 0]


def richardson_lucy(
    vol: jnp.ndarray,
    psf: jnp.ndarray,
    niter: int = 10,
    lam: float = 0.0,
    stop_criterion: float = 0.0,
    regularize_interval: int = 0,
    fft_shape: Optional[Tuple[int, int, int]] = None,
    edge_taper: bool = True,
    sharding=None,
    classic: bool = True,
) -> jnp.ndarray:
    """FFT-domain Richardson-Lucy deconvolution of a (D, H, W) block
    (reference decon.m deconFFT path; orchestrated per block by
    LsDeconv.m:906-947).

    vol/psf are (z, y, x) float32.  When `sharding` is given, the block is
    constrained to that sharding so the FFTs run distributed over the mesh.
    """
    vol = jnp.asarray(vol, jnp.float32)
    psf = jnp.asarray(psf, jnp.float32)
    if fft_shape is None:
        fft_shape = fft_shape_for(vol.shape, psf.shape)
    # the WHOLE pipeline (normalize/taper/pad/iterate/unpad) compiles as
    # one program, so the taper slabs do not dispatch op by op
    out = _rl_single(
        vol, psf, niter=int(niter),
        fft_shape=tuple(int(s) for s in fft_shape),
        lam=float(lam), stop_criterion=float(stop_criterion),
        regularize_interval=int(regularize_interval),
        edge_taper=bool(edge_taper), classic=bool(classic),
        sharding=sharding)
    return out


@partial(jax.jit, static_argnames=(
    "niter", "fft_shape", "lam", "stop_criterion", "regularize_interval",
    "edge_taper", "classic", "sharding"))
def _rl_single(vol, psf, *, niter, fft_shape, lam, stop_criterion,
               regularize_interval, edge_taper, classic, sharding):
    psf = psf / jnp.sum(psf)
    if edge_taper:
        vol = edge_taper_3d(vol, psf)
    vol, pre, post = pad_to_shape(vol, fft_shape)
    if sharding is not None:
        vol = jax.lax.with_sharding_constraint(vol, sharding)
    out = _rl_fft_iterations(
        vol, psf, niter=niter, fft_shape=fft_shape, lam=lam,
        stop_criterion=stop_criterion,
        regularize_interval=regularize_interval, classic=classic)
    return unpad(out, pre, post)


def richardson_lucy_batched(
    vols: jnp.ndarray,
    psf: jnp.ndarray,
    niter: int = 10,
    lam: float = 0.0,
    regularize_interval: int = 0,
    fft_shape: Optional[Tuple[int, int, int]] = None,
    edge_taper: bool = True,
    sharding=None,
    classic: bool = True,
    stop_criterion: float = 0.0,
) -> jnp.ndarray:
    """Data-parallel RL over a batch of equal-shape blocks (B, D, H, W).

    The multi-device replacement for LsDeconv's per-GPU block work-stealing
    (LsDeconv.m:644-706): blocks batch along the leading axis and shard over
    the mesh 'data' axis; optionally the z axis also shards over 'z'
    (sequence-parallel FFTs with XLA-inserted collectives).

    stop_criterion > 0 enables the reference's per-block relative-norm
    early stop (decon.m:155-204): the batch runs as a vmapped while_loop,
    whose batching rule freezes converged lanes (lax.select per lane) and
    exits once EVERY block has converged — bitwise the same per-block
    results as the single-device early-stopped path.
    """
    vols = jnp.asarray(vols, jnp.float32)
    psf = jnp.asarray(psf, jnp.float32)
    psf = psf / jnp.sum(psf)
    if fft_shape is None:
        fft_shape = fft_shape_for(vols.shape[1:], psf.shape)
    if edge_taper:
        vols = jax.vmap(
            lambda v: edge_taper_3d(v, psf, face_slabs=False))(vols)
    missing = [t - s for t, s in zip(fft_shape, vols.shape[1:])]
    pre = [m // 2 for m in missing]
    post = [m - p for m, p in zip(missing, pre)]
    vols = jnp.pad(vols, [(0, 0)] + list(zip(pre, post)))
    if sharding is not None:
        vols = jax.lax.with_sharding_constraint(vols, sharding)
    if stop_criterion and stop_criterion > 0:
        out = jax.vmap(lambda v: _rl_fft_iterations(
            v, psf, niter=int(niter),
            fft_shape=tuple(int(s) for s in fft_shape),
            lam=float(lam), stop_criterion=float(stop_criterion),
            regularize_interval=int(regularize_interval),
            classic=bool(classic)))(vols)
        sl = tuple([slice(None)] + [slice(p, s - q) for p, q, s in
                                    zip(pre, post, out.shape[1:])])
        return out[sl]
    conv, conv_conj_ratio, update = _make_convolver(psf, fft_shape)
    R = jnp.asarray(_tikhonov_kernel())
    bl = vols
    y_obs = vols
    for i in range(1, niter + 1):
        is_reg = (0 < regularize_interval < niter and 1 < i < niter
                  and i % regularize_interval == 0)
        if is_reg:
            taps = _gauss_kernel(0.5)
            for ax in (1, 2, 3):
                bl = _conv1d_axis(bl, taps, ax)
        buf = conv(bl)
        num_src = y_obs if classic else bl
        if is_reg and lam > 0:
            buf = conv_conj_ratio(num_src, buf)
            reg = jax.vmap(lambda v: _conv3d_zero(v, R))(bl)
            bl = jnp.abs(bl * buf * (1.0 - lam) + reg * lam)
        else:
            bl = update(bl, num_src, buf)
    sl = tuple([slice(None)] + [slice(p, s - q) for p, q, s in
                                zip(pre, post, bl.shape[1:])])
    return bl[sl]


def richardson_lucy_wiener(
    vol: jnp.ndarray,
    psf: jnp.ndarray,
    niter: int = 10,
    lam: float = 0.0,
    regularize_interval: int = 0,
    fft_shape: Optional[Tuple[int, int, int]] = None,
    edge_taper: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Blind RL with on-the-fly Wiener PSF refinement
    (reference deconFFT_Wiener, decon.m:206-321):

    after each RL update the PSF is re-estimated from the spectra of the
    previous and current object estimates,
        otf_new = (F{prev} . conj(F{cur})) / (|F{cur}|^2 + eps),
    cropped to the PSF extent, clamped non-negative and renormalized.
    Returns (deconvolved, refined_psf).
    """
    vol = jnp.asarray(vol, jnp.float32)
    psf = jnp.asarray(psf, jnp.float32)
    psf = psf / jnp.sum(psf)
    if fft_shape is None:
        fft_shape = fft_shape_for(vol.shape, psf.shape)
    if edge_taper:
        vol = edge_taper_3d(vol, psf)
    bl, pre, post = pad_to_shape(vol, fft_shape)
    eps = jnp.float32(np.finfo(np.float32).eps)
    R = jnp.asarray(_tikhonov_kernel())
    psf_shape = psf.shape
    center = tuple((f - p) // 2 for f, p in zip(fft_shape, psf_shape))

    f_obs = jnp.fft.fftn(bl)  # F{Y}: spectrum of the observed volume.
    # The reference's comment says the update is otf_new =
    # F{Y}.conj(F{X})/(|F{X}|^2+eps) but its code substitutes the previous
    # *estimate* for Y from iteration 2 on (decon.m:283-306), which makes
    # the PSF collapse toward identity; we keep the observed spectrum, which
    # matches the stated model psf: X -> Y.
    f_prev = f_obs
    for i in range(1, niter + 1):
        is_reg = (0 < regularize_interval < niter and i > 1
                  and i % regularize_interval == 0)
        if is_reg:
            bl = gauss3d(bl, 0.5)
            f_prev = jnp.fft.fftn(bl)
        otf_pad, _, _ = pad_to_shape(psf, fft_shape)
        c = tuple(cc + s // 2 for cc, s in zip(center, psf_shape))
        otf = jnp.fft.fftn(jnp.roll(otf_pad, tuple(-x for x in c),
                                    axis=(0, 1, 2)))
        buf = jnp.real(jnp.fft.ifftn(f_prev * otf))
        buf = jnp.maximum(buf, eps)
        buf = bl / buf
        buf = jnp.real(jnp.fft.ifftn(jnp.fft.fftn(buf) * jnp.conj(otf)))
        if is_reg and lam > 0 and i < niter:
            reg = _conv3d_zero(bl, R)
            bl = bl * buf * (1.0 - lam) + reg * lam
        else:
            bl = bl * buf
        bl = jnp.abs(bl)
        if i < niter:
            # Wiener PSF update (decon.m:283-306)
            f_cur = jnp.fft.fftn(bl)
            denom = jnp.maximum(jnp.real(f_cur * jnp.conj(f_cur)), eps)
            otf_new = f_obs * jnp.conj(f_cur) / denom
            # the impulse response of the spectral ratio is centered at
            # index 0 with wraparound; fftshift before cropping the middle
            # (the reference crops without shifting, decon.m:299-302, which
            # grabs the response tails — a bug its 'experimental' comment
            # hints at)
            psf_full = jnp.fft.fftshift(jnp.real(jnp.fft.ifftn(otf_new)))
            sl = tuple(slice(cc, cc + s) for cc, s in zip(center, psf_shape))
            new_psf = jnp.maximum(psf_full[sl], 0.0)
            total = jnp.sum(new_psf)
            new_psf = jnp.where(total > 0,
                                new_psf / jnp.maximum(total, eps), psf)
            # damped update: the raw Wiener estimate is noisy and collapses
            # blind RL (a stabilizer absent from the reference's
            # experimental path)
            psf = 0.7 * psf + 0.3 * new_psf
            psf = psf / jnp.maximum(jnp.sum(psf), eps)
            f_prev = f_cur
    return unpad(bl, pre, post), psf


def richardson_lucy_spatial(vol: jnp.ndarray, psf: jnp.ndarray,
                            niter: int = 10, lam: float = 0.0,
                            regularize_interval: int = 0) -> jnp.ndarray:
    """Spatial-domain RL (reference deconSpatial, decon.m:26-125): direct
    convn with psf and its flipped adjoint.  Practical for small PSFs."""
    vol = jnp.asarray(vol, jnp.float32)
    psf = jnp.asarray(psf, jnp.float32)
    psf = psf / jnp.sum(psf)
    psf_inv = psf[::-1, ::-1, ::-1]
    eps = jnp.float32(np.finfo(np.float32).eps)
    R = jnp.asarray(_tikhonov_kernel())
    bl = edge_taper_3d(vol, psf)
    for i in range(1, niter + 1):
        is_reg = (0 < regularize_interval < niter and i > 1 and i < niter
                  and i % regularize_interval == 0)
        if is_reg:
            bl = gauss3d(bl, 0.5)
        buf = _conv3d_zero(bl, psf)
        buf = jnp.maximum(buf, eps)
        buf = bl / buf
        buf = _conv3d_zero(buf, psf_inv)
        if is_reg and lam > 0:
            reg = _conv3d_zero(bl, R)
            bl = bl * buf * (1.0 - lam) + reg * lam
        else:
            bl = bl * buf
        bl = jnp.abs(bl)
    return bl


def richardson_lucy_sharded_z(
    vol: jnp.ndarray,
    psf: jnp.ndarray,
    mesh,
    niter: int = 10,
    halo: Optional[int] = None,
    axis_name: str = "z",
    classic: bool = True,
) -> jnp.ndarray:
    """Sequence-parallel RL: the volume's z axis shards over the mesh, each
    device deconvolves its slab extended by exchanged real-data halos, and
    halos are discarded (overlap-discard — exactly the reference's block
    decomposition with real z padding, LsDeconv.m:173-174, distributed over
    chips via ppermute instead of the shared filesystem).

    vol: (Z, H, W) with Z divisible by the mesh's `axis_name` size.
    """
    from ..parallel.halo import sharded_map_blocks_z

    psf = jnp.asarray(psf, jnp.float32)
    psf = psf / jnp.sum(psf)
    if halo is None:
        halo = max(1, psf.shape[0] // 2)
    n_sh = mesh.shape[axis_name]
    local_z = vol.shape[0] // n_sh + 2 * halo
    fft_shape = fft_shape_for((local_z,) + vol.shape[1:], psf.shape)

    def local_rl(block_ext):
        # unrolled batched path: the while_loop carry of the single-block
        # path has mixed varying/unvarying types under shard_map
        out = richardson_lucy_batched(block_ext[None], psf, niter=niter,
                                      fft_shape=fft_shape, edge_taper=True,
                                      classic=classic)[0]
        return out

    with mesh:
        return jax.jit(sharded_map_blocks_z(local_rl, mesh, halo,
                                            axis_name))(vol)

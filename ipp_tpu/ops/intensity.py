"""Intensity-domain tile operations: log-normalization, dark subtraction,
flat-field division, bit-depth conversion, bleach correction.

Device equivalents of the reference's per-tile numpy/numexpr math:

- convert_to_8bit / 16bit: pystripe/core.py:397-424 (bit-shift with
  nonzero-below-LSB mapped to 1).
- dark subtraction: pystripe/core.py:1327-1334.
- correct_bleaching (Butterworth low-pass flat): pystripe/core.py:501-566.
- sigmoid / foreground_fraction: pystripe/core.py:569-601.

All functions are shape-polymorphic over leading batch dims and jit-safe.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "log1p_f32",
    "expm1_clip",
    "convert_to_16bit",
    "convert_to_8bit",
    "subtract_dark",
    "apply_flat",
    "sigmoid",
    "foreground_fraction",
    "butter_lowpass_coeffs",
    "filtfilt1",
    "correct_bleaching",
    "hist_match",
]


def log1p_f32(img: jnp.ndarray) -> jnp.ndarray:
    """log1p in float32 (reference log1p_jit, pystripe/core.py:190)."""
    return jnp.log1p(img.astype(jnp.float32))


def expm1_clip(img: jnp.ndarray, dtype) -> jnp.ndarray:
    """expm1 then round/clip back to an integer dtype
    (reference: pystripe/core.py:1149-1158)."""
    img = jnp.expm1(img)
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        info = jnp.iinfo(dtype)
        img = jnp.clip(jnp.rint(img), info.min, info.max)
    return img.astype(dtype)


def convert_to_16bit(img: jnp.ndarray) -> jnp.ndarray:
    """Clip to [0, 65535] and cast (reference: pystripe/core.py:397-400)."""
    return jnp.clip(img, 0, 65535).astype(jnp.uint16)


def convert_to_8bit(img: jnp.ndarray, bit_shift_to_right: int = 8) -> jnp.ndarray:
    """16-bit -> 8-bit with right bit-shift; any nonzero value that would
    round to zero maps to 1 so dim-but-real signal survives
    (reference: pystripe/core.py:402-424)."""
    if not 0 <= bit_shift_to_right < 9:
        raise ValueError("right shift should be between 0 and 8")
    if img.dtype == jnp.uint8:
        return img
    if img.dtype != jnp.uint16:
        img = convert_to_16bit(img)
    lower_bound = jnp.uint16(1 << bit_shift_to_right)
    shifted = img >> bit_shift_to_right
    out = jnp.where((img > 0) & (img < lower_bound), jnp.uint16(1), shifted)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def subtract_dark(img: jnp.ndarray, dark: float) -> jnp.ndarray:
    """img = max(img - dark, 0) (reference: pystripe/core.py:1327-1334)."""
    return jnp.where(img > dark, img - dark, jnp.zeros((), img.dtype))


def apply_flat(img: jnp.ndarray, flat: Optional[jnp.ndarray]) -> jnp.ndarray:
    """Flat-field division (reference: pystripe/core.py:1248-1255)."""
    if flat is None:
        return img
    return img / flat


def sigmoid(x: jnp.ndarray) -> jnp.ndarray:
    """0.5*(tanh(0.5*x)+1) (reference: pystripe/core.py:569-583)."""
    return 0.5 * (jnp.tanh(0.5 * x) + 1.0)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur2d(img: jnp.ndarray, sigma: float, radius: Optional[int] = None,
                    mode: str = "reflect") -> jnp.ndarray:
    """Separable 2D gaussian blur over the last two axes (OpenCV-style
    truncation at ksize = 2*sigma+1 when radius is None, matching the
    GaussianBlur call in foreground_fraction, pystripe/core.py:586-601)."""
    if radius is None:
        radius = int(sigma)
    k = _gaussian_kernel1d(sigma, radius)

    def blur_last(x):
        pad = [(0, 0)] * (x.ndim - 1) + [(radius, radius)]
        xp = jnp.pad(x, pad, mode=mode)
        lhs = xp.reshape(-1, 1, xp.shape[-1])
        rhs = jnp.asarray(k, x.dtype)[None, None, :]
        out = jax.lax.conv_general_dilated(
            lhs, rhs, (1,), "VALID", dimension_numbers=("NCH", "OIH", "NCH"),
            precision=jax.lax.Precision.HIGHEST)
        return out.reshape(x.shape)

    img = blur_last(img)
    img = jnp.swapaxes(blur_last(jnp.swapaxes(img, -1, -2)), -1, -2)
    return img


def foreground_fraction(img: jnp.ndarray, threshold: float, crossover: float,
                        smoothing: int = 1) -> jnp.ndarray:
    """Smooth foreground mask in [0,1] (reference: pystripe/core.py:586-601)."""
    ff = sigmoid((img.astype(jnp.float32) - threshold) / crossover)
    if smoothing and smoothing > 0:
        ff = gaussian_blur2d(ff, float(smoothing))
    return ff


# ---------------------------------------------------------------------------
# First-order Butterworth filtfilt (for bleach correction)
# ---------------------------------------------------------------------------


def butter_lowpass_coeffs(cutoff: float, order: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """First-order Butterworth low-pass (b, a), matching
    scipy.signal.butter(1, cutoff) with fs=2 (normalized Nyquist=1).
    Bilinear transform of H(s)=1/(s+1) with prewarping."""
    if order != 1:
        raise NotImplementedError("reference uses order=1 (pystripe/core.py:496)")
    warped = np.tan(np.pi * cutoff / 2.0)
    b0 = warped / (1.0 + warped)
    b = np.array([b0, b0])
    a = np.array([1.0, (warped - 1.0) / (warped + 1.0)])
    return b, a


def _iir1(x: jnp.ndarray, b0: float, b1: float, a1: float, zi: float) -> jnp.ndarray:
    """First-order IIR y[n] = -a1 y[n-1] + b0 x[n] + b1 x[n-1] along the last
    axis, with scipy-style initial state zi * x[0], solved with an
    associative scan so the recurrence parallelizes on the VPU."""
    xm1 = jnp.concatenate([jnp.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)
    u = b0 * x + b1 * xm1
    u = u.at[..., 0].add(zi * x[..., 0])
    A = jnp.full_like(u, -a1)

    def combine(c1, c2):
        a_1, u_1 = c1
        a_2, u_2 = c2
        return a_1 * a_2, u_2 + a_2 * u_1

    _, y = jax.lax.associative_scan(combine, (A, u), axis=-1)
    return y


def filtfilt1(x: jnp.ndarray, b: np.ndarray, a: np.ndarray) -> jnp.ndarray:
    """Zero-phase first-order filtering along the last axis, equivalent to
    scipy.signal.sosfiltfilt(butter(1, fc, output='sos'), x)
    (reference butter_lowpass_filter, pystripe/core.py:493-499).

    Uses odd extension of length padlen=6 and steady-state initial
    conditions, matching scipy's defaults for a single first-order section.
    """
    b0, b1 = float(b[0]), float(b[1])
    a1 = float(a[1])
    padlen = 6
    n = x.shape[-1]
    if n <= padlen:
        padlen = max(n - 1, 0)
    left = 2 * x[..., :1] - x[..., 1:padlen + 1][..., ::-1]
    right = 2 * x[..., -1:] - x[..., -padlen - 1:-1][..., ::-1]
    ext = jnp.concatenate([left, x, right], axis=-1)
    # lfilter_zi for a first-order section
    zi = (b1 - b0 * a1) / (1.0 + a1)
    y = _iir1(ext, b0, b1, a1, zi)
    y = _iir1(y[..., ::-1], b0, b1, a1, zi)[..., ::-1]
    return y[..., padlen:padlen + n]


def correct_bleaching(img: jnp.ndarray, frequency: float, clip_min: float,
                      clip_med: float, clip_max: float,
                      max_method: bool = False) -> jnp.ndarray:
    """Flat-field style bleach correction on a log1p image
    (reference: pystripe/core.py:501-566).

    Builds a smooth multiplicative flat by Butterworth-low-pass filtering a
    clipped copy of the image (or the outer product of per-axis maxima when
    max_method), then normalizes: img / flat * max(flat).
    """
    clip_min = jnp.maximum(jnp.asarray(clip_min, jnp.float32),
                           jnp.float32(np.log1p(1.0)))
    b, a = butter_lowpass_coeffs(frequency)
    if max_method:
        fy = jnp.max(img, axis=-1)
        fx = jnp.max(img, axis=-2)
        fy = jnp.where(fy == 0, clip_med, fy)
        fx = jnp.where(fx == 0, clip_med, fx)
        fy = jnp.clip(fy, clip_min, clip_max)
        fx = jnp.clip(fx, clip_min, clip_max)
        fy = filtfilt1(fy, b, a)
        fx = filtfilt1(fx, b, a)
        flt = fy[..., :, None] * fx[..., None, :]
    else:
        flt = jnp.where(img == 0, clip_med, img)
        flt = jnp.clip(flt, clip_min, clip_max)
        flt = filtfilt1(flt, b, a)  # scipy default axis=-1
    fmax = jnp.max(flt, axis=(-2, -1), keepdims=True)
    return img / flt * fmax


def hist_match(source: jnp.ndarray, template: jnp.ndarray) -> jnp.ndarray:
    """Histogram matching: map source pixel quantiles onto the template's
    value distribution (reference hist_match, pystripe/core.py:426-463),
    implemented with sorted-array quantile interpolation so it stays
    jittable (equivalent to the reference's unique/cumsum formulation for
    continuous data; ties map to the same value)."""
    shape = source.shape
    s = source.reshape(-1).astype(jnp.float32)
    t = template.reshape(-1).astype(jnp.float32)
    s_sorted = jnp.sort(s)
    t_sorted = jnp.sort(t)
    # right-edge ECDF quantile of each source pixel — identical to the
    # reference's cumsum(s_counts)/N at that pixel's unique value
    ranks = jnp.searchsorted(s_sorted, s, side="right").astype(jnp.float32)
    q = ranks / s.shape[0]
    # template right-edge ECDF sampled at every sorted sample: duplicate
    # (tq, value) pairs collapse onto the tie group's last entry, so
    # jnp.interp(q, tq, t_sorted) reproduces the reference's
    # interp(quantile, t_quantiles, t_values) over UNIQUE template values
    tq = jnp.searchsorted(t_sorted, t_sorted,
                          side="right").astype(jnp.float32) / t.shape[0]
    matched = jnp.interp(q, tq, t_sorted)
    return matched.reshape(shape)

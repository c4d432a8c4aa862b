"""Orthogonal wavelet filter banks and 2D DWT (JAX).

Re-design of the wavelet layer used by the reference destriper
(reference: pystripe/core.py:840-940 uses pywt.wavedec2/waverec2 with
mode='symmetric').  Differences by design:

- Filter banks are *derived*, not vendored: Daubechies filters come from
  spectral factorization of the maximally-flat half-band polynomial, symlets
  from the same roots with a least-phase-nonlinearity selection, and small
  coiflets from the published tables.  (No pywt dependency.)
- The transform runs in **periodization** mode (circular convolution), which
  is exactly invertible, keeps every level's shape static at n/2, and maps to
  polyphase shifted FMAs that XLA fuses.  The reference pads tiles
  generously (wrap mode, pystripe/core.py:1083-1110) before the DWT, so the
  boundary-mode difference lands entirely in padding that is cropped away
  afterwards.  The destripe
  wrapper in :mod:`ipp_tpu.ops.destripe` rounds the pad up so every level
  divides evenly.
- Decompositions are batched: all arrays may carry leading batch dimensions,
  and the whole wavedec2 -> notch -> waverec2 pipeline stays inside one jit.

Coefficient layout matches pywt's convention so downstream code reads the
same way: ``wavedec2`` returns ``[cA_L, (cH_L, cV_L, cD_L), ...,
(cH_1, cV_1, cD_1)]`` where ``cH`` is detail along the -2 axis (y) and
approximation along -1 (x) — the subband containing stripes elongated in x.
"""

from __future__ import annotations

import functools
from math import comb
from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

__all__ = [
    "scaling_filter",
    "filter_bank",
    "dwt_max_level",
    "dwt2",
    "idwt2",
    "wavedec2",
    "waverec2",
]


# ---------------------------------------------------------------------------
# Filter-bank construction (host-side, float64 numpy)
# ---------------------------------------------------------------------------

# Published coiflet scaling filters (Daubechies, "Ten Lectures on Wavelets",
# table 8.1; standard public tables).  Length 6N.  Normalized to sum sqrt(2).
_COIF_TABLE = {
    1: [
        -0.0156557281354645, -0.0727326195128561, 0.3848648468648578,
        0.8525720202122554, 0.3378976624578092, -0.0727326195128561,
    ],
    2: [
        -0.000720549445364512, -0.0018232088707029932, 0.0056114348193944995,
        0.023680171946334084, -0.0594344186464569, -0.0764885990783064,
        0.41700518442169254, 0.8127236354455423, 0.3861100668211622,
        -0.06737255472196302, -0.04146493678175915, 0.016387336463522112,
    ],
    3: [
        -3.459977283621256e-05, -7.098330313814125e-05, 0.0004662169601128863,
        0.0011175187708906016, -0.0025745176887502236, -0.00900797613666158,
        0.015880544863615904, 0.03455502757306163, -0.08230192710688598,
        -0.07179982161931202, 0.42848347637761874, 0.7937772226256206,
        0.4051769024096169, -0.06112339000267287, -0.0657719112818555,
        0.023452696141836267, 0.007782596427325418, -0.003793512864491014,
    ],
    4: [
        -1.7849850030882614e-06, -3.2596802368833675e-06, 3.1229875865345646e-05,
        6.233903446100713e-05, -0.00025997455248771324, -0.0005890207562443383,
        0.0012665619292989445, 0.003751436157278457, -0.00565828668661072,
        -0.015211731527946259, 0.025082261844864097, 0.03933442712333749,
        -0.09622044203398798, -0.06662747426342504, 0.4343860564914685,
        0.782238930920499, 0.41530840703043026, -0.05607731331675481,
        -0.08126669968087875, 0.026682300156053072, 0.016068943964776348,
        -0.0073461663276420935, -0.0016294920126017326, 0.0008923136685823146,
    ],
    5: [
        -9.517657273819165e-08, -1.6744288576823017e-07, 2.0637618513646814e-06,
        3.7346551751414047e-06, -2.1315026809955787e-05, -4.134043227251251e-05,
        0.00014054114970203437, 0.00030225958181306315, -0.0006381313430451114,
        -0.0016628637020130838, 0.0024333732126576722, 0.006764185448053083,
        -0.009164231162481846, -0.01976177894257264, 0.03268357426711183,
        0.0412892087501817, -0.10557420870333893, -0.06203596396290357,
        0.4379916261718371, 0.7742896036529562, 0.4215662066908515,
        -0.05204316317624377, -0.09192001055969624, 0.02816802897093635,
        0.023408156785839195, -0.010131117519849788, -0.004159358781386048,
        0.0021782363581090178, 0.00035858968789573785, -0.00021208083980379827,
    ],
}


def _daub_scaling(p: int) -> np.ndarray:
    """Daubechies-p minimum-phase scaling filter (length 2p, sum sqrt(2)).

    Spectral factorization of the maximally-flat half-band product filter.
    """
    if p < 1:
        raise ValueError("daubechies order must be >= 1")
    if p == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    pcoef = np.array([comb(p - 1 + k, k) for k in range(p)][::-1], dtype=np.float64)
    yroots = np.roots(pcoef)
    zroots = []
    for y in yroots:
        # y = (2 - z - 1/z)/4  =>  z^2 + (4y - 2) z + 1 = 0
        zr = np.roots([1.0, 4.0 * y - 2.0, 1.0])
        zroots.append(zr[np.argmin(np.abs(zr))])  # min-phase root
    poly = np.array([1.0 + 0.0j])
    for _ in range(p):
        poly = np.convolve(poly, [1.0, 1.0])
    for z in zroots:
        poly = np.convolve(poly, [1.0, -z])
    h = np.real(poly)
    return h * np.sqrt(2.0) / h.sum()


def _sym_scaling(p: int) -> np.ndarray:
    """Symlet-p scaling filter: same product-filter roots as db-p, but the
    root subset per conjugate pair is chosen to minimize phase nonlinearity."""
    if p < 2:
        raise ValueError("symlet order must be >= 2")
    pcoef = np.array([comb(p - 1 + k, k) for k in range(p)][::-1], dtype=np.float64)
    yroots = np.roots(pcoef)
    # group y-roots: real roots and conjugate pairs
    reals = [y for y in yroots if abs(y.imag) < 1e-10]
    pairs: List[Tuple[complex, complex]] = []
    used = np.zeros(len(yroots), bool)
    ylist = list(yroots)
    for i, y in enumerate(ylist):
        if used[i] or abs(y.imag) < 1e-10:
            continue
        for j in range(i + 1, len(ylist)):
            if not used[j] and abs(ylist[j] - np.conj(y)) < 1e-8:
                pairs.append((y, ylist[j]))
                used[i] = used[j] = True
                break

    def z_of(y, inside: bool):
        zr = np.roots([1.0, 4.0 * y - 2.0, 1.0])
        order = np.argsort(np.abs(zr))
        return zr[order[0]] if inside else zr[order[1]]

    best = None
    n_pairs = len(pairs)
    for mask in range(1 << n_pairs):
        zroots = [z_of(y, True) for y in reals]
        for b, (y1, y2) in enumerate(pairs):
            inside = not (mask >> b) & 1
            zroots.append(z_of(y1, inside))
            zroots.append(z_of(y2, inside))
        poly = np.array([1.0 + 0.0j])
        for _ in range(p):
            poly = np.convolve(poly, [1.0, 1.0])
        for z in zroots:
            poly = np.convolve(poly, [1.0, -z])
        h = np.real(poly)
        h = h * np.sqrt(2.0) / h.sum()
        # phase-nonlinearity score: deviation of group delay from constant
        w = np.linspace(0.02, np.pi - 0.02, 256)
        H = np.polyval(h[::-1], np.exp(-1j * w))
        phase = np.unwrap(np.angle(H * np.exp(1j * w * (len(h) - 1) / 2)))
        score = np.ptp(phase)
        if best is None or score < best[0]:
            best = (score, h)
    return best[1]


@functools.lru_cache(maxsize=64)
def scaling_filter(name: str) -> np.ndarray:
    """Return the orthogonal scaling (lowpass synthesis) filter for `name`.

    Supported: haar, dbN (1..34), symN (2..20), coifN (1..17 — 1..5 from
    the published tables, 6..17 derived numerically in ops/coif_data.py; the
    reference's process_img default 'coif15' is exact).  coifN>17 maps to
    the nearest symlet.
    """
    name = name.lower().strip()
    if name == "haar":
        return _daub_scaling(1)
    if name.startswith("db"):
        p = int(name[2:])
        if not 1 <= p <= 34:
            raise ValueError(f"unsupported wavelet {name!r}")
        return _daub_scaling(p)
    if name.startswith("sym"):
        p = int(name[3:])
        if not 2 <= p <= 20:
            raise ValueError(f"unsupported wavelet {name!r}")
        return _sym_scaling(p)
    if name.startswith("coif"):
        p = int(name[4:])
        if p in _COIF_TABLE:
            h = np.array(_COIF_TABLE[p], dtype=np.float64)
            return h * np.sqrt(2.0) / h.sum()
        from .coif_data import COIF_HIGH

        if p in COIF_HIGH:
            h = np.array(COIF_HIGH[p], dtype=np.float64)
            return h * np.sqrt(2.0) / h.sum()
        # nearest-symlet fallback beyond the derived orders
        return _sym_scaling(min(max(2 * p, 2), 20))
    raise ValueError(f"unsupported wavelet {name!r}")


@functools.lru_cache(maxsize=64)
def filter_bank(name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(dec_lo, dec_hi, rec_lo, rec_hi), pywt orthogonal convention."""
    h = scaling_filter(name)
    L = len(h)
    rec_lo = h
    rec_hi = np.array([(-1.0) ** k * h[L - 1 - k] for k in range(L)])
    dec_lo = rec_lo[::-1].copy()
    dec_hi = rec_hi[::-1].copy()
    return dec_lo, dec_hi, rec_lo, rec_hi


def dwt_max_level(data_len: int, filter_len_or_wavelet) -> int:
    """Maximum useful decomposition level (pywt formula)."""
    if isinstance(filter_len_or_wavelet, str):
        flen = len(scaling_filter(filter_len_or_wavelet))
    else:
        flen = int(filter_len_or_wavelet)
    if data_len < flen - 1 or flen < 2:
        return 0
    return int(np.floor(np.log2(data_len / (flen - 1.0))))


# ---------------------------------------------------------------------------
# 1D circular DWT primitives (device-side, batched)
# ---------------------------------------------------------------------------


def _circ_ext(x: jnp.ndarray, left: int, right: int) -> jnp.ndarray:
    """x (..., m) circularly extended by `left` / `right` samples (tiny m
    may wrap more than once)."""
    m = x.shape[-1]
    reps = 1 + -(-left // m) + -(-right // m)
    tiled = jnp.concatenate([x] * reps, axis=-1)
    start = (-(-left // m)) * m - left
    return tiled[..., start:start + left + m + right]


def _dwt_last(x: jnp.ndarray, rec_lo: np.ndarray, rec_hi: np.ndarray):
    """1-level circular DWT along the last axis.  Analysis is circular
    correlation with the *reconstruction* filters at even shifts (the
    orthonormal-basis inner products), which makes synthesis its exact
    transpose.

    The phase convention is raw: cA[i] = <x[2i:2i+L], lo>, which sits
    (L-2)/2 coefficients early of pywt's interior grid (pywt places
    coefficient i at input offset 2i - (L-2)).  Integer coefficient
    shifts are harmless to every consumer (the destriper's circular
    notch is shift-equivariant and synthesis is the exact transpose),
    EXCEPT for the downsampling parity when recursing — see
    :func:`_parity_rolls`, which wavedec2/waverec2 use to stay on
    pywt's polyphase branch at level 2+.

    Polyphase form: with xe, xo the even and odd phases of x,
    cA[i] = sum_j lo[2j] xe[i+j] + lo[2j+1] xo[i+j] — shifted FMAs that
    XLA fuses into one elementwise loop (on an H100 the destripe chain
    ran 6.5x faster than as strided single-channel convolutions and 3x
    faster than as circulant matmuls; PERF.md)."""
    L = len(rec_lo)
    J = (L + 1) // 2
    m = x.shape[-1] // 2
    xe = _circ_ext(x[..., 0::2], 0, J - 1)
    xo = _circ_ext(x[..., 1::2], 0, J - 1)
    ca = cd = 0.0
    for j in range(J):
        e = xe[..., j:j + m]
        ca = ca + float(rec_lo[2 * j]) * e
        cd = cd + float(rec_hi[2 * j]) * e
        if 2 * j + 1 < L:
            o = xo[..., j:j + m]
            ca = ca + float(rec_lo[2 * j + 1]) * o
            cd = cd + float(rec_hi[2 * j + 1]) * o
    return ca, cd


def _idwt_last(cA: jnp.ndarray, cD: jnp.ndarray, rec_lo: np.ndarray,
               rec_hi: np.ndarray):
    """Synthesis, the exact transpose of :func:`_dwt_last`:
    y[2i] = sum_j lo[2j] cA[i-j] + hi[2j] cD[i-j], y[2i+1] likewise with
    the odd taps."""
    L = len(rec_lo)
    J = (L + 1) // 2
    m = cA.shape[-1]
    ea = _circ_ext(cA, J - 1, 0)
    ed = _circ_ext(cD, J - 1, 0)
    ye = yo = 0.0
    for j in range(J):
        a = ea[..., J - 1 - j:J - 1 - j + m]
        d = ed[..., J - 1 - j:J - 1 - j + m]
        ye = ye + float(rec_lo[2 * j]) * a + float(rec_hi[2 * j]) * d
        if 2 * j + 1 < L:
            yo = (yo + float(rec_lo[2 * j + 1]) * a
                  + float(rec_hi[2 * j + 1]) * d)
    return jnp.stack([ye, yo], axis=-1).reshape(*cA.shape[:-1], 2 * m)


# ---------------------------------------------------------------------------
# 2D transforms
# ---------------------------------------------------------------------------


def dwt2(img: jnp.ndarray, wavelet: str, axes: Tuple[int, int] = (-2, -1)):
    """One 2D DWT level: returns (cA, (cH, cV, cD)) with pywt meaning:
    cH = detail along axes[0], approx along axes[1]."""
    _, _, rec_lo, rec_hi = filter_bank(wavelet)
    return _dwt2_once(img, rec_lo, rec_hi, axes)


def _dwt2_once(img, rec_lo, rec_hi, axes):
    ax0, ax1 = axes
    x = jnp.moveaxis(img, ax1, -1)
    a1, d1 = _dwt_last(x, rec_lo, rec_hi)
    a1 = jnp.moveaxis(a1, -1, ax1)
    d1 = jnp.moveaxis(d1, -1, ax1)
    a1 = jnp.moveaxis(a1, ax0, -1)
    d1 = jnp.moveaxis(d1, ax0, -1)
    aa, da = _dwt_last(a1, rec_lo, rec_hi)
    ad, dd = _dwt_last(d1, rec_lo, rec_hi)
    aa = jnp.moveaxis(aa, -1, ax0)
    da = jnp.moveaxis(da, -1, ax0)
    ad = jnp.moveaxis(ad, -1, ax0)
    dd = jnp.moveaxis(dd, -1, ax0)
    return aa, (da, ad, dd)


def _idwt2_once(cA, details, rec_lo, rec_hi, axes):
    da, ad, dd = details
    ax0, ax1 = axes
    aa = jnp.moveaxis(cA, ax0, -1)
    da_ = jnp.moveaxis(da, ax0, -1)
    ad_ = jnp.moveaxis(ad, ax0, -1)
    dd_ = jnp.moveaxis(dd, ax0, -1)
    a1 = _idwt_last(aa, da_, rec_lo, rec_hi)
    d1 = _idwt_last(ad_, dd_, rec_lo, rec_hi)
    a1 = jnp.moveaxis(a1, -1, ax0)
    d1 = jnp.moveaxis(d1, -1, ax0)
    a1 = jnp.moveaxis(a1, ax1, -1)
    d1 = jnp.moveaxis(d1, ax1, -1)
    x = _idwt_last(a1, d1, rec_lo, rec_hi)
    return jnp.moveaxis(x, -1, ax1)


def _parity_rolls(filter_len: int, level: int) -> List[bool]:
    """Whether to roll cA by +1 (per transformed axis) before decomposing at
    each level 1..level (level 1 is always False).

    The raw grid sits s = (L-2)/2 coefficients early of pywt's symmetric-mode
    interior grid.  When the accumulated offset t is odd, recursing on the
    raw cA would decompose the OPPOSITE polyphase branch from pywt —
    genuinely different subbands, not a relabeling (measured: db4 level-2 cH
    matches pywt at NO integer shift, 0.59 mean abs err on 0.35-rms
    coefficients; tests/test_golden_destripe.py pins the shipped behavior).
    A single +1 roll restores even offset; the residual even shift is
    harmless (the notch is circular-shift-equivariant, synthesis is the
    exact transpose).  For db9/sym8-class filters (s even) every t stays
    even and no rolls are ever emitted — the destripe hot path is unchanged.
    """
    s = (filter_len - 2) // 2
    rolls = [False]
    t = s
    for _ in range(1, level):
        r = bool(t & 1)
        rolls.append(r)
        t = (t - int(r)) // 2 + s
    return rolls


def wavedec2(img: jnp.ndarray, wavelet: str, level: int,
             axes: Tuple[int, int] = (-2, -1)):
    """Multi-level 2D DWT (periodization).  Both transformed axis lengths must
    be divisible by 2**level.  Returns [cA_L, (cH,cV,cD)_L, ..., (cH,cV,cD)_1]
    (coarse -> fine, pywt layout; reference consumer: pystripe/core.py:927-939).
    Level-2+ decompositions follow pywt's polyphase branch (_parity_rolls).
    """
    _, _, rec_lo, rec_hi = filter_bank(wavelet)
    for ax in axes:
        n = img.shape[ax]
        if n % (1 << level):
            raise ValueError(
                f"axis {ax} length {n} not divisible by 2**{level}; pad first")
    rolls = _parity_rolls(len(rec_lo), level)
    coeffs: List = []
    a = img
    for lv in range(level):
        if rolls[lv]:
            for ax in axes:
                a = jnp.roll(a, 1, axis=ax)
        a, det = _dwt2_once(a, rec_lo, rec_hi, axes)
        coeffs.append(det)
    return [a] + coeffs[::-1]


def waverec2(coeffs: Sequence, wavelet: str, axes: Tuple[int, int] = (-2, -1)):
    """Inverse of :func:`wavedec2`."""
    _, _, rec_lo, rec_hi = filter_bank(wavelet)
    level = len(coeffs) - 1
    rolls = _parity_rolls(len(rec_lo), level)
    a = coeffs[0]
    for i, det in enumerate(coeffs[1:]):
        a = _idwt2_once(a, det, rec_lo, rec_hi, axes)
        if rolls[level - 1 - i]:
            for ax in axes:
                a = jnp.roll(a, -1, axis=ax)
    return a


def idwt2(cA, details, wavelet: str, axes: Tuple[int, int] = (-2, -1)):
    _, _, rec_lo, rec_hi = filter_bank(wavelet)
    return _idwt2_once(cA, details, rec_lo, rec_hi, axes)

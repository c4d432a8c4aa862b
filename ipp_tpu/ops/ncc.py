"""MIP-NCC pairwise tile alignment — batched all-shifts NCC maps on device.

Re-design of TeraStitcher's crossmips library
(reference: src/crossmips/libcrossmips.cpp:101-516,
compute_funcs.cu:419-630 CPU / 674-950 CUDA):

The reference evaluates one NCC value per candidate shift in a doubly-nested
loop (O(search^2) passes over the MIP pair, with an incremental
tiled-partial-sum optimization).  Here the *entire* map — including the
wRangeThr-extended neighborhood the reference computes lazily during peak
refinement (compute_Neighborhood, compute_funcs.cu:1324-1594) — comes out of
one batched computation:

- cross terms for every shift at once via rFFT cross-correlation,
- per-shift windowed sums / sums-of-squares via 2D inclusive prefix sums
  (integral images) gathered at the 4 window corners,
- the exact NCC formula of compute_NCC (compute_funcs.cu: means subtracted
  per overlap window) — verified against a direct numpy port in tests.

Peak/width/fusion logic (tiny data) runs host-side in float64, reproducing:
- compute_NCC_width (compute_funcs.cu:1131-1253): walk from the peak until
  NCC <= widthThr * peak, with the slope-projection fallback,
- compute_NCC_alignment (compute_funcs.cu:1597-1680): per-axis fusion of the
  two candidate displacements (NCC-weighted mean if they agree within the
  minimum width, else best peak/width ratio),
- the final nominal-offset addition (libcrossmips.cpp:483-488:
  coord[V] += ni for NORTH_SOUTH, coord[H] += nj for WEST_EAST).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "NCCParams",
    "NCCResult",
    "compute_mips",
    "ncc_maps_batched",
    "ncc_map",
    "peak_and_widths",
    "fuse_axis",
    "align_pair",
    "align_pairs_batched",
]

# reference defaults (PDAlgoMIPNCC.cpp:80-94, S_config.h)
S_NCC_WIDTH_MAX = 100
S_NCC_PEAK_MIN = 0.0


@dataclass
class NCCParams:
    """Mirror of NCC_parms_t (crossmips/CrossMIPs.h:58-86) with the
    PDAlgoMIPNCC defaults."""

    max_thr: float = 0.10
    width_thr: float = 0.80
    min_points: int = 3
    min_dim_ncc_src: int = 25
    min_dim_ncc_map: int = 3
    unr_ncc: float = S_NCC_PEAK_MIN
    inv_coord: int = 0

    def w_range(self, delay: int) -> int:
        return min(delay, S_NCC_WIDTH_MAX - 1)

    def inf_w(self, delays: Tuple[int, int, int]) -> int:
        return max(self.w_range(d) for d in delays) + 1


@dataclass
class NCCResult:
    """Mirror of NCC_descr_t (CrossMIPs.h:47-56): per-axis (V,H,D)
    displacement, NCC peak, and peak width."""

    coord: Tuple[int, int, int]
    ncc_peak: Tuple[float, float, float]
    ncc_width: Tuple[int, int, int]


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------


@jax.jit
def compute_mips(vol: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Three maximum-intensity projections of a (..., D, V, H) overlap volume
    (reference compute_3_MIPs, crossmips: MIP_xy (V,H), MIP_xz (V,D),
    MIP_yz (H,D))."""
    mip_xy = jnp.max(vol, axis=-3)                 # (V, H)
    mip_xz = jnp.max(vol, axis=-1)                 # (D, V) -> want (V, D)
    mip_xz = jnp.swapaxes(mip_xz, -1, -2)
    mip_yz = jnp.max(vol, axis=-2)                 # (D, H) -> want (H, D)
    mip_yz = jnp.swapaxes(mip_yz, -1, -2)
    return mip_xy, mip_xz, mip_yz


def _corner_sums(ii: jnp.ndarray, r0, r1, c0, c1) -> jnp.ndarray:
    """Rectangle sums [r0:r1, c0:c1) from an inclusive 2D prefix sum padded
    with a leading zero row/col.  r0/r1/c0/c1 are integer index arrays
    broadcastable to the output shape."""
    return (ii[..., r1, c1] - ii[..., r0, c1] - ii[..., r1, c0]
            + ii[..., r0, c0])


def _corner_sums_sep(ii: jnp.ndarray, r0, r1, c0, c1) -> jnp.ndarray:
    """_corner_sums for SEPARABLE row/col index VECTORS (rows a function
    of u only, cols of v only): each corner is take(rows) ∘ take(cols),
    avoiding a 2D advanced-index gather (see ncc_maps_batched)."""
    def take2(rvec, cvec):
        return jnp.take(jnp.take(ii, rvec, axis=-2), cvec, axis=-1)

    return take2(r1, c1) - take2(r0, c1) - take2(r1, c0) + take2(r0, c0)


def _prefix2d(x: jnp.ndarray) -> jnp.ndarray:
    p = jnp.cumsum(jnp.cumsum(x, axis=-1), axis=-2)
    p = jnp.pad(p, [(0, 0)] * (x.ndim - 2) + [(1, 0), (1, 0)])
    return p


@partial(jax.jit, static_argnames=("du", "dv"))
def ncc_maps_batched(m1: jnp.ndarray, m2: jnp.ndarray, du: int, dv: int) -> jnp.ndarray:
    """All-shifts NCC maps for batched MIP pairs.

    m1, m2: (B, U, V) float32.  Returns (B, 2*du+1, 2*dv+1) float32 where
    out[b, du+u, dv+v] = NCC over the overlap of m1 shifted by (+u,+v)
    against m2 — identical math to compute_NCC (compute_funcs.cu), all
    shifts at once.
    """
    if m1.ndim == 2:
        m1 = m1[None]
        m2 = m2[None]
    B, U, V = m1.shape
    # condition: NCC is invariant to per-image affine rescale; remove the
    # global mean so f32 accumulations don't cancel catastrophically
    m1 = m1 - jnp.mean(m1, axis=(-2, -1), keepdims=True)
    m2 = m2 - jnp.mean(m2, axis=(-2, -1), keepdims=True)
    scale1 = jnp.maximum(jnp.std(m1, axis=(-2, -1), keepdims=True), 1e-30)
    scale2 = jnp.maximum(jnp.std(m2, axis=(-2, -1), keepdims=True), 1e-30)
    m1 = m1 / scale1
    m2 = m2 / scale2

    # cross-correlation for every lag via rFFT (fast-composite sizes: XLA
    # FFTs with large-prime lengths are slow to compile and run)
    from .fftutil import next_fast_len

    P = next_fast_len(U + du)
    Q = next_fast_len(V + dv)
    f1 = jnp.fft.rfft2(m1, s=(P, Q))
    f2 = jnp.fft.rfft2(m2, s=(P, Q))
    corr = jnp.fft.irfft2(f1 * jnp.conj(f2), s=(P, Q))
    # corr[u mod P, v mod Q] = sum_t m1[t+u] m2[t].  Separable row/col
    # takes, NOT corr[:, u_idx[:, None], v_idx[None, :]] (see the
    # corner-sums note below)
    u_idx = jnp.arange(-du, du + 1) % P
    v_idx = jnp.arange(-dv, dv + 1) % Q
    cross = jnp.take(jnp.take(corr, u_idx, axis=-2), v_idx, axis=-1)

    # windowed sums via integral images.  The corner indices are
    # SEPARABLE (rows depend only on u, cols only on v), so each corner
    # term is two 1-D takes (row take = contiguous DMA; the col take
    # runs on the already-tiny row slab) instead of one 2D
    # advanced-index gather, which XLA lowers element by element; keep
    # the takes separable (tests/test_ncc.py pins the production MIP
    # shape (12, 150, 1024) against the reference formula).
    ii1 = _prefix2d(m1)
    ii2 = _prefix2d(m2)
    ii1sq = _prefix2d(m1 * m1)
    ii2sq = _prefix2d(m2 * m2)
    uu = jnp.arange(-du, du + 1)
    vv = jnp.arange(-dv, dv + 1)
    u = uu[:, None]
    v = vv[None, :]
    # m1 window rows [max(0,u), U+min(0,u)), cols [max(0,v), V+min(0,v))
    r0a, r1a = jnp.maximum(0, uu), U + jnp.minimum(0, uu)
    c0a, c1a = jnp.maximum(0, vv), V + jnp.minimum(0, vv)
    # m2 window: mirrored shift
    r0b, r1b = jnp.maximum(0, -uu), U + jnp.minimum(0, -uu)
    c0b, c1b = jnp.maximum(0, -vv), V + jnp.minimum(0, -vv)

    s1 = _corner_sums_sep(ii1, r0a, r1a, c0a, c1a)
    s2 = _corner_sums_sep(ii2, r0b, r1b, c0b, c1b)
    q1 = _corner_sums_sep(ii1sq, r0a, r1a, c0a, c1a)
    q2 = _corner_sums_sep(ii2sq, r0b, r1b, c0b, c1b)
    n = ((U - jnp.abs(u)) * (V - jnp.abs(v))).astype(m1.dtype)

    num = cross - s1 * s2 / n
    var1 = jnp.maximum(q1 - s1 * s1 / n, 0.0)
    var2 = jnp.maximum(q2 - s2 * s2 / n, 0.0)
    den = jnp.sqrt(var1 * var2)
    return jnp.where(den > 1e-12, num / den, 0.0)


def ncc_map(m1: jnp.ndarray, m2: jnp.ndarray, du: int, dv: int) -> np.ndarray:
    """Single-pair convenience wrapper returning numpy float64."""
    out = ncc_maps_batched(m1[None], m2[None], du, dv)
    return np.asarray(out[0], dtype=np.float64)


# ---------------------------------------------------------------------------
# Host-side peak, width and fusion (numpy float64, tiny data)
# ---------------------------------------------------------------------------


def _width_1d(profile: np.ndarray, center: int, w_range: int, thr: float,
              min_points: int, inf_w: int) -> int:
    """Peak width along one direction of an NCC map cross-section
    (reference compute_NCC_width, compute_funcs.cu:1131-1253)."""

    def side_width(step: int) -> Tuple[bool, int]:
        w = 1
        while w <= w_range:
            idx = center + step * w
            if idx < 0 or idx >= len(profile) or profile[idx] <= thr:
                return True, w
            w += 1
        return False, w

    found_lo, w_lo = side_width(-1)
    if found_lo:
        found_hi, w_hi = side_width(+1)
        w = max(w_lo, w_hi) if found_hi else w_lo
        # the reference continues the walk from w_lo: total width is the walk
        # position when either side hits the threshold
        if found_hi:
            return max(w_lo, w_hi)
        # fall through to slope fallback for the high side only: the
        # reference merges both estimates; approximate with slope fallback
    # slope-projection fallback: find where the profile stops decreasing
    peak = profile[center]

    def slope_width(step: int) -> int:
        if center + step * min_points < 0 or center + step * min_points >= len(profile):
            return inf_w
        prev = profile[center + step * min_points]
        dist = min_points + 1
        while dist <= w_range:
            idx = center + step * dist
            if idx < 0 or idx >= len(profile):
                break
            if profile[idx] >= prev:
                break
            prev = profile[idx]
            dist += 1
        if dist < 2 * min_points:
            return inf_w
        if peak - prev <= 0:
            return inf_w
        return int(math.floor((dist - 1) * (peak - thr) / (peak - prev)))

    w_minus = slope_width(-1)
    w_plus = slope_width(+1)
    w = max(w_minus, w_plus)
    return min(w, inf_w - 1) if w < inf_w else inf_w


def peak_and_widths(ncc: np.ndarray, delay_u: int, delay_v: int,
                    w_range_u: int, w_range_v: int,
                    params: NCCParams,
                    inf_w: Optional[int] = None
                    ) -> Tuple[int, int, float, int, int]:
    """Find the map peak (search restricted to the central +-delay window of
    a wRange-extended map) and per-direction widths at that peak.

    ncc: ((2*(delay_u+w_range_u)+1), (2*(delay_v+w_range_v)+1)) map.
    Returns (du, dv, peak, width_u, width_v).

    inf_w is the LINK-GLOBAL infinite width (reference
    PDAlgoMIPNCC.cpp:92: max over all THREE unclamped search radii + 1,
    one value shared by every map of the link).  A per-map fallback is
    kept for standalone callers, but the align paths must pass the
    global one: a clamped-to-zero axis (thin-z stacks) otherwise gets a
    per-map "infinity" BELOW the global inf_w that fusion compares
    against, and an axis the reference rejects as unreliable would fuse
    as a real width (caught by the terastitcher-binary parity fuzz)."""
    eu = delay_u + w_range_u
    ev = delay_v + w_range_v
    if inf_w is None:
        inf_w = max(w_range_u, w_range_v) + 1
    # peak over the central search window (reference searches the original
    # (2*delay+1)^2 map first: libcrossmips.cpp:408-410)
    central = ncc[eu - delay_u: eu + delay_u + 1,
                  ev - delay_v: ev + delay_v + 1]
    ind = int(np.argmax(central))
    pu = ind // central.shape[1] - delay_u
    pv = ind % central.shape[1] - delay_v
    # one refinement pass over the extended neighborhood around the peak
    # (reference compute_Neighborhood iterates maxIter=2 times)
    lo_u = max(-eu, pu - w_range_u)
    hi_u = min(eu, pu + w_range_u)
    lo_v = max(-ev, pv - w_range_v)
    hi_v = min(ev, pv + w_range_v)
    nb = ncc[eu + lo_u: eu + hi_u + 1, ev + lo_v: ev + hi_v + 1]
    ind = int(np.argmax(nb))
    pu = lo_u + ind // nb.shape[1]
    pv = lo_v + ind % nb.shape[1]
    peak = float(ncc[eu + pu, ev + pv])
    thr = params.width_thr * peak

    if 2 * delay_v + 1 < params.min_dim_ncc_map or w_range_v < params.min_dim_ncc_map:
        width_v = inf_w
    else:
        row = ncc[eu + pu, :]
        width_v = _width_1d(row, ev + pv, w_range_v, thr, params.min_points, inf_w)
    if 2 * delay_u + 1 < params.min_dim_ncc_map or w_range_u < params.min_dim_ncc_map:
        width_u = inf_w
    else:
        col = ncc[:, ev + pv]
        width_u = _width_1d(col, eu + pu, w_range_u, thr, params.min_points, inf_w)
    return pu, pv, peak, width_u, width_v


def fuse_axis(d1: int, peak1: float, width1: int, d2: int, peak2: float,
              width2: int, params: NCCParams, inf_w: int
              ) -> Tuple[int, float, int]:
    """Fuse the two per-axis candidates (each axis appears in two NCC maps)
    (reference compute_NCC_alignment, compute_funcs.cu:1597-1680)."""
    if width1 == 1:
        width1 = inf_w
    if width2 == 1:
        width2 = inf_w
    ok1 = peak1 >= params.max_thr and width1 < inf_w
    ok2 = peak2 >= params.max_thr and width2 < inf_w
    if ok1 and ok2:
        if abs(d1 - d2) < min(width1, width2):
            coord = int(math.floor((peak1 * d1 + peak2 * d2) / (peak1 + peak2) + 0.5))
            peak = (peak1 * peak1 + peak2 * peak2) / (peak1 + peak2)
            return coord, peak, max(width1, width2)
        if peak1 / width1 > peak2 / width2:
            return d1, peak1, width1
        return d2, peak2, width2
    if ok1:
        return d1, peak1, width1
    if ok2:
        return d2, peak2, width2
    return params.inv_coord, params.unr_ncc, inf_w


def _ncc_maps_sharded(ma: np.ndarray, mb: np.ndarray, du: int, dv: int,
                      mesh, defer: bool = False):
    """ncc_maps_batched with the pair-batch axis sharded over the mesh's
    'data' axis (the device-mesh replacement for Parastitcher's
    rank-per-pair MPI step 2, pyscripts/Parastitcher.py:410-470): the
    batch pads to a 'data' multiple, inputs are device_put with a
    NamedSharding, and GSPMD partitions the (embarrassingly batch-
    parallel) map computation across devices.

    With defer=True returns a zero-arg fetcher instead of the array:
    the upload+dispatch happens NOW (and a copy_to_host_async kick), the
    blocking device->host fetch happens when the fetcher is called — so
    a caller can dispatch several map computations back-to-back and let
    their round trips overlap instead of paying serial chains (the
    multi-process path stays synchronous: collective ordering must be
    identical on every host)."""
    from ..utils import iostat

    def _deferred_single(out_dev, B):
        try:
            out_dev.copy_to_host_async()
        except Exception:  # noqa: BLE001 — backend without async copy
            pass

        def fetch():
            with iostat.span("device_ncc"):  # fetch wait
                return np.asarray(out_dev, np.float64)[:B]
        return fetch

    n_data = int(mesh.shape["data"]) if mesh is not None else 1
    if n_data <= 1:
        with iostat.span("device_ncc", ma.nbytes + mb.nbytes):
            out_dev = ncc_maps_batched(jnp.asarray(ma), jnp.asarray(mb),
                                       du, dv)
        if defer:
            return _deferred_single(out_dev, ma.shape[0])
        with iostat.span("device_ncc"):
            return np.asarray(out_dev, np.float64)
    B = ma.shape[0]
    pad = (-B) % n_data
    if pad:
        ma = np.concatenate([ma, np.repeat(ma[-1:], pad, axis=0)])
        mb = np.concatenate([mb, np.repeat(mb[-1:], pad, axis=0)])
    from ..parallel.mesh import data_sharding

    sh = data_sharding(mesh, 3)
    if jax.process_count() > 1:
        # multi-process (the actual Parastitcher rank fan-out): each
        # process reads the same logical batch and contributes its
        # contiguous row block; maps come back to every host via
        # process_allgather (tiny vs the MIP inputs)
        from ..parallel.distributed import device_put_global, process_slice

        lo, hi = process_slice(ma.shape[0])
        ma_d = device_put_global(np.ascontiguousarray(ma[lo:hi]), sh)
        mb_d = device_put_global(np.ascontiguousarray(mb[lo:hi]), sh)
        out_dev = ncc_maps_batched(ma_d, mb_d, du, dv)
        from jax.experimental import multihost_utils

        out = np.asarray(
            multihost_utils.process_allgather(out_dev, tiled=True),
            np.float64)
    else:
        with iostat.span("device_ncc", ma.nbytes + mb.nbytes):
            ma_d = jax.device_put(jnp.asarray(ma), sh)
            mb_d = jax.device_put(jnp.asarray(mb), sh)
            out_dev = ncc_maps_batched(ma_d, mb_d, du, dv)
        if defer:
            return _deferred_single(out_dev, B)
        with iostat.span("device_ncc"):
            out = np.asarray(out_dev, np.float64)
    if defer:  # multi-process path computed synchronously above
        return lambda: out[:B]
    return out[:B]


def align_pairs_batched(vols_a: np.ndarray, vols_b: np.ndarray, side: str,
                        overlap: int, delay_v: int, delay_h: int,
                        delay_d: int, params: Optional[NCCParams] = None,
                        mesh=None, _defer: bool = False):
    """Align a BATCH of same-shape pairs in three device calls total.

    vols_a/vols_b: (P, D, V, H).  The three NCC map kinds are each computed
    for every pair in one `ncc_maps_batched` call (the per-pair host loop
    only does the tiny peak/width/fusion math) — this amortizes dispatch
    and device round trips across all pairs of a z-chunk (the
    MPI-rank-per-pair structure of Parastitcher collapses into batched
    executables).  With a multi-device `mesh`, the pair batch
    additionally shards over the mesh's 'data' axis (the MPI-ranks role).

    Returns a list of NCCResult, one per pair.
    """
    params = params or NCCParams()
    assert vols_a.shape == vols_b.shape and vols_a.ndim == 4
    P, dimk, dimi, dimj = vols_a.shape
    nk = ni = nj = 0
    if side == "ns":
        ni = dimi - overlap
        a = vols_a[:, :, ni:, :]
        b = vols_b[:, :, : dimi - ni, :]
    elif side == "we":
        nj = dimj - overlap
        a = vols_a[:, :, :, nj:]
        b = vols_b[:, :, :, : dimj - nj]
    elif side == "tb":
        nk = dimk - overlap
        a = vols_a[:, nk:, :, :]
        b = vols_b[:, : dimk - nk, :, :]
    else:
        raise ValueError("side must be 'ns', 'we' or 'tb'")
    dimk_v, dimi_v, dimj_v = a.shape[1], a.shape[2], a.shape[3]
    # the link-global infinite width comes from the UNCLAMPED radii
    # (reference PDAlgoMIPNCC.cpp:87-92 computes INF_W before
    # libcrossmips clamps the delays against the overlap extents)
    inf_w = params.inf_w((delay_v, delay_h, delay_d))
    delay_v = min(delay_v, max(0, dimi_v - params.min_dim_ncc_src))
    delay_h = min(delay_h, max(0, dimj_v - params.min_dim_ncc_src))
    delay_d = min(delay_d, max(0, dimk_v - params.min_dim_ncc_src))
    wr_v = params.w_range(delay_v)
    wr_h = params.w_range(delay_h)
    wr_d = params.w_range(delay_d)

    # MIPs on the host: uploading 3 projections per pair moves ~250x less
    # data than uploading the raw overlap volumes (the NCC math is the
    # device-worthy part; a max-reduce is memory-bound either way and the
    # volumes are already in host RAM from the tile reads).  The reduce
    # runs on the NATIVE (u16) dtype — only the tiny MIPs are cast to
    # f32, halving the dominant host traffic of the align stage.
    def host_mips(v):
        return (np.max(v, axis=1).astype(np.float32, copy=False),
                np.ascontiguousarray(
                    np.swapaxes(np.max(v, axis=3), 1, 2),
                    dtype=np.float32),
                np.ascontiguousarray(
                    np.swapaxes(np.max(v, axis=2), 1, 2),
                    dtype=np.float32))

    mips_a = host_mips(a)
    mips_b = host_mips(b)
    # dispatch all three map kinds back-to-back (deferred fetchers), THEN
    # fetch: the three device->host round trips overlap instead of
    # chaining serially — and with _defer=True the caller can stack the
    # dispatches of SEVERAL pair groups the same way (a 2-chunk 5x5 grid
    # has 12 chains)
    fetch_xy = _ncc_maps_sharded(
        mips_a[0], mips_b[0], delay_v + wr_v, delay_h + wr_h, mesh,
        defer=True)
    fetch_xz = _ncc_maps_sharded(
        mips_a[1], mips_b[1], delay_v + wr_v, delay_d + wr_d, mesh,
        defer=True)
    fetch_yz = _ncc_maps_sharded(
        mips_a[2], mips_b[2], delay_h + wr_h, delay_d + wr_d, mesh,
        defer=True)

    def finalize():
        return _finalize_pairs(
            fetch_xy(), fetch_xz(), fetch_yz(), P, side, ni, nj, nk,
            delay_v, delay_h, delay_d, wr_v, wr_h, wr_d, inf_w, params)

    if _defer:
        return finalize
    return finalize()


def _finalize_pairs(ncc_xy, ncc_xz, ncc_yz, P, side, ni, nj, nk,
                    delay_v, delay_h, delay_d, wr_v, wr_h, wr_d, inf_w,
                    params):
    """Host-side peak/width/fusion over fetched NCC maps (tiny data)."""
    failed_xy = delay_v == 0 and delay_h == 0
    failed_xz = delay_v == 0 and delay_d == 0
    failed_yz = delay_h == 0 and delay_d == 0
    results = []
    for p_i in range(P):
        if failed_xy:
            dv1 = dh1 = 0
            pk_xy, wv1, wh1 = params.unr_ncc, inf_w, inf_w
        else:
            dv1, dh1, pk_xy, wv1, wh1 = peak_and_widths(
                ncc_xy[p_i], delay_v, delay_h, wr_v, wr_h, params,
                inf_w=inf_w)
        if failed_xz:
            dv2 = dd1 = 0
            pk_xz, wv2, wd1 = params.unr_ncc, inf_w, inf_w
        else:
            dv2, dd1, pk_xz, wv2, wd1 = peak_and_widths(
                ncc_xz[p_i], delay_v, delay_d, wr_v, wr_d, params,
                inf_w=inf_w)
        if failed_yz:
            dh2 = dd2 = 0
            pk_yz, wh2, wd2 = params.unr_ncc, inf_w, inf_w
        else:
            dh2, dd2, pk_yz, wh2, wd2 = peak_and_widths(
                ncc_yz[p_i], delay_h, delay_d, wr_h, wr_d, params,
                inf_w=inf_w)
        cv, pv, wv = fuse_axis(dv1, pk_xy, wv1, dv2, pk_xz, wv2, params, inf_w)
        ch, ph, wh = fuse_axis(dh1, pk_xy, wh1, dh2, pk_yz, wh2, params, inf_w)
        cd, pd, wd = fuse_axis(dd1, pk_xz, wd1, dd2, pk_yz, wd2, params, inf_w)
        if side == "ns":
            cv += ni
        elif side == "we":
            ch += nj
        else:
            cd += nk
        results.append(NCCResult(coord=(cv, ch, cd), ncc_peak=(pv, ph, pd),
                                 ncc_width=(wv, wh, wd)))
    return results


def align_pair(vol_a: np.ndarray, vol_b: np.ndarray, side: str,
               overlap: int, delay_v: int, delay_h: int, delay_d: int,
               params: Optional[NCCParams] = None) -> NCCResult:
    """Full pairwise alignment of two equal-shape (D, V, H) stacks
    (reference norm_cross_corr_mips, libcrossmips.cpp:101-516).

    side: 'ns' (B is SOUTH of A), 'we' (B is EAST of A), or 'tb'
    (B is BELOW A in z — the piezo-stack case of tsv/scan.py align_stack_z).
    Returns per-axis (V, H, D) coord / peak / width, where coord includes the
    nominal offset (coord[V] += dimV - overlap for 'ns', analogs for the
    other sides).
    """
    params = params or NCCParams()
    assert vol_a.shape == vol_b.shape
    dimk, dimi, dimj = vol_a.shape
    nk = 0
    if side == "ns":
        ni, nj = dimi - overlap, 0
        a = vol_a[:, ni:, :]
        b = vol_b[:, : dimi - ni, :]
    elif side == "we":
        ni, nj = 0, dimj - overlap
        a = vol_a[:, :, nj:]
        b = vol_b[:, :, : dimj - nj]
    elif side == "tb":
        ni = nj = 0
        nk = dimk - overlap
        a = vol_a[nk:, :, :]
        b = vol_b[: dimk - nk, :, :]
    else:
        raise ValueError("side must be 'ns', 'we' or 'tb'")
    dimi_v, dimj_v = a.shape[1], a.shape[2]

    # clamp the search when overlap is too small (libcrossmips.cpp:260-262);
    # the link-global infinite width uses the UNCLAMPED radii
    # (reference PDAlgoMIPNCC.cpp:87-92)
    dimk_v = a.shape[0]
    inf_w = params.inf_w((delay_v, delay_h, delay_d))
    delay_v = min(delay_v, max(0, dimi_v - params.min_dim_ncc_src))
    delay_h = min(delay_h, max(0, dimj_v - params.min_dim_ncc_src))
    delay_d = min(delay_d, max(0, dimk_v - params.min_dim_ncc_src))
    wr_v = params.w_range(delay_v)
    wr_h = params.w_range(delay_h)
    wr_d = params.w_range(delay_d)

    a_j = jnp.asarray(a, jnp.float32)
    b_j = jnp.asarray(b, jnp.float32)
    mips_a = compute_mips(a_j)
    mips_b = compute_mips(b_j)

    # extended maps: search window + wRange margin so width walks and the
    # refinement pass never leave the map
    def emap(ma, mb, d_u, d_v, w_u, w_v):
        return np.asarray(
            ncc_maps_batched(ma[None], mb[None], d_u + w_u, d_v + w_v)[0],
            dtype=np.float64)

    failed_xy = delay_v == 0 and delay_h == 0
    failed_xz = delay_v == 0 and delay_d == 0
    failed_yz = delay_h == 0 and delay_d == 0

    ncc_xy = emap(mips_a[0], mips_b[0], delay_v, delay_h, wr_v, wr_h)
    ncc_xz = emap(mips_a[1], mips_b[1], delay_v, delay_d, wr_v, wr_d)
    ncc_yz = emap(mips_a[2], mips_b[2], delay_h, delay_d, wr_h, wr_d)

    if failed_xy:
        dv1 = dh1 = 0
        pk_xy, wv1, wh1 = params.unr_ncc, inf_w, inf_w
    else:
        dv1, dh1, pk_xy, wv1, wh1 = peak_and_widths(
            ncc_xy, delay_v, delay_h, wr_v, wr_h, params, inf_w=inf_w)
    if failed_xz:
        dv2 = dd1 = 0
        pk_xz, wv2, wd1 = params.unr_ncc, inf_w, inf_w
    else:
        dv2, dd1, pk_xz, wv2, wd1 = peak_and_widths(
            ncc_xz, delay_v, delay_d, wr_v, wr_d, params, inf_w=inf_w)
    if failed_yz:
        dh2 = dd2 = 0
        pk_yz, wh2, wd2 = params.unr_ncc, inf_w, inf_w
    else:
        dh2, dd2, pk_yz, wh2, wd2 = peak_and_widths(
            ncc_yz, delay_h, delay_d, wr_h, wr_d, params, inf_w=inf_w)

    cv, pv, wv = fuse_axis(dv1, pk_xy, wv1, dv2, pk_xz, wv2, params, inf_w)
    ch, ph, wh = fuse_axis(dh1, pk_xy, wh1, dh2, pk_yz, wh2, params, inf_w)
    cd, pd, wd = fuse_axis(dd1, pk_xz, wd1, dd2, pk_yz, wd2, params, inf_w)

    # add the nominal offset (libcrossmips.cpp:483-488)
    if side == "ns":
        cv += ni
    elif side == "we":
        ch += nj
    else:
        cd += nk
    return NCCResult(coord=(cv, ch, cd), ncc_peak=(pv, ph, pd),
                     ncc_width=(wv, wh, wd))

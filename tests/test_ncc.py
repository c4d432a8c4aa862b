import numpy as np
import pytest

from ipp_tpu.ops import ncc as nccmod
from tests.synth import make_phantom


def np_ncc_single(m1, m2, u, v):
    """Direct numpy port of the reference compute_NCC
    (TeraStitcher compute_funcs.cu: per-shift overlap NCC with means
    subtracted, double accumulators)."""
    U, V = m1.shape
    a = m1[max(0, u):U + min(0, u), max(0, v):V + min(0, v)].astype(np.float64)
    b = m2[max(0, -u):U + min(0, -u), max(0, -v):V + min(0, -v)].astype(np.float64)
    a = a - a.mean()
    b = b - b.mean()
    den = np.sqrt((a * a).sum() * (b * b).sum())
    if den <= 0:
        return 0.0
    return float((a * b).sum() / den)


def test_ncc_map_matches_reference_formula(rng):
    m1 = rng.random((40, 50), dtype=np.float32) * 100
    m2 = rng.random((40, 50), dtype=np.float32) * 100
    du, dv = 5, 7
    out = nccmod.ncc_map(m1, m2, du, dv)
    assert out.shape == (2 * du + 1, 2 * dv + 1)
    for u in (-5, -2, 0, 3, 5):
        for v in (-7, 0, 4, 7):
            ref = np_ncc_single(m1, m2, u, v)
            assert abs(out[du + u, dv + v] - ref) < 2e-4, (u, v)


def test_ncc_production_mip_shape_regression(rng):
    """Production-scale MIPs ((12, 150, 1024), search 26) through the
    separable row/col takes of ncc_maps_batched: the exact shape keeps
    running and the map still matches the reference formula there."""
    m1 = rng.random((12, 150, 1024), dtype=np.float32) * 100
    m2 = np.roll(m1, (4, -6), axis=(1, 2)).astype(np.float32)
    out = np.asarray(nccmod.ncc_maps_batched(m1, m2, 26, 26))
    assert out.shape == (12, 53, 53)
    for b in (0, 7):
        for (u, v) in ((0, 0), (4, -6), (-26, 26)):
            ref = np_ncc_single(m1[b], m2[b], u, v)
            assert abs(out[b, 26 + u, 26 + v] - ref) < 2e-4, (b, u, v)
    # the peak must sit at the planted shift for every pair:
    # m2 = roll(m1, (4, -6)) means m1 shifted by (-4, +6) matches m2
    peaks = out.reshape(12, -1).argmax(axis=1)
    assert (peaks == (26 - 4) * 53 + (26 + 6)).all()


def test_corner_sums_separable_matches_2d_gather(rng):
    """The separable take-based corner sums must stay numerically
    identical to the 2D-gather form (kept as the definitional twin)."""
    import jax.numpy as jnp

    m = jnp.asarray(rng.random((3, 40, 60), dtype=np.float32))
    ii = nccmod._prefix2d(m)
    U, V, du, dv = 40, 60, 5, 9
    uu = jnp.arange(-du, du + 1)
    vv = jnp.arange(-dv, dv + 1)
    sep = nccmod._corner_sums_sep(
        ii, jnp.maximum(0, uu), U + jnp.minimum(0, uu),
        jnp.maximum(0, vv), V + jnp.minimum(0, vv))
    u = uu[:, None]
    v = vv[None, :]
    old = nccmod._corner_sums(
        ii, jnp.maximum(0, u) + 0 * v, U + jnp.minimum(0, u) + 0 * v,
        jnp.maximum(0, v) + 0 * u, V + jnp.minimum(0, v) + 0 * u)
    np.testing.assert_allclose(np.asarray(sep), np.asarray(old), rtol=1e-6)


def test_ncc_peak_at_known_shift(rng):
    base = make_phantom(rng, (1, 120, 140))[0].astype(np.float32)
    m1 = base[10:90, 10:110]
    m2 = base[14:94, 7:107]  # m2 = m1 shifted: m1[t+u]=m2[t] at u=(y?:...)
    out = nccmod.ncc_map(m1, m2, 8, 8)
    peak = np.unravel_index(np.argmax(out), out.shape)
    # m2 starts 4 rows later, 3 cols earlier: m1[t + (4,-3)] == m2[t]
    assert (peak[0] - 8, peak[1] - 8) == (4, -3)
    assert out[peak] > 0.99


def test_batched_matches_single(rng):
    m1 = rng.random((3, 30, 30), dtype=np.float32)
    m2 = rng.random((3, 30, 30), dtype=np.float32)
    full = np.asarray(nccmod.ncc_maps_batched(m1, m2, 4, 4))
    for b in range(3):
        single = nccmod.ncc_map(m1[b], m2[b], 4, 4)
        np.testing.assert_allclose(full[b], single, atol=2e-5)


@pytest.mark.parametrize("side,shift", [
    ("ns", (3, -2, 1)), ("we", (-2, 4, 0)), ("ns", (0, 0, 0)),
])
def test_align_pair_recovers_truth(rng, side, shift):
    """Cut two overlapping subvolumes from one phantom with a known extra
    displacement and check align_pair recovers it (semantics of
    norm_cross_corr_mips: coord = nominal + found shift)."""
    vol = make_phantom(rng, (40, 256, 256), smooth=8.0)
    D, H, W = 32, 128, 128
    overlap = 48
    sv, sh, sd = shift
    if side == "ns":
        nominal = H - overlap
        a = vol[4:4 + D, 10:10 + H, 30:30 + W]
        b = vol[4 + sd:4 + sd + D, 10 + nominal + sv:10 + nominal + sv + H,
                30 + sh:30 + sh + W]
        expected = (nominal + sv, sh, sd)
    else:
        nominal = W - overlap
        a = vol[4:4 + D, 30:30 + H, 10:10 + W]
        b = vol[4 + sd:4 + sd + D, 30 + sv:30 + sv + H,
                10 + nominal + sh:10 + nominal + sh + W]
        expected = (sv, nominal + sh, sd)
    res = nccmod.align_pair(a.astype(np.float32), b.astype(np.float32), side,
                            overlap, 10, 10, 3)
    assert res.coord == expected, (res, expected)
    assert min(res.ncc_peak) > 0.5


def test_align_pair_unreliable_on_noise(rng):
    """Pure noise must produce low peaks / wide widths so the threshold step
    can reject it."""
    a = rng.random((16, 96, 96), dtype=np.float32)
    b = rng.random((16, 96, 96), dtype=np.float32)
    res = nccmod.align_pair(a, b, "ns", 40, 8, 8, 3)
    params = nccmod.NCCParams()
    inf_w = params.inf_w((8, 8, 3))
    # at least the width or peak must mark it weak on some axis
    weak = [res.ncc_peak[i] < 0.5 or res.ncc_width[i] >= inf_w for i in range(3)]
    assert any(weak)


def test_thin_z_invalidates_d_axis(rng):
    """A z-extent below minDim_NCCsrc clamps the D search to zero and the
    D axis must come out UNRELIABLE — peak unr_ncc, width == the
    LINK-GLOBAL inf_w (from the unclamped radii, PDAlgoMIPNCC.cpp:87-92)
    — exactly as the terastitcher binary reports (caught by the
    binary-parity fuzz: the per-map local infinity used to undercut the
    global one and fused as a real width)."""
    depth = 20  # < min_dim_ncc_src=25 -> delay_d clamps to 0
    vol = (rng.random((depth, 200, 220)) * 1000).astype(np.float32)
    a = vol[:, :160, :160]
    b = vol[:, :160, 60:220]  # true H shift 60, overlap 100
    params = nccmod.NCCParams()
    res = nccmod.align_pair(a, b, "we", 100, 12, 16, 5, params)
    inf_w = params.inf_w((12, 16, 5))  # 17, from UNCLAMPED radii
    assert res.coord[1] == 60
    assert res.ncc_peak[2] == params.unr_ncc
    assert res.ncc_width[2] == inf_w
    # batched path agrees
    resb = nccmod.align_pairs_batched(a[None], b[None], "we", 100,
                                      12, 16, 5, params)[0]
    assert resb.ncc_peak[2] == params.unr_ncc
    assert resb.ncc_width[2] == inf_w

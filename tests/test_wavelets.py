"""Golden tests for the wavelet engine.

Model: the reference verifies optimized kernels against straightforward
references with ~5e-5 f32 tolerance (e.g. gauss3d_gpu_test.m).  Here the
straightforward reference is a dense-matrix circular DWT in numpy float64.
"""

import numpy as np
import pytest

from ipp_tpu.ops import wavelets as wv


def _np_dwt_last(x, rec_lo, rec_hi):
    n = x.shape[-1]
    L = len(rec_lo)
    idx = (2 * np.arange(n // 2)[:, None] + np.arange(L)[None, :]) % n
    xe = x[..., idx]
    return xe @ rec_lo, xe @ rec_hi


def _np_idwt_last(cA, cD, rec_lo, rec_hi):
    m = cA.shape[-1]
    n = 2 * m
    L = len(rec_lo)
    y = np.zeros(cA.shape[:-1] + (n,))
    for i in range(m):
        for k in range(L):
            y[..., (2 * i + k) % n] += cA[..., i] * rec_lo[k] + cD[..., i] * rec_hi[k]
    return y


WAVELETS = ["haar", "db3", "db9", "db20", "sym4", "sym15", "coif3", "coif5"]


@pytest.mark.parametrize("name", WAVELETS)
def test_filter_bank_orthogonality(name):
    h = wv.scaling_filter(name)
    L = len(h)
    assert L % 2 == 0
    assert np.isclose(h.sum(), np.sqrt(2), atol=1e-10)
    # double-shift orthogonality: <h, h[.-2m]> = delta_m
    for m in range(1, L // 2):
        assert abs(np.dot(h[: L - 2 * m], h[2 * m:])) < 1e-8, (name, m)
    assert np.isclose(np.dot(h, h), 1.0, atol=1e-10)


@pytest.mark.parametrize("name", ["db2", "db9", "sym8", "coif2"])
def test_1d_roundtrip_vs_numpy(name, rng):
    dec_lo, dec_hi, rec_lo, rec_hi = wv.filter_bank(name)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    import jax.numpy as jnp

    cA, cD = wv._dwt_last(jnp.asarray(x), rec_lo, rec_hi)
    cA_np, cD_np = _np_dwt_last(x.astype(np.float64), rec_lo, rec_hi)
    np.testing.assert_allclose(np.asarray(cA), cA_np, atol=5e-5)
    np.testing.assert_allclose(np.asarray(cD), cD_np, atol=5e-5)
    xr = wv._idwt_last(cA, cD, rec_lo, rec_hi)
    np.testing.assert_allclose(np.asarray(xr), x, atol=5e-5)


@pytest.mark.parametrize("name", ["db2", "db9", "sym8", "coif2"])
def test_polyphase_dwt_matches_float64_reference(name, rng):
    """Analysis AND synthesis of the polyphase DWT against the float64
    numpy circular reference, including axes shorter than the filter
    (db9 on 8 samples wraps the circular extension twice)."""
    import jax.numpy as jnp

    _, _, rec_lo, rec_hi = wv.filter_bank(name)
    for n in (8, 18, 250):
        x = rng.standard_normal((2, 3, n)).astype(np.float32)
        cA, cD = wv._dwt_last(jnp.asarray(x), rec_lo, rec_hi)
        cA_np, cD_np = _np_dwt_last(x.astype(np.float64), rec_lo, rec_hi)
        np.testing.assert_allclose(np.asarray(cA), cA_np, atol=5e-6)
        np.testing.assert_allclose(np.asarray(cD), cD_np, atol=5e-6)
        y = wv._idwt_last(jnp.asarray(cA_np, jnp.float32),
                          jnp.asarray(cD_np, jnp.float32), rec_lo, rec_hi)
        y_np = _np_idwt_last(cA_np, cD_np, rec_lo, rec_hi)
        np.testing.assert_allclose(np.asarray(y), y_np, atol=5e-6)


@pytest.mark.parametrize("name", ["db9", "sym6", "coif4"])
@pytest.mark.parametrize("level", [1, 3])
def test_wavedec2_roundtrip(name, level, rng):
    img = rng.standard_normal((2, 64, 96)).astype(np.float32)
    coeffs = wv.wavedec2(img, name, level)
    assert len(coeffs) == level + 1
    assert coeffs[0].shape == (2, 64 >> level, 96 >> level)
    rec = wv.waverec2(coeffs, name)
    np.testing.assert_allclose(np.asarray(rec), img, atol=2e-4)


def test_wavedec2_energy_preserved(rng):
    img = rng.standard_normal((32, 32)).astype(np.float64)
    coeffs = wv.wavedec2(img, "db4", 2)
    e = float(np.sum(np.square(np.asarray(coeffs[0]))))
    for det in coeffs[1:]:
        for c in det:
            e += float(np.sum(np.square(np.asarray(c))))
    assert np.isclose(e, np.sum(np.square(img)), rtol=1e-4)


def test_stripe_lands_in_cH(rng):
    """A horizontal stripe (constant along x) must land in cH (detail-y,
    approx-x) — the subband the destriper filters (pystripe/core.py:927-939)."""
    img = np.zeros((64, 64), np.float32)
    img[31, :] = 1.0  # one-pixel horizontal stripe
    cA, (cH, cV, cD) = wv.dwt2(img, "db2")
    assert np.abs(np.asarray(cH)).sum() > 10 * np.abs(np.asarray(cV)).sum()


def test_max_level():
    assert wv.dwt_max_level(1024, "db9") == int(np.floor(np.log2(1024 / 17)))
    assert wv.dwt_max_level(10, "db9") == 0


def test_high_order_coiflets_properties():
    """Derived coif6+ filters: orthonormality, sum sqrt(2), and the coiflet
    vanishing moments (wavelet AND scaling function)."""
    from ipp_tpu.ops.coif_data import COIF_HIGH

    assert 15 in COIF_HIGH or 6 in COIF_HIGH
    for K in sorted(COIF_HIGH):
        h = wv.scaling_filter(f"coif{K}")
        L = len(h)
        assert L == 6 * K
        assert np.isclose(h.sum(), np.sqrt(2), atol=1e-8)
        assert np.isclose(np.dot(h, h), 1.0, atol=1e-8)
        for m in range(1, L // 2):
            assert abs(np.dot(h[:L - 2 * m], h[2 * m:])) < 1e-7, (K, m)
        n = np.arange(L, dtype=np.float64)
        sgn = (-1.0) ** n
        for m in range(0, 2 * K):
            wm = np.dot(sgn * n ** m, h[::-1]) / max(1.0, float(L) ** m)
            assert abs(wm) < 1e-8, (K, "wavelet moment", m)
        shift = 4 * K - 1
        for m in range(1, 2 * K):
            sm = np.dot((n - shift) ** m, h) / max(1.0, float(L) ** m)
            assert abs(sm) < 1e-8, (K, "scaling moment", m)


def test_coif15_roundtrip(rng):
    from ipp_tpu.ops.coif_data import COIF_HIGH

    K = 15 if 15 in COIF_HIGH else max(COIF_HIGH)
    img = rng.standard_normal((2, 128, 128)).astype(np.float32)
    coeffs = wv.wavedec2(img, f"coif{K}", 1)
    rec = wv.waverec2(coeffs, f"coif{K}")
    np.testing.assert_allclose(np.asarray(rec), img, atol=5e-4)


@pytest.mark.parametrize("name", ["db2", "db4", "db9"])
def test_level2_on_pywt_polyphase_branch(name, rng):
    """Level-2 coefficients must equal pywt's (symmetric mode, interior) at
    SOME integer shift — i.e. wavedec2 recurses on pywt's polyphase branch.
    Without _parity_rolls, db2/db4 (odd (L-2)/2) match at NO shift (the
    notch then filters genuinely different subbands; the golden destripe
    bidirectional test caught this at 8.3e-2 NRMSE)."""
    import jax.numpy as jnp

    from tests.refshims import _shim_wavedec2

    x = rng.standard_normal((256, 256)).astype(np.float64)
    ours = np.asarray(wv.wavedec2(jnp.asarray(x, jnp.float32), name, 2)[1][0])
    ref = _shim_wavedec2(x, name, level=2)[1][0]
    # interior window clear of both boundary conventions: a level-2 coeff
    # spans 3L-2 input samples, so stay > (3L-2)/4 coeffs from either edge
    m, w_ = 20, 16
    best = min(
        np.abs(ref[m + sy:m + sy + w_, m + sx:m + sx + w_] - ours[m:m + w_, m:m + w_]).max()
        for sy in range(0, 18) for sx in range(0, 18)
        if ref.shape[0] >= m + sy + w_ and ref.shape[1] >= m + sx + w_)
    assert best < 1e-4, f"no integer shift aligns level-2 cH ({best:.3f})"


FUZZ_PARITY_WAVELETS = ["db2", "db3", "db4", "db5", "db6", "db7", "db8",
                        "db9", "db10", "sym4", "sym5", "sym6", "sym7",
                        "sym8", "coif1", "coif2", "coif3", "coif4", "haar"]


@pytest.mark.parametrize("name", FUZZ_PARITY_WAVELETS)
@pytest.mark.parametrize("level", [2, 3])
def test_polyphase_branch_fuzz(name, level, rng):
    """_parity_rolls across the whole supported wavelet family and level
    2-3: the recursion must land on pywt's polyphase branch (coefficients
    equal at SOME integer shift in the interior) for every filter length
    parity, not just the db2/db4/db9 trio the level-2 bug was fixed on."""
    import jax.numpy as jnp

    from tests.refshims import _shim_wavedec2

    n = 512 if level == 3 else 256
    x = rng.standard_normal((n, n)).astype(np.float64)
    ours = np.asarray(wv.wavedec2(jnp.asarray(x, jnp.float32),
                                  name, level)[1][0])
    ref = _shim_wavedec2(x, name, level=level)[1][0]
    m = 24
    w_ = 12
    span = 22
    best = min(
        np.abs(ref[m + sy:m + sy + w_, m + sx:m + sx + w_]
               - ours[m:m + w_, m:m + w_]).max()
        for sy in range(0, span) for sx in range(0, span)
        if ref.shape[0] >= m + sy + w_ and ref.shape[1] >= m + sx + w_)
    assert best < 1e-4, f"{name} L{level}: no integer shift aligns ({best:.3f})"

import numpy as np
import pytest

from ipp_tpu.ops import destripe as ds


def make_striped_tile(rng, h=256, w=256, stripe_strength=0.3):
    """Synthetic tile: smooth 2D signal + multiplicative horizontal stripes
    (constant along x — the light-sheet artifact geometry)."""
    yy, xx = np.meshgrid(np.linspace(0, 3, h), np.linspace(0, 3, w), indexing="ij")
    base = 2000 + 1500 * np.exp(-((yy - 1.5) ** 2 + (xx - 1.5) ** 2))
    stripes = 1.0 + stripe_strength * rng.standard_normal(h)[:, None]
    img = base * stripes + rng.normal(0, 10, (h, w))
    return np.clip(img, 0, 65535).astype(np.uint16), base


def stripe_power(img):
    """Mean per-row deviation energy after removing smooth row structure."""
    x = np.log1p(img.astype(np.float64))
    row_means = x.mean(axis=1)
    from scipy.ndimage import gaussian_filter1d

    smooth = gaussian_filter1d(row_means, 10)
    return float(np.abs(row_means - smooth).mean())


def test_notch_matches_reference_formula():
    g = ds.notch(100, 10.0)
    x = np.arange(100, dtype=np.float32)
    ref = 1 - np.exp(-x ** 2 / (2 * 100.0))
    np.testing.assert_allclose(g, ref, atol=1e-6)
    assert g[0] == 0.0


def test_pad_size_formula():
    # parity with the reference closed form (pystripe/core.py:671-698)
    assert ds.notch_rise_point(250, 0.4) == int(
        np.sqrt(-2 * 250 ** 2 * np.log(0.6)) + 0.5) // 2 * 2
    p = ds.calculate_pad_size((2048, 2048), 250)
    assert p > 0 and p % 2 == 0


@pytest.mark.parametrize("wavelet", ["db9", "db3"])
def test_destripe_removes_stripes(rng, wavelet):
    img, _ = make_striped_tile(rng)
    out = np.asarray(ds.filter_streaks(img, sigma=(128, 128), wavelet=wavelet))
    assert out.dtype == np.uint16
    assert out.shape == img.shape
    p_in = stripe_power(img)
    p_out = stripe_power(out)
    assert p_out < 0.35 * p_in, (p_in, p_out)


def test_destripe_preserves_structure(rng):
    img, base = make_striped_tile(rng, stripe_strength=0.2)
    out = np.asarray(ds.filter_streaks(img, sigma=(128, 128))).astype(np.float64)
    # column profile (structure orthogonal to stripes) should track the base
    prof_out = out.mean(axis=0)
    prof_base = base.mean(axis=0)
    corr = np.corrcoef(prof_out, prof_base)[0, 1]
    assert corr > 0.99


def test_destripe_batched_equals_single(rng):
    imgs = np.stack([make_striped_tile(rng)[0] for _ in range(3)])
    batched = np.asarray(ds.filter_streaks(imgs, sigma=(64, 64)))
    singles = np.stack(
        [np.asarray(ds.filter_streaks(imgs[i], sigma=(64, 64))) for i in range(3)])
    np.testing.assert_array_equal(batched, singles)


def test_destripe_noop_when_sigma_zero(rng):
    img, _ = make_striped_tile(rng)
    out = ds.filter_streaks(img, sigma=(0, 0))
    np.testing.assert_array_equal(np.asarray(out), img)


def test_destripe_with_bleach_correction(rng):
    img, _ = make_striped_tile(rng)
    decay = np.exp(-np.arange(img.shape[1]) / 300.0)[None, :]
    img = (img * decay).astype(np.uint16)
    from ipp_tpu.ops import stats

    x = np.log1p(img.astype(np.float32))
    lb, mb, ub = stats.threshold_multiotsu(x, classes=4)
    out = np.asarray(ds.filter_streaks(
        img, sigma=(64, 64), bleach_correction_frequency=1.0 / img.shape[1],
        bleach_correction_clip_min=lb, bleach_correction_clip_med=mb,
        bleach_correction_clip_max=ub))
    # bleach corrected: right side no longer decayed to near-zero
    left = out[:, :64].mean()
    right = out[:, -64:].mean()
    assert right > 0.4 * left


def test_dual_band_sigma1_zero_uses_unclipped_foreground(rng):
    """When sigma1 == 0 the foreground band is the UNCLIPPED image
    (reference filter_streak_dual_band, pystripe/core.py:953-958);
    round-1 clipped it at the threshold (ADVICE)."""
    import jax
    import jax.numpy as jnp

    from ipp_tpu.ops.destripe import (_plan_padding, filter_subband,
                                      filter_streaks)  # noqa: F401
    from ipp_tpu.ops.intensity import foreground_fraction

    img = (rng.random((64, 64)) * 200).astype(np.float32)
    threshold, crossover, sigma2, wavelet = 80.0, 10.0, 16.0, "db3"
    got = np.asarray(filter_streaks(
        img, sigma=(0, sigma2), wavelet=wavelet, threshold=threshold,
        crossover=crossover, use_thresholding=True,
        log1p_normalization_needed=False))

    # expected: reference formula with fg = x (unclipped), compiled as
    # one program like filter_streaks so both sides round alike
    base_pad, (py, px), _, lv = _plan_padding(
        img.shape, (0.0, sigma2), 0, wavelet)

    @jax.jit
    def reference(x):
        xp = jnp.pad(x, [(base_pad, base_pad + py),
                         (base_pad, base_pad + px)], mode="wrap")
        bg = filter_subband(jnp.clip(xp, None, threshold), sigma2, lv,
                            wavelet, axes=(-1,))
        # smoothing=0: the reference's shipped foreground mask is
        # unsmoothed (GaussianBlur return discarded, pystripe/core.py:600)
        frac = foreground_fraction(xp, jnp.float32(threshold), crossover,
                                   smoothing=0)
        blended = (xp * frac + bg * (1.0 - frac)) * threshold
        return blended[base_pad:base_pad + 64, base_pad:base_pad + 64]

    expected = np.asarray(reference(jnp.asarray(img)))
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-3)


def test_dual_band_nonpositive_threshold_routes_single_band(rng):
    """threshold <= 0 routes to a single sigma1-band filter
    (reference pystripe/core.py:945-946)."""
    img = (rng.random((64, 64)) * 1000).astype(np.uint16)
    got = np.asarray(ds.filter_streaks(
        img, sigma=(24, 8), wavelet="db3", threshold=-1.0,
        use_thresholding=True))
    single = np.asarray(ds.filter_streaks(img, sigma=(24, 24), wavelet="db3"))
    np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("axis", [-1, -2])
def test_notch_matches_float64_circulant(rng, axis):
    """The rfft notch equals a float64 numpy circular convolution with the
    notch's impulse response (the same filter written as a circulant
    matrix): the sigma/2 complex-bin notch of filter_coefficient."""
    import jax.numpy as jnp

    coef = rng.standard_normal((3, 96, 160)).astype(np.float32)
    width_frac = 0.4
    out = np.asarray(ds.filter_coefficient(jnp.asarray(coef), width_frac,
                                           axis=axis))
    n = coef.shape[axis]
    sigma = coef.shape[-2 if axis == -1 else -1] * width_frac
    g = ds.notch(n // 2 + 1, 0.5 * sigma).astype(np.float64)
    col = np.fft.irfft(g, n=n)
    K = col[(np.arange(n)[None, :] - np.arange(n)[:, None]) % n]
    ref = np.moveaxis(np.moveaxis(coef.astype(np.float64), axis, -1) @ K,
                      -1, axis)
    np.testing.assert_allclose(out, ref, atol=5e-5)

"""Richardson-Lucy deconvolution tests (BASELINE config 3 semantics)."""

import numpy as np
import pytest
from scipy.ndimage import convolve as ndi_convolve
from scipy.ndimage import gaussian_filter

from ipp_tpu.ops import deconv as dc
from ipp_tpu.ops.psf import gaussian_psf, make_psf


def test_gauss3d_matches_scipy(rng):
    vol = rng.random((20, 24, 28), dtype=np.float32)
    out = np.asarray(dc.gauss3d(vol, 1.5))
    # imgaussfilt3 truncates at 2*ceil(2*sigma)+1 = radius 3 -> truncate=2
    ref = gaussian_filter(vol, 1.5, mode="nearest", truncate=2.0)
    np.testing.assert_allclose(out, ref, atol=5e-5)


def test_make_taper_shape():
    t = dc.make_taper(64, 8)
    assert t.shape == (64,)
    # MATLAB make_taper builds ramp(9)+plateau(48)+ramp_down(8)=65 samples
    # then truncates to 64, dropping the trailing zero (make_taper.m:28-33)
    assert t[0] == 0.0 and abs(t[-1] - 0.125) < 1e-6
    assert (t[8:-8] == 1.0).all()
    t2 = dc.make_taper(10, 8)  # clamped to dimsz//2
    assert t2.shape == (10,)


def test_edge_taper_preserves_interior(rng):
    vol = rng.random((32, 32, 32), dtype=np.float32)
    psf = gaussian_psf((7, 7, 7), (1.5, 1.5, 1.5))
    out = np.asarray(dc.edge_taper_3d(vol, psf))
    # interior untouched (mask == 1 in the plateau)
    np.testing.assert_allclose(out[10:-10, 10:-10, 10:-10],
                               vol[10:-10, 10:-10, 10:-10], atol=1e-6)
    # faces moved toward the blurred version
    assert not np.allclose(out[0], vol[0])


def test_conv3d_zero_matches_scipy(rng):
    vol = rng.random((12, 13, 14), dtype=np.float32)
    kern = rng.random((3, 5, 3), dtype=np.float32)
    out = np.asarray(dc._conv3d_zero(vol, kern))
    ref = ndi_convolve(vol, kern, mode="constant", cval=0.0)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("stop", [0.0, 2.0])
def test_rl_sharpens_blurred_phantom(rng, stop):
    """Blur a phantom with a known PSF; RL must move the result back toward
    the truth (higher correlation, lower error)."""
    truth = np.zeros((48, 48, 48), np.float32)
    pts = rng.integers(8, 40, (30, 3))
    truth[pts[:, 0], pts[:, 1], pts[:, 2]] = 1000.0
    truth = gaussian_filter(truth, 1.0)
    psf = gaussian_psf((9, 9, 9), (2.0, 2.0, 2.0))
    blurred = ndi_convolve(truth, psf, mode="constant").astype(np.float32)

    out = np.asarray(dc.richardson_lucy(blurred, psf, niter=12,
                                        stop_criterion=stop))
    assert out.shape == truth.shape

    def nrmse(a, b):
        return np.sqrt(np.mean((a - b) ** 2)) / truth.max()

    err_blur = nrmse(blurred, truth)
    err_dec = nrmse(out, truth)
    assert err_dec < 0.7 * err_blur, (err_blur, err_dec)


def test_rl_spatial_close_to_fft(rng):
    truth = gaussian_filter(rng.random((24, 24, 24)).astype(np.float32), 1.0)
    psf = gaussian_psf((5, 5, 5), (1.2, 1.2, 1.2))
    blurred = ndi_convolve(truth, psf, mode="constant").astype(np.float32)
    # spatial path implements the reference's bl-as-y scheme, so compare
    # against the FFT path in reference mode (classic=False)
    out_fft = np.asarray(dc.richardson_lucy(blurred, psf, niter=4,
                                            classic=False))
    out_sp = np.asarray(dc.richardson_lucy_spatial(blurred, psf, niter=4))
    # same algorithm up to boundary handling: interiors agree
    np.testing.assert_allclose(out_fft[4:-4, 4:-4, 4:-4],
                               out_sp[4:-4, 4:-4, 4:-4], rtol=0.05, atol=2.0)


def test_rl_with_regularization_runs(rng):
    vol = rng.random((16, 16, 16), dtype=np.float32) * 100
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    out = np.asarray(dc.richardson_lucy(vol, psf, niter=6, lam=0.1,
                                        regularize_interval=2))
    assert np.isfinite(out).all()


def test_rl_regularized_reference_mode_matches_batched(rng):
    """In reference mode (classic=False) with regularization, the RL ratio
    numerator must be the POST-smoothing estimate (decon.m:160-169 computes
    `buf = bl ./ buf` after the Gaussian).  The batched path always did this;
    pin the single-volume while_loop path to it."""
    vol = rng.random((16, 16, 16), dtype=np.float32) * 100
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    kw = dict(niter=6, lam=0.1, regularize_interval=2, classic=False,
              edge_taper=False, fft_shape=(20, 20, 20))
    single = np.asarray(dc.richardson_lucy(vol, psf, **kw))
    batched = np.asarray(dc.richardson_lucy_batched(vol[None], psf, **kw))[0]
    np.testing.assert_allclose(single, batched, rtol=1e-4, atol=1e-3)


def test_rl_batched_early_stop_matches_single(rng):
    """VERDICT r4 item 4: per-block early stop on the batched path.

    Blocks with different content converge at different iterations; the
    batched result must equal each block's single-device early-stopped
    result (the vmapped while_loop freezes converged lanes), and must
    differ from the run-all-niter batched result (i.e. the stop really
    fired before niter).  Reference: decon.m:155-204 fires per block."""
    psf = gaussian_psf((5, 5, 5), (1.2, 1.2, 1.2))
    # block 0: near-flat (converges almost immediately at a loose stop);
    # block 1: structured (keeps changing longer)
    flat = np.full((16, 16, 16), 100.0, np.float32)
    flat += rng.random(flat.shape).astype(np.float32) * 0.1
    truth = np.zeros((16, 16, 16), np.float32)
    truth[4:12, 4:12, 4:12] = rng.random((8, 8, 8)).astype(np.float32) * 500
    sharp = ndi_convolve(truth, psf, mode="constant").astype(np.float32)
    vols = np.stack([flat, sharp])
    kw = dict(niter=12, edge_taper=False, fft_shape=(20, 20, 20))

    batched = np.asarray(dc.richardson_lucy_batched(
        vols, psf, stop_criterion=1.0, **kw))
    for b in range(2):
        single = np.asarray(dc.richardson_lucy(
            vols[b], psf, stop_criterion=1.0, **kw))
        np.testing.assert_allclose(batched[b], single, rtol=1e-5,
                                   atol=1e-3, err_msg=f"block {b}")
    # prove the stop is actually plumbed into the loop (not a no-op):
    # an always-true criterion exits every block at iteration 2, which
    # must differ from the full-niter run on the structured block
    stopped2 = np.asarray(dc.richardson_lucy_batched(
        vols, psf, stop_criterion=1e6, **kw))
    full = np.asarray(dc.richardson_lucy_batched(vols, psf, **kw))
    assert not np.allclose(stopped2[1], full[1], rtol=1e-4), \
        "early stop never fired"
    two_iter = np.asarray(dc.richardson_lucy_batched(
        vols, psf, **{**kw, "niter": 2}))
    np.testing.assert_allclose(stopped2, two_iter, rtol=1e-5, atol=1e-3)


def test_fft_shape_smooth():
    s = dc.fft_shape_for((100, 101, 97), (11, 11, 11))
    for v in s:
        m = v
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        assert m == 1
        assert v >= 100


def test_make_psf_small():
    """Optics-model PSF: symmetric, positive, unit sum, monotone decay from
    center (reference LsMakePSF semantics)."""
    psf, fwhm_xy, fwhm_z = make_psf(dxy=400.0, dz=800.0, NA=0.4,
                                    lambda_ex=488.0, lambda_em=525.0)
    assert psf.ndim == 3
    assert all(s % 2 == 1 for s in psf.shape)
    assert abs(psf.sum() - 1.0) < 1e-5
    assert fwhm_z > fwhm_xy  # light-sheet: z worse than xy
    c = tuple(s // 2 for s in psf.shape)
    assert psf[c] == psf.max()
    np.testing.assert_allclose(psf, psf[::-1, :, :], atol=1e-7)
    np.testing.assert_allclose(psf, psf[:, :, ::-1], atol=1e-7)


def test_edge_taper_face_slabs_match_full_blur(rng):
    """The face-slab edge taper equals the naive full-volume formula
    mask*vol + (1-mask)*blur(vol) (reference edgetaper_3d.m)."""
    import jax.numpy as jnp

    from ipp_tpu.ops import deconv as dc
    from ipp_tpu.ops.psf import gaussian_psf

    vol = jnp.asarray((rng.random((48, 56, 64)) * 1000).astype(np.float32))
    psf = jnp.asarray(gaussian_psf((7, 9, 9), (1.5, 2.0, 2.0)))
    psf = psf / jnp.sum(psf)
    got = np.asarray(dc.edge_taper_3d(vol, psf))
    blur = np.asarray(dc._fft_conv_same(vol, psf))
    mask = np.ones((), np.float32)
    for d in range(3):
        tw = max(8, int(round(psf.shape[d] / 2)))
        t = dc.make_taper(vol.shape[d], tw)
        shape = [1, 1, 1]
        shape[d] = vol.shape[d]
        mask = mask * t.reshape(shape)
    ref = mask * np.asarray(vol) + (1.0 - mask) * blur
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.05)


def test_rl_overlap_save_core_matches_padded(rng):
    """Overlap-save RL (fft shape == block shape, wraparound absorbed by
    the halo) matches zero-padded RL on the core — the production block
    semantics of pipeline.deconvolve.autosplit."""
    from ipp_tpu.ops import deconv as dc
    from ipp_tpu.ops.psf import gaussian_psf

    vol = (rng.random((64, 64, 64)) * 1000).astype(np.float32)
    psf = np.asarray(gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0)))
    h = 8  # 4x the PSF half-extent
    a = np.asarray(dc.richardson_lucy(vol, psf, niter=6,
                                      fft_shape=(64, 64, 64)))
    b = np.asarray(dc.richardson_lucy(
        vol, psf, niter=6, fft_shape=dc.fft_shape_for(vol.shape, psf.shape)))
    sl = (slice(h, -h),) * 3
    nrmse = (np.linalg.norm(a[sl] - b[sl]) / np.linalg.norm(b[sl]))
    assert nrmse < 1e-3, nrmse

import jax.numpy as jnp
import numpy as np
import pytest

from ipp_tpu.io import tiff as tio
from ipp_tpu.ops import resample as rs
from ipp_tpu.ops.process import ProcessConfig, is_uniform_2d, process_img


def test_block_reduce_matches_manual(rng):
    img = rng.integers(0, 1000, (10, 12)).astype(np.uint16)
    out = np.asarray(rs.block_reduce(img, (2, 3), "max"))
    ref = img.reshape(5, 2, 4, 3).max(axis=(1, 3))
    np.testing.assert_array_equal(out, ref)
    outm = np.asarray(rs.block_reduce(img, (2, 3), "mean"))
    refm = img.reshape(5, 2, 4, 3).astype(np.float32).mean(axis=(1, 3))
    np.testing.assert_allclose(outm, refm, rtol=1e-6)


def test_block_reduce_pads_like_skimage(rng):
    img = rng.integers(1, 1000, (11, 13)).astype(np.uint16)
    out = np.asarray(rs.block_reduce(img, (2, 2), "max"))
    assert out.shape == (6, 7)
    # last row/col include zero padding; max unaffected for interior
    assert out[0, 0] == img[:2, :2].max()


def test_resize_downscale_antialiased(rng):
    from scipy.ndimage import zoom

    img = rng.random((64, 64), dtype=np.float32)
    out = np.asarray(rs.resize(img, (16, 16)))
    assert out.shape == (16, 16)
    # sanity: mean preserved approximately by AA downscale
    assert abs(out.mean() - img.mean()) < 0.02


def test_plan_isotropic_downsampling():
    target_shape, methods = rs.plan_isotropic_downsampling(
        (2048, 2048), (1.8, 1.8), 16.0)
    # reduction 8.89x per axis -> floor(sqrt(8.89))=2 halvings each
    assert len(methods) == 2
    assert methods[0] == ("max", "mean")
    assert methods[1] == ("mean", "max")
    assert target_shape == (int(round(2048 / (16 / 1.8))),) * 2


def test_is_uniform():
    assert is_uniform_2d(np.full((8, 8), 7, np.uint16))
    x = np.zeros((8, 8), np.uint16)
    x[3, 3] = 1
    assert not is_uniform_2d(x)


def test_process_img_uniform_shortcircuit():
    img = np.full((64, 64), 5, np.uint16)
    out = process_img(img, ProcessConfig(convert_to_8bit=True,
                                         down_sample=(2, 2)))
    assert out.shape == (32, 32)
    assert out.dtype == np.uint8
    assert (out == 0).all()


def test_process_img_full_chain(rng):
    img = (rng.random((128, 128)) * 40000).astype(np.uint16)
    cfg = ProcessConfig(sigma=(16, 16), wavelet="db3", dark=100.0,
                        convert_to_8bit=True, bit_shift_to_right=8,
                        rotate=90)
    out = process_img(img, cfg)
    assert out.dtype == np.uint8
    assert out.shape == (128, 128)


def test_process_img_downsample_and_resize(rng):
    img = (rng.random((100, 120)) * 1000).astype(np.uint16)
    out = process_img(img, ProcessConfig(down_sample=(2, 2),
                                         down_sample_method="mean"))
    assert out.shape == (50, 60)
    out2 = process_img(img, ProcessConfig(new_size=(64, 64)))
    assert out2.shape == (64, 64)


def test_kary_quantile_matches_numpy_percentile(rng):
    """The K-ary counting quantile must reproduce np.percentile (linear
    interpolation — the reference's prctl,
    pystripe/lightsheet_correct.py:240) per window."""
    from ipp_tpu.ops.lightsheet import _kary_quantile_axes

    for q, shape, atol in [(0.25, (3, 17, 4, 11), 0.05),
                           # k >= 1024: plain bisection returns the upper
                           # order stat (documented); error bounded by the
                           # adjacent-order-stat gap (~range/k)
                           (0.25, (2, 100, 2, 100), 5.0),
                           (0.5, (1, 9, 1, 16), 0.05),
                           (0.9, (2, 33, 3, 7), 0.05)]:
        p = (rng.random(shape) * 5000).astype(np.float32)
        got = np.asarray(_kary_quantile_axes(jnp.asarray(p), q))
        want = np.percentile(
            np.moveaxis(p, 1, 2).reshape(shape[0], shape[2], -1),
            q * 100.0, axis=-1).astype(np.float32)
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)


def test_grid_percentile_resize_matches_scipy_zoom(rng):
    """The matmul linear upsample equals scipy.ndimage.zoom(order=1) —
    the convention the reference interpolates its sparse grids with
    (pystripe/lightsheet_correct.py:216-226)."""
    from scipy.ndimage import zoom

    from ipp_tpu.ops.lightsheet import _resize_linear_mm

    v = rng.random((13, 9)).astype(np.float32)
    a = np.asarray(_resize_linear_mm(jnp.asarray(v), (128, 96)))
    b = zoom(v.astype(np.float64), (128 / 13, 96 / 9), order=1)
    assert b.shape == (128, 96)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_lightsheet_correction_removes_streak(rng):
    from ipp_tpu.ops.lightsheet import correct_lightsheet

    img = (rng.random((128, 128)) * 100).astype(np.float32)
    img[:, :] += 200.0  # uniform background
    img[60:68, :] += 800.0  # bright horizontal artifact band
    out = np.asarray(correct_lightsheet(img, artifact_length=64,
                                        background_window_size=64,
                                        background_spacing=(16, 16)))
    # the algorithm subtracts min(img, min(ls, 2*bg)) (reference
    # lightsheet_correct.py:89-97): background is removed almost entirely
    # and the artifact band is reduced (capped by 2*bg)
    assert out[:50].mean() < 0.15 * img[:50].mean()
    band_in = img[60:68].mean() - img[:50].mean()
    band_out = out[60:68].mean() - out[:50].mean()
    assert band_out < 0.75 * band_in


def test_convert_read_timeout_abandons_hung_worker(tmp_path, monkeypatch,
                                                   rng):
    """A single genuinely hung plane read must not poison later reads:
    the timeout pool is abandoned and recreated, the bad plane becomes
    zeros OF THE SOURCE DTYPE, and all other planes convert intact."""
    import threading

    from ipp_tpu.pipeline import convert as conv_mod

    planes = rng.integers(0, 250, (5, 10, 12)).astype(np.uint8)
    hang_forever = threading.Event()  # never set

    def fake_open_source(src, channel=0):
        def reader(z):
            if z == 2:
                hang_forever.wait()  # a stuck NFS read
            return planes[z]

        return reader, planes.shape[0]

    monkeypatch.setattr(conv_mod, "_open_source", fake_open_source)
    out = conv_mod.convert("ignored", tmp_path / "out", read_timeout=0.5)
    files = sorted(out.glob("img_*.tif"))
    assert len(files) == 5
    for z, f in enumerate(files):
        img = np.asarray(tio.imread(f))
        assert img.dtype == np.uint8, (z, img.dtype)
        if z == 2:
            assert img.max() == 0  # zero substitute
        else:
            np.testing.assert_array_equal(img, planes[z])


def test_convert_batched_matches_per_plane(tmp_path, rng):
    """The converter's batched device path (8 planes per jitted call, one
    batch in flight) must write exactly what per-plane process_img
    produces, in z order, including the uniform host short-circuit and a
    partial tail batch."""
    from ipp_tpu.pipeline import convert as conv_mod

    nz = 19  # 2 full batches + a 3-plane tail
    planes = (rng.normal(2000, 300, (nz, 32, 40))
              + 300 * np.sin(np.arange(40) / 3.0)[None, None, :]).clip(
                  0, 65535).astype(np.uint16)
    planes[5] = 777  # uniform plane: host short-circuit inside the stream
    src = tmp_path / "src"
    src.mkdir()
    for z in range(nz):
        tio.imwrite(src / f"img_{z:04d}.tif", planes[z])
    cfg = ProcessConfig(sigma=(8, 8), wavelet="db3", dark=50.0)
    out = conv_mod.convert(src, tmp_path / "out", cfg=cfg)
    files = sorted(out.glob("img_*.tif"))
    assert len(files) == nz
    for z, f in enumerate(files):
        got = np.asarray(tio.imread(f))
        want = np.asarray(process_img(planes[z], cfg))
        np.testing.assert_allclose(got, want, atol=1, err_msg=f"z={z}")
    assert tio.imread(files[5]).max() == 0  # uniform -> zeros


def test_convert_batched_resume_and_downsample(tmp_path, rng):
    """Resume with a downsample target through the batched stream: the
    npz and downsample chunks must match a fresh run (z-order-sensitive
    accumulator fed by mixed disk-read and device-batch planes)."""
    from ipp_tpu.pipeline import convert as conv_mod

    nz = 12
    planes = rng.integers(100, 3000, (nz, 24, 24)).astype(np.uint16)
    src = tmp_path / "src"
    src.mkdir()
    for z in range(nz):
        tio.imwrite(src / f"img_{z:04d}.tif", planes[z])
    cfg = ProcessConfig(dark=20.0)
    kw = dict(cfg=cfg, voxel_um=(2.0, 1.0, 1.0), target_voxel_um=4.0)
    out_a = conv_mod.convert(src, tmp_path / "fresh", **kw)
    npz_a = np.load(tmp_path / "fresh_zyx4.0um.npz")["I"]
    # partial prior run: some outputs exist, some don't
    out_b = tmp_path / "resumed"
    out_b.mkdir()
    for z in (0, 1, 2, 7):
        tio.imwrite(out_b / f"img_{z:06d}.tif",
                    np.asarray(process_img(planes[z], cfg)))
    conv_mod.convert(src, out_b, resume=True, **kw)
    npz_b = np.load(tmp_path / "resumed_zyx4.0um.npz")["I"]
    np.testing.assert_allclose(npz_a, npz_b, rtol=1e-6)
    for z in range(nz):
        np.testing.assert_array_equal(
            tio.imread(out_b / f"img_{z:06d}.tif"),
            tio.imread(out_a / f"img_{z:06d}.tif"))


def test_convert_heterogeneous_shapes_flush(tmp_path, rng):
    """A series whose plane shapes change mid-stream must flush the
    device batch at each shape boundary instead of np.stack-ing mixed
    shapes (the per-plane reference tolerates ragged series,
    parallel_image_processor.py:660-678)."""
    from ipp_tpu.pipeline import convert as conv_mod

    shapes = [(32, 40)] * 3 + [(24, 40)] * 3 + [(32, 40)] * 2
    planes = [rng.integers(100, 3000, s).astype(np.uint16) for s in shapes]
    src = tmp_path / "src"
    src.mkdir()
    for z, p in enumerate(planes):
        tio.imwrite(src / f"img_{z:04d}.tif", p)
    cfg = ProcessConfig(dark=20.0)
    out = conv_mod.convert(src, tmp_path / "out", cfg=cfg)
    files = sorted(out.glob("img_*.tif"))
    assert len(files) == len(planes)
    for z, f in enumerate(files):
        np.testing.assert_array_equal(
            tio.imread(f), np.asarray(process_img(planes[z], cfg)),
            err_msg=f"z={z}")


def test_convert_bleach_clips_stay_per_plane(tmp_path, rng):
    """Unresolved bleach clips are per-PLANE multi-Otsu statistics
    (reference pystripe/core.py:696-727 resolves them per image): the
    converter must not batch such planes — each written plane equals a
    standalone per-plane process_img call, not a batch-global-otsu
    result."""
    from ipp_tpu.ops.process import needs_host_stats
    from ipp_tpu.pipeline import convert as conv_mod

    nz = 10  # > BATCH so a batched path would mix two batches
    # planes with WILDLY different intensity regimes so batch-global
    # otsu clips would differ measurably from per-plane clips
    planes = np.stack([
        rng.normal(200 * (1 + 9 * (z % 2)), 30 + 5 * z, (32, 40))
        .clip(1, 65535).astype(np.uint16) for z in range(nz)])
    src = tmp_path / "src"
    src.mkdir()
    for z in range(nz):
        tio.imwrite(src / f"img_{z:04d}.tif", planes[z])
    cfg = ProcessConfig(bleach_correction_frequency=1 / 2000.0,
                        sigma=(8, 8), wavelet="db3")
    assert needs_host_stats(cfg)
    out = conv_mod.convert(src, tmp_path / "out", cfg=cfg)
    files = sorted(out.glob("img_*.tif"))
    assert len(files) == nz
    for z, f in enumerate(files):
        np.testing.assert_array_equal(
            tio.imread(f), np.asarray(process_img(planes[z], cfg)),
            err_msg=f"z={z}")


def test_process_batch_fn_jitted_matches_eager(rng):
    """The cached jitted batch wrapper must equal eager process_img
    exactly (CPU) and be cached per cfg object."""
    from ipp_tpu.ops.process import process_batch_fn

    batch = (rng.normal(2000, 300, (4, 32, 40))
             + 200 * np.sin(np.arange(40) / 3.0)).clip(0, 65535) \
        .astype(np.uint16)
    cfg = ProcessConfig(sigma=(8, 8), wavelet="db3", dark=30.0, rotate=90)
    fn = process_batch_fn(cfg)
    assert process_batch_fn(cfg) is fn  # cached on the cfg object
    out = np.asarray(fn(batch))
    want = np.stack([np.asarray(process_img(b, cfg)) for b in batch])
    np.testing.assert_array_equal(out, want)
    # per-plane-stat cfgs must be rejected (callers gate on
    # needs_host_stats)
    bleach = ProcessConfig(bleach_correction_frequency=1e-3)
    with pytest.raises(ValueError):
        process_batch_fn(bleach)


def test_process_batch_fn_returns_unfetched_device_array(rng):
    """The jitted batch fn returns an UNFETCHED device array (the lagged
    fetch contract) equal to process_img tile by tile, and is cached on
    the cfg."""
    import jax

    from ipp_tpu.ops.process import process_batch_fn

    cfg = ProcessConfig(dark=10.0)
    assert process_batch_fn(cfg) is process_batch_fn(cfg)
    fn = process_batch_fn(cfg)
    batch = rng.integers(100, 3000, (3, 16, 16)).astype(np.uint16)
    out = fn(batch)
    assert isinstance(out, jax.Array)
    np.testing.assert_array_equal(
        np.asarray(out),
        np.stack([np.asarray(process_img(b, cfg)) for b in batch]))

"""End-to-end pipeline tests: the orchestrator CLI, the deconvolution
pipeline, and channel alignment, all on synthetic data."""

import numpy as np
import pytest
from scipy.ndimage import convolve as ndi_convolve, gaussian_filter

from ipp_tpu.io import tiff as tio
from ipp_tpu.ops.psf import gaussian_psf
from tests.synth import cut_tiles, make_phantom, write_tile_grid


def test_process_images_cli_end_to_end(tmp_path, rng):
    """Tiny 2x2 grid channel -> stitched series + npz via the CLI main()."""
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (6, 200, 200), smooth=8.0)
    tiles, offsets = cut_tiles(vol, 2, 2, (120, 120), 48, jitter=3, rng=rng)
    ch_dir = tmp_path / "raw" / "Ex_488_Em_525"
    ch_dir.mkdir(parents=True)
    # dir names are stage positions in tenths of um; the 15x objective reads
    # them back at 0.41 um/px
    write_tile_grid(ch_dir, tiles, overlap_nominal_px=48,
                    voxel_um=(0.41, 0.41, 0.1))

    rc = main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x",
        "--no-preprocess",
        "--search-radius", "8",
        "--subvol-dim", "6",
        "--downsampled-voxel", "5.0",
    ])
    assert rc == 0
    out_dir = tmp_path / "stitched" / "Ex_488_Em_525"
    outs = sorted(out_dir.glob("img_*.tif"))
    assert len(outs) == 6
    img = tio.imread(outs[3])
    assert img.dtype == np.uint16
    assert img.max() > 0
    # placement xml exists and parses
    from ipp_tpu.geometry.stacks import TileGrid

    grid = TileGrid.from_xml(tmp_path / "stitched" /
                             "Ex_488_Em_525_placement.xml")
    assert grid.n_rows == 2
    # npz exists with I and xI
    npz = np.load(tmp_path / "stitched" / "Ex_488_Em_525_zyx5.0um.npz",
                  allow_pickle=True)
    assert "I" in npz and "xI" in npz
    assert npz["I"].ndim == 3


def test_deconvolve_pipeline(tmp_path, rng):
    from ipp_tpu.pipeline.deconvolve import autosplit, deconvolve_volume  # noqa: F401

    truth = np.zeros((12, 64, 64), np.float32)
    pts = rng.integers(4, 60, (20, 2))
    truth[rng.integers(2, 10, 20), pts[:, 0], pts[:, 1]] = 3000.0
    truth = gaussian_filter(truth, 1.0)
    psf = gaussian_psf((5, 7, 7), (1.0, 1.5, 1.5))
    blurred = ndi_convolve(truth, psf, mode="constant")

    in_dir = tmp_path / "blurred"
    in_dir.mkdir()
    for z in range(truth.shape[0]):
        tio.imwrite(in_dir / f"img_{z:06d}.tif",
                    np.clip(blurred[z], 0, 65535).astype(np.uint16))

    out = deconvolve_volume(in_dir, tmp_path / "dec", psf, niter=8,
                            max_block_elems=48 * 64 * 64, strict_accuracy=False)
    outs = sorted(out.glob("img_*.tif"))
    assert len(outs) == 12
    dec = np.stack([tio.imread(p) for p in outs]).astype(np.float32)
    # deconvolved correlates better with truth than blurred does
    c_blur = np.corrcoef(blurred.ravel(), truth.ravel())[0, 1]
    c_dec = np.corrcoef(dec.ravel(), truth.ravel())[0, 1]
    assert c_dec > c_blur, (c_blur, c_dec)


def test_autosplit_halo_and_coverage():
    from ipp_tpu.pipeline.deconvolve import autosplit

    plans, halo, planned = autosplit((50, 300, 200), (9, 9, 9),
                            max_block_elems=120 * 120 * 60, strict_accuracy=False)
    # overlap-save halo: 4x the PSF half-extent, floor 8 (wraparound decays
    # below 1e-4 NRMSE at 4 half-widths; docs/STATUS.md)
    assert halo == (16, 16, 16)
    # full coverage, no overlap of cores
    seen = np.zeros((50, 300, 200), np.int8)
    for p in plans:
        (z0, z1), (y0, y1), (x0, x1) = p.core
        seen[z0:z1, y0:y1, x0:x1] += 1
    assert (seen == 1).all()


# bytes_limit JAX reports for one 80 GB H100 at the default 0.75 memory
# fraction
H100_BYTES_LIMIT = 63763120128


def test_autosplit_production_plan_is_measured_512_cube():
    """The reference benchmark volume (835.7 Gvox,
    LsDeconvolveMultiGPU/README.md:58-61) with the reference's optics PSF
    on one 80 GB H100 plans the block the measured cost model ranks best:
    radix-2/5 axes only (the sweep's fastest per voxel), 0.8 Gvox, inside
    the memory budget.  Guards the cost model against drift re-flipping
    the plan."""
    from ipp_tpu.pipeline.deconvolve import RL_BYTES_PER_VOXEL, autosplit

    plans, halo, planned = autosplit((7912, 12778, 8266), (13, 9, 9),
                                     bytes_limit=H100_BYTES_LIMIT)
    assert planned == (625, 1024, 1250)
    assert halo == (24, 16, 16)
    assert len(plans) == 1274
    assert np.prod(planned) * RL_BYTES_PER_VOXEL <= H100_BYTES_LIMIT


def test_autosplit_strict_accuracy_gate():
    """Strict mode (the deconvolve_volume default) refuses a block budget
    that forces the halo to <=2x the PSF half-extent (core NRMSE beyond the
    1e-3 spec; VERDICT r2 item 7 / reference halo semantics
    LsDeconv.m:173-174); non-strict proceeds with the warning."""
    import pytest as _pytest

    from ipp_tpu.pipeline.deconvolve import autosplit

    shape, psf = (40, 40, 40), (9, 9, 9)
    tiny = 24 * 24 * 24  # forces the halo ladder below 3x
    with _pytest.raises(ValueError, match="strict accuracy"):
        autosplit(shape, psf, max_block_elems=tiny, strict_accuracy=True)
    with _pytest.warns(UserWarning, match="halo"):
        plans, halo, _ = autosplit(shape, psf, max_block_elems=tiny,
                                   strict_accuracy=False)
    assert plans
    # an ample budget reaches the full 4x halo: strict mode passes silently
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        plans4, halo4, _ = autosplit((50, 300, 200), psf,
                                     max_block_elems=120 * 120 * 60,
                                     strict_accuracy=True)
    assert halo4 == (16, 16, 16) and plans4


def test_channel_alignment_recovers_shift(rng):
    from ipp_tpu.pipeline.align_channels import align_volumes, roll_pad

    vol = make_phantom(rng, (16, 96, 96), smooth=5.0).astype(np.float32)
    shift = (1, 4, -3)
    moved = roll_pad(vol.copy(), shift)
    aligned, found = align_volumes(vol, moved, max_iter=8)
    assert tuple(found) == tuple(-s for s in shift), found


def test_composite_writer(tmp_path, rng):
    from ipp_tpu.pipeline.align_channels import write_composite_series

    a_dir = tmp_path / "chA"
    b_dir = tmp_path / "chB"
    a_dir.mkdir()
    b_dir.mkdir()
    for z in range(3):
        tio.imwrite(a_dir / f"img_{z:06d}.tif",
                    np.full((32, 32), 100, np.uint8))
        tio.imwrite(b_dir / f"img_{z:06d}.tif",
                    np.full((32, 32), 50, np.uint8))
    out = write_composite_series({"A": a_dir, "B": b_dir},
                                 {"A": "r", "B": "g"}, tmp_path / "rgb")
    outs = sorted(out.glob("composite_*.tif"))
    assert len(outs) == 3
    img = tio.imread(outs[0])
    assert img.shape == (32, 32, 3)
    assert img[0, 0, 0] == 100 and img[0, 0, 1] == 50 and img[0, 0, 2] == 0


def test_process_images_multichannel_exports(tmp_path, rng):
    """Two channels -> stitched + .ims + TeraFly + RGB composite."""
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (4, 160, 160), smooth=6.0)
    for ch in ("Ex_488_Em_525", "Ex_561_Em_600"):
        tiles, _ = cut_tiles(vol, 2, 2, (100, 100), 48, jitter=2, rng=rng)
        ch_dir = tmp_path / "raw" / ch
        ch_dir.mkdir(parents=True)
        write_tile_grid(ch_dir, tiles, overlap_nominal_px=48,
                        voxel_um=(0.41, 0.41, 0.1))
    rc = main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x", "--no-preprocess",
        "--search-radius", "6", "--subvol-dim", "4",
        "--imaris", "--terafly", "--rgb-composite",
    ])
    assert rc == 0
    assert (tmp_path / "stitched" / "Ex_488_Em_525.ims").exists()
    assert any((tmp_path / "stitched" / "Ex_488_Em_525_terafly").iterdir())
    comps = sorted((tmp_path / "stitched" / "composite").glob("*.tif"))
    assert len(comps) == 4
    img = tio.imread(comps[0])
    assert img.ndim == 3 and img.shape[2] == 3
    # blue (488) and green (561) populated, red empty
    assert img[..., 2].max() > 0 and img[..., 1].max() > 0
    assert img[..., 0].max() == 0


def test_process_images_composite_path_flag(tmp_path, rng):
    """The reference's path-valued --composite flag (process_images.py:
    1638-1640) implies the RGB composite and writes it under the given
    PARENT directory as <input>_composite (process_images.py:1100-1108)."""
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (3, 150, 150), smooth=6.0)
    for ch in ("Ex_488_Em_525", "Ex_561_Em_600"):
        tiles, _ = cut_tiles(vol, 2, 2, (96, 96), 48, jitter=1, rng=rng)
        ch_dir = tmp_path / "raw" / ch
        ch_dir.mkdir(parents=True)
        write_tile_grid(ch_dir, tiles, overlap_nominal_px=48,
                        voxel_um=(0.41, 0.41, 0.1))
    (tmp_path / "rgb_out").mkdir()
    rc = main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x", "--no-preprocess",
        "--search-radius", "4", "--subvol-dim", "3",
        "--composite", str(tmp_path / "rgb_out"),
        "--exclude_gpus", "0", "--vram_mem_fraction_gpu0", "0.8",
    ])
    assert rc == 0
    comps = sorted((tmp_path / "rgb_out" / "raw_composite").glob("*.tif"))
    assert len(comps) == 3
    # a missing --composite parent is an up-front error, as in the
    # reference (process_images.py:1104-1107)
    assert main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x", "--no-preprocess",
        "--composite", str(tmp_path / "missing_parent"),
    ]) == 2
    img = tio.imread(comps[0])
    assert img.ndim == 3 and img.shape[2] == 3


def test_deconvolve_pipeline_mesh_matches_single_device(tmp_path, rng):
    """The mesh-batched pipeline path produces the same bricks and output
    series as the single-device path (VERDICT round-1 item 2: the pipeline,
    not just the op, must drive the mesh)."""
    from ipp_tpu.parallel.mesh import make_mesh
    from ipp_tpu.pipeline.deconvolve import deconvolve_volume

    truth = np.zeros((10, 48, 48), np.float32)
    truth[rng.integers(2, 8, 15), rng.integers(4, 44, 15),
          rng.integers(4, 44, 15)] = 3000.0
    psf = gaussian_psf((5, 5, 5), (1.0, 1.2, 1.2))
    blurred = ndi_convolve(truth, psf, mode="constant")
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for z in range(truth.shape[0]):
        tio.imwrite(in_dir / f"img_{z:06d}.tif",
                    np.clip(blurred[z], 0, 65535).astype(np.uint16))

    out1 = deconvolve_volume(in_dir, tmp_path / "d1", psf, niter=4,
                             max_block_elems=18 * 32 * 32, strict_accuracy=False,
                             mesh=make_mesh(1))
    out8 = deconvolve_volume(in_dir, tmp_path / "d8", psf, niter=4,
                             max_block_elems=18 * 32 * 32, strict_accuracy=False,
                             mesh=make_mesh(8))
    import json as _json
    m1 = _json.loads((out1 / "blocks_manifest.json").read_text())
    m8 = _json.loads((out8 / "blocks_manifest.json").read_text())
    assert m1["n_blocks"] > 1  # actually multi-block
    np.testing.assert_allclose(m1["stats"]["min"], m8["stats"]["min"],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(m1["stats"]["max"], m8["stats"]["max"],
                               rtol=1e-4, atol=1e-3)
    def dequant(brick, manifest, idx):
        qr = manifest.get("quant", {}).get(str(idx))
        if qr is None:
            return brick.astype(np.float32)
        return brick.astype(np.float32) * ((qr[1] - qr[0]) / 65535.0) + qr[0]

    for p1 in sorted((out1 / "bricks").glob("*.npy")):
        idx = int(p1.stem.split("_")[1])
        b1 = dequant(np.load(p1), m1, idx)
        b8 = dequant(np.load(out8 / "bricks" / p1.name), m8, idx)
        # quantized bricks: allow one quantization step of slack per path
        qstep = max(
            (m1.get("quant", {}).get(str(idx), [0, 0])[1]
             - m1.get("quant", {}).get(str(idx), [0, 0])[0]) / 65535.0, 0)
        np.testing.assert_allclose(b1, b8, rtol=1e-4,
                                   atol=1e-2 + 2.5 * qstep)
    for p1 in sorted(out1.glob("img_*.tif")):
        a = tio.imread(p1).astype(np.int32)
        b = tio.imread(out8 / p1.name).astype(np.int32)
        assert np.abs(a - b).max() <= 1  # u16 rounding of float-tol diffs


def test_deconvolve_pipeline_mesh_early_stop_matches_single(tmp_path, rng):
    """VERDICT r4 item 4: stop_criterion now applies on the mesh path too
    (per block, inside lax.map — decon.m:155-204 fires per block).  The
    8-device mesh run with a live stop must match the single-device
    early-stopped run, and must differ from the run-all-niter mesh run
    (proof the stop fired on the mesh path)."""
    from ipp_tpu.parallel.mesh import make_mesh
    from ipp_tpu.pipeline.deconvolve import deconvolve_volume

    truth = np.zeros((10, 48, 48), np.float32)
    truth[rng.integers(2, 8, 15), rng.integers(4, 44, 15),
          rng.integers(4, 44, 15)] = 3000.0
    psf = gaussian_psf((5, 5, 5), (1.0, 1.2, 1.2))
    blurred = ndi_convolve(truth, psf, mode="constant")
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for z in range(truth.shape[0]):
        tio.imwrite(in_dir / f"img_{z:06d}.tif",
                    np.clip(blurred[z], 0, 65535).astype(np.uint16))

    kw = dict(niter=8, max_block_elems=18 * 32 * 32,
              strict_accuracy=False)
    # an always-true criterion pins the iteration count to 2 on every
    # block, so mesh-vs-single parity below is exact-iteration parity
    out1 = deconvolve_volume(in_dir, tmp_path / "d1", psf,
                             stop_criterion=1e6, **kw)
    out8 = deconvolve_volume(in_dir, tmp_path / "d8", psf,
                             stop_criterion=1e6, mesh=make_mesh(8), **kw)
    full8 = deconvolve_volume(in_dir, tmp_path / "f8", psf,
                              mesh=make_mesh(8), **kw)
    p_single = sorted(out1.glob("img_*.tif"))
    assert p_single
    fired = False
    for p1 in p_single:
        a = tio.imread(p1).astype(np.int32)
        b = tio.imread(out8 / p1.name).astype(np.int32)
        c = tio.imread(full8 / p1.name).astype(np.int32)
        assert np.abs(a - b).max() <= 1  # u16 rounding of float-tol diffs
        fired = fired or np.abs(b - c).max() > 2
    assert fired, "mesh early stop produced the full-niter output"


def test_streamed_channel_alignment_matches_in_ram(tmp_path, rng):
    """VERDICT round-1 item 6: big-volume channel alignment streams from
    disk (sections + one strip in RAM) and recovers the same offsets as
    the in-RAM path (reference process_big_images, align_images.py:343)."""
    from ipp_tpu.pipeline.align_channels import (align_big_channels,
                                                 align_volumes, roll_pad,
                                                 write_aligned_series)

    # ECC needs sharp gradients: a dot phantom (smooth random fields are
    # degenerate for Sobel-ECC, which real microscopy data never is)
    vol = np.zeros((24, 96, 96), np.float32)
    pts = rng.integers(6, 90, (300, 2))
    vol[rng.integers(3, 21, 300), pts[:, 0], pts[:, 1]] = 3000.0
    vol = gaussian_filter(vol, 1.5)
    true_off = (2, -3, 4)
    mov = roll_pad(vol.copy(), true_off)
    ref_dir = tmp_path / "ref"
    mov_dir = tmp_path / "mov"
    ref_dir.mkdir()
    mov_dir.mkdir()
    for z in range(vol.shape[0]):
        tio.imwrite(ref_dir / f"img_{z:06d}.tif",
                    vol[z].astype(np.uint16))
        tio.imwrite(mov_dir / f"img_{z:06d}.tif",
                    mov[z].astype(np.uint16))
    offsets = align_big_channels(ref_dir, {"ch1": mov_dir})
    _, in_ram = align_volumes(vol, mov)
    # recovered offset undoes the injected shift to within a pixel
    assert all(abs(o + t) <= 1 for o, t in zip(offsets["ch1"], true_off)), (offsets, true_off)
    assert all(abs(o - r) <= 1 for o, r in zip(offsets["ch1"], in_ram))

    out = write_aligned_series(mov_dir, tmp_path / "aligned",
                               offsets["ch1"])
    realigned = np.stack([tio.imread(p) for p in sorted(out.glob("*.tif"))])
    inner = (slice(4, -4),) * 3
    c = np.corrcoef(realigned[inner].ravel(), vol[inner].ravel())[0, 1]
    assert c > 0.95, c


def test_mip_calibrate_mode(tmp_path, rng):
    """--mip-calibrate builds a 1-plane MIP dataset with the same
    hierarchy (reference MIP-first calibration workflow)."""
    from ipp_tpu.pipeline.process_images import main as pi_main

    ch = tmp_path / "raw" / "Ex_488_Em_525"
    for x in (0, 1000):
        for y in (0, 1000):
            d = ch / f"{x:06d}" / f"{x:06d}_{y:06d}"
            d.mkdir(parents=True)
            for z in range(3):
                tio.imwrite(d / f"{z:06d}.tif",
                            (rng.random((32, 32)) * 1000).astype(np.uint16))
    rc = pi_main(["--input", str(tmp_path / "raw"),
                  "--mip-calibrate", str(tmp_path / "mip")])
    assert rc == 0
    mips = sorted((tmp_path / "mip").rglob("*.tif"))
    assert len(mips) == 4
    img = tio.imread(mips[0])
    assert img.shape == (32, 32)


def test_batch_filter_sharded_matches_unsharded(tmp_path, rng):
    """Multi-device batch_filter (shard_map over 'data') produces the same
    tiles as a plain single-device process_img pass."""
    from ipp_tpu.ops.process import ProcessConfig, process_img
    from ipp_tpu.pipeline.pystripe_cli import batch_filter

    in_dir = tmp_path / "in"
    in_dir.mkdir()
    cfg = ProcessConfig(sigma=(16, 16), wavelet="db3", dark=5.0)
    tiles = []
    for i in range(10):  # not a multiple of 8: exercises the pad path
        t = (rng.random((64, 64)) * 3000).astype(np.uint16)
        tio.imwrite(in_dir / f"t{i:02d}.tif", t)
        tiles.append(t)
    counters = batch_filter(in_dir, tmp_path / "out", cfg, batch_size=8)
    assert counters["done"] == 10
    for i, t in enumerate(tiles):
        got = tio.imread(tmp_path / "out" / f"t{i:02d}.tif")
        ref = np.asarray(process_img(t[None], cfg))[0]
        np.testing.assert_array_equal(got, ref)


def test_pystripe_cli_reference_surface(tmp_path, rng):
    """Reference-spelled flags parse and act: --down_sample single-int,
    --size_x/--size_y, --compression_method/-level, --padding_mode,
    --bit_shift_to_right; and single-FILE input mode writes one
    *_destriped image (reference main, pystripe/core.py:2135-2161)."""
    from ipp_tpu.pipeline import pystripe_cli

    in_dir = tmp_path / "tiles"
    in_dir.mkdir()
    for i in range(3):
        tio.imwrite(in_dir / f"t{i}.tif",
                    (rng.random((64, 64)) * 3000).astype(np.uint16))
    rc = pystripe_cli.main([
        "--input", str(in_dir), "--output", str(tmp_path / "out"),
        "--sigma1", "16", "--sigma2", "16", "--wavelet", "db3",
        "--padding_mode", "wrap", "--down_sample", "2",
        "--size_x", "16", "--size_y", "24",
        "--compression_method", "ADOBE_DEFLATE", "--compression_level", "3",
        "--bit_shift_to_right", "8", "--chunks", "4"])
    assert rc == 0
    outs = sorted((tmp_path / "out").glob("*.tif"))
    assert len(outs) == 3
    img = tio.imread(outs[0])
    assert img.shape == (24, 16)  # new_size (y, x) wins over down_sample
    # single-file mode
    one = in_dir / "t0.tif"
    rc = pystripe_cli.main(["--input", str(one), "--sigma1", "8",
                            "--wavelet", "db3"])
    assert rc == 0
    assert (in_dir / "t0_destriped.tif").exists()


def test_pystripe_cli_dcimg_mode(tmp_path, rng):
    """--zstep switches the scan to DCIMG mode: every frame becomes one
    z-position-named output plane (reference process_dc_images,
    pystripe/core.py:1649-1684: z{start + i*step_tenths:08.1f}.tif with
    the file name as the starting z in tenths of a micron)."""
    from ipp_tpu.io.dcimg import DCIMGFile
    from ipp_tpu.pipeline import pystripe_cli

    in_dir = tmp_path / "cam"
    in_dir.mkdir()
    frames = (rng.random((4, 32, 32)) * 2000).astype(np.uint16)
    DCIMGFile.write(in_dir / "0015250.dcimg", frames)
    rc = pystripe_cli.main([
        "--input", str(in_dir), "--output", str(tmp_path / "out"),
        "--sigma1", "0", "--zstep", "1.5"])
    assert rc == 0
    outs = sorted((tmp_path / "out").glob("*.tif"))
    assert [p.name for p in outs] == [
        f"z{15250 + i * 15.0:08.1f}.tif" for i in range(4)]
    got = tio.imread(outs[2])
    assert got.shape == (32, 32)
    # row 0's first 4 pixels are camera metadata; the reader substitutes
    # them from row 1 (the reference dcimg.cpp fixup)
    np.testing.assert_array_equal(got[1:], frames[2][1:])
    np.testing.assert_array_equal(got[0, 4:], frames[2][0, 4:])


def test_deconvolve_pipeline_destripe_sigma_f32_bricks(tmp_path, rng):
    """The z-destripe fork keeps f32 bricks (no quantization) and still
    produces a sharpened output series."""
    import json as _json

    truth = np.zeros((12, 64, 64), np.float32)
    truth[rng.integers(2, 10, 20), rng.integers(4, 60, 20),
          rng.integers(4, 60, 20)] = 3000.0
    truth = gaussian_filter(truth, 1.0)
    psf = gaussian_psf((5, 7, 7), (1.0, 1.5, 1.5))
    blurred = ndi_convolve(truth, psf, mode="constant")
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for z in range(truth.shape[0]):
        tio.imwrite(in_dir / f"img_{z:06d}.tif",
                    np.clip(blurred[z], 0, 65535).astype(np.uint16))
    from ipp_tpu.pipeline.deconvolve import deconvolve_volume

    out = deconvolve_volume(in_dir, tmp_path / "dec", psf, niter=6,
                            destripe_sigma=16.0,
                            max_block_elems=48 * 64 * 64, strict_accuracy=False)
    outs = sorted(out.glob("img_*.tif"))
    assert len(outs) == 12
    m = _json.loads((out / "blocks_manifest.json").read_text())
    assert m.get("quant") == {}  # f32 bricks on the destripe fork
    bricks = sorted((out / "bricks").glob("*.npy"))
    assert all(np.load(b).dtype == np.float32 for b in bricks)


def test_process_images_bleach_correction_merge(tmp_path, rng):
    """--bleach-correction routes the merged planes through the reference's
    merge-stage process_img (sigma=2*tile coif15 dual-band destriping +
    estimated clips, process_images.py:696-727; its Butterworth flat is
    disabled upstream — frequency=None, :634): directional stripe power
    in the stitched planes drops, and the auto-estimated bit shift drives
    the 8-bit output."""
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (4, 160, 160), smooth=8.0)
    tiles, offsets = cut_tiles(vol, 2, 2, (100, 100), 40, jitter=2, rng=rng)
    # inject horizontal stripes (per-row gain ripple), the artifact this
    # merge-stage mode removes
    gains = 1.0 + 0.25 * np.sin(np.arange(100) * 2 * np.pi / 7)[:, None]
    tiles = [[np.clip(t.astype(np.float32) * gains, 0, 65535)
              .astype(np.uint16) for t in row] for row in tiles]
    ch_dir = tmp_path / "raw" / "Ex_488_Em_525"
    ch_dir.mkdir(parents=True)
    write_tile_grid(ch_dir, tiles, overlap_nominal_px=40,
                    voxel_um=(0.41, 0.41, 0.1))

    def stripe_power(img):
        x = np.log1p(img.astype(np.float64))
        rows = x.mean(axis=1)
        # high-frequency row-mean ripple = stripe signature
        from scipy.ndimage import gaussian_filter1d

        return float(np.abs(rows - gaussian_filter1d(rows, 5)).mean())

    outs = {}
    for mode, flags in (("plain", ["--auto-params"]),
                        ("bleach", ["--bleach-correction"])):
        rc = main([
            "--input", str(tmp_path / "raw"),
            "--stitched", str(tmp_path / f"stitched_{mode}"),
            "--objective", "15x",
            "--no-preprocess",
            "--search-radius", "6",
            "--subvol-dim", "4",
            "--convert-to-8bit",
        ] + flags)
        assert rc == 0
        files = sorted((tmp_path / f"stitched_{mode}" / "Ex_488_Em_525")
                       .glob("img_*.tif"))
        assert len(files) == 4
        img = np.asarray(tio.imread(files[2]))
        assert img.dtype == np.uint8 and img.max() > 0
        outs[mode] = img
    # destriping the merged planes removes a solid share of the injected
    # ripple (the coif15 bidirectional config measures ~0.36x in
    # isolation; db9 unidirectional would reach ~0.002x but the
    # reference's merge stage uses the former)
    assert stripe_power(outs["bleach"]) < 0.6 * stripe_power(outs["plain"])


def test_process_images_rot90(tmp_path, rng):
    """--rot90 rotates the stitched planes 90 degrees (reference
    need_rotation_stitched_tif, process_images.py:731,1695)."""
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (3, 140, 180), smooth=8.0)
    tiles, _ = cut_tiles(vol, 2, 2, (90, 110), 40, jitter=2, rng=rng)
    ch_dir = tmp_path / "raw" / "Ex_488_Em_525"
    ch_dir.mkdir(parents=True)
    write_tile_grid(ch_dir, tiles, overlap_nominal_px=40,
                    voxel_um=(0.41, 0.41, 0.1))
    common = ["--input", str(tmp_path / "raw"), "--objective", "15x",
              "--no-preprocess", "--search-radius", "6",
              "--subvol-dim", "3"]
    assert main(common + ["--stitched", str(tmp_path / "a")]) == 0
    assert main(common + ["--stitched", str(tmp_path / "b"),
                          "--rot90"]) == 0
    a = np.asarray(tio.imread(sorted(
        (tmp_path / "a" / "Ex_488_Em_525").glob("img_*.tif"))[1]))
    b = np.asarray(tio.imread(sorted(
        (tmp_path / "b" / "Ex_488_Em_525").glob("img_*.tif"))[1]))
    np.testing.assert_array_equal(b, np.rot90(a))


def test_process_images_stitch_on_reference_alignment(tmp_path, rng):
    """--stitch-on-reference-alignment reuses the reference channel's
    placement for the other channels (reference
    --stitch_based_on_reference_channel_alignment,
    process_images.py:1293-1308): identical tile offsets, per-channel
    pixel content."""
    from ipp_tpu.geometry.stacks import TileGrid
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (3, 160, 160), smooth=6.0)
    tiles_a, _ = cut_tiles(vol, 2, 2, (100, 100), 40, jitter=2, rng=rng)
    # second channel: same geometry (cut with the same rng state NOT
    # required — same nominal grid), scaled content
    tiles_b = [[np.clip(t.astype(np.float32) * 0.5, 0, 65535)
                .astype(np.uint16) for t in row] for row in tiles_a]
    for ch, tiles in (("Ex_488_Em_525", tiles_a), ("Ex_561_Em_600",
                                                   tiles_b)):
        ch_dir = tmp_path / "raw" / ch
        ch_dir.mkdir(parents=True)
        write_tile_grid(ch_dir, tiles, overlap_nominal_px=40,
                        voxel_um=(0.41, 0.41, 0.1))
    rc = main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x", "--no-preprocess",
        "--search-radius", "6", "--subvol-dim", "3",
        "--stitch-on-reference-alignment",
        "--reference-channel", "Ex_488_Em_525",
    ])
    assert rc == 0
    ga = TileGrid.from_xml(tmp_path / "stitched" /
                           "Ex_488_Em_525_placement.xml")
    gb = TileGrid.from_xml(tmp_path / "stitched" /
                           "Ex_561_Em_600_placement.xml")
    offs_a = [(s.abs_v, s.abs_h, s.abs_d) for s in ga.flattened()]
    offs_b = [(s.abs_v, s.abs_h, s.abs_d) for s in gb.flattened()]
    assert offs_a == offs_b
    # each channel merged its OWN pixels
    pa = np.asarray(tio.imread(sorted(
        (tmp_path / "stitched" / "Ex_488_Em_525").glob("img_*.tif"))[1]))
    pb = np.asarray(tio.imread(sorted(
        (tmp_path / "stitched" / "Ex_561_Em_600").glob("img_*.tif"))[1]))
    assert pa.shape == pb.shape
    ratio = pb[pa > 200].astype(float) / pa[pa > 200].astype(float)
    assert abs(np.median(ratio) - 0.5) < 0.05


def test_process_images_background_subtraction(tmp_path, rng):
    """--background-subtraction runs lightsheet local-percentile cleaning
    on the merged planes (reference "lightsheet": need_lightsheet_cleaning
    at the merge stage, process_images.py:720,1212-1213); the channel
    list restricts it."""
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (3, 150, 150), smooth=6.0)
    # add a smooth additive background gradient the cleaning removes
    yy = np.linspace(0, 3000, 150, dtype=np.float32)[None, :, None]
    vol = np.clip(vol.astype(np.float32) + yy, 0, 65535).astype(np.uint16)
    tiles, _ = cut_tiles(vol, 2, 2, (95, 95), 40, jitter=2, rng=rng)
    for ch in ("Ex_488_Em_525", "Ex_561_Em_600"):
        ch_dir = tmp_path / "raw" / ch
        ch_dir.mkdir(parents=True)
        write_tile_grid(ch_dir, tiles, overlap_nominal_px=40,
                        voxel_um=(0.41, 0.41, 0.1))
    rc = main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x", "--no-preprocess",
        "--search-radius", "6", "--subvol-dim", "3",
        "--background-subtraction",
        "--background-subtraction-channels", "Ex_488_Em_525",
    ])
    assert rc == 0
    cleaned = np.asarray(tio.imread(sorted(
        (tmp_path / "stitched" / "Ex_488_Em_525").glob("img_*.tif"))[1]))
    untouched = np.asarray(tio.imread(sorted(
        (tmp_path / "stitched" / "Ex_561_Em_600").glob("img_*.tif"))[1]))
    # the cleaned channel's background level drops well below the other's
    assert np.percentile(cleaned, 20) < 0.5 * np.percentile(untouched, 20)
    # and an unknown channel errors out
    assert main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched2"),
        "--objective", "15x", "--no-preprocess",
        "--background-subtraction",
        "--background-subtraction-channels", "Ex_000_Em_000",
    ]) == 2


def test_process_images_isotropic_resize(tmp_path, rng):
    """--isotropic resizes tiles in-plane during preprocessing so voxels
    become isotropic (reference need_up_sizing/need_down_sampling,
    process_images.py:1163-1186): stitched planes shrink by vxy/vz."""
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (3, 160, 160), smooth=6.0)
    tiles, _ = cut_tiles(vol, 2, 2, (100, 100), 40, jitter=2, rng=rng)
    ch_dir = tmp_path / "raw" / "Ex_488_Em_525"
    ch_dir.mkdir(parents=True)
    write_tile_grid(ch_dir, tiles, overlap_nominal_px=40,
                    voxel_um=(0.41, 0.41, 1.0))
    # synth writes plane names as the z index; re-step them to 1.0 um
    # (10 tenths) so get_voxel_sizes reads vz=1.0 > vxy=0.41 ->
    # down-sizing tiles by 0.41
    for p in ch_dir.glob("*/*/*.tif"):
        p.rename(p.parent / f"{int(p.stem) * 10:06d}.tif")
    rc = main([
        "--input", str(tmp_path / "raw"),
        "--preprocessed", str(tmp_path / "pre"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x",
        "--sigma1", "0", "--sigma2", "0",  # preprocess = resize only
        "--isotropic",
        "--search-radius", "4", "--subvol-dim", "3",
    ])
    assert rc == 0
    pre = sorted((tmp_path / "pre" / "Ex_488_Em_525").rglob("*.tif"))
    assert pre
    t = np.asarray(tio.imread(pre[0]))
    assert t.shape == (41, 41)  # round(100 * 0.41 / 1.0)
    outs = sorted((tmp_path / "stitched" / "Ex_488_Em_525")
                  .glob("img_*.tif"))
    assert len(outs) == 3
    merged = np.asarray(tio.imread(outs[1]))
    assert merged.max() > 0 and max(merged.shape) < 100
    # --isotropic without preprocessing is an error
    assert main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "s2"),
        "--objective", "15x", "--no-preprocess", "--isotropic",
    ]) == 2


def test_deconvolve_wiener_dryrun_cache_startblock(tmp_path, rng):
    """The decwrap surface extras: --dry-run plans without computing,
    --cache-drive relocates bricks, --start-block skips low blocks,
    --adaptive-psf routes through the blind-Wiener core and still
    sharpens (reference decwrap.py:252-322, decon.m:206-321)."""
    from ipp_tpu.pipeline.deconvolve import deconvolve_volume

    truth = np.zeros((8, 48, 48), np.float32)
    pts = rng.integers(4, 44, (12, 2))
    truth[rng.integers(1, 7, 12), pts[:, 0], pts[:, 1]] = 3000.0
    truth = gaussian_filter(truth, 1.0)
    psf = gaussian_psf((5, 7, 7), (1.0, 1.5, 1.5))
    blurred = ndi_convolve(truth, psf, mode="constant")
    in_dir = tmp_path / "blurred"
    in_dir.mkdir()
    for z in range(truth.shape[0]):
        tio.imwrite(in_dir / f"img_{z:06d}.tif",
                    np.clip(blurred[z], 0, 65535).astype(np.uint16))

    # dry run: no bricks, no output planes
    out = deconvolve_volume(in_dir, tmp_path / "dry", psf, niter=2,
                            strict_accuracy=False, dry_run=True,
                            cache_dir=tmp_path / "cache")
    assert not list((tmp_path / "cache").glob("*.npy"))
    assert not list((tmp_path / "dry").glob("img_*.tif"))

    # adaptive PSF + relocated cache
    out = deconvolve_volume(in_dir, tmp_path / "dec", psf, niter=6,
                            strict_accuracy=False, adaptive_psf=True,
                            cache_dir=tmp_path / "cache")
    assert list((tmp_path / "cache").glob("block_*.npy"))
    assert not (tmp_path / "dec" / "bricks").exists()
    outs = sorted(out.glob("img_*.tif"))
    assert len(outs) == 8
    dec = np.stack([tio.imread(p) for p in outs]).astype(np.float32)
    # blind deconvolution is unstable on sparse phantoms (the reference
    # flags adaptive_psf experimental; see test_wiener_rl_refines_psf) —
    # the contract is finite output with retained structure, not
    # improvement over the blurred input
    assert np.isfinite(dec).all() and dec.max() > 0
    c_dec = np.corrcoef(dec.ravel(), truth.ravel())[0, 1]
    assert c_dec > 0.25, c_dec

    # start_block skips everything below the given index
    deconvolve_volume(in_dir, tmp_path / "dec2", psf, niter=2,
                      strict_accuracy=False,
                      cache_dir=tmp_path / "cache2", start_block=10 ** 6)
    assert not list((tmp_path / "cache2").glob("block_*.npy"))


def test_process_images_sparse_grid(tmp_path, rng):
    """A grid missing an entire stack (sparse acquisition, the reference's
    --sparse_data role) still stitches: the missing cell is a None stack,
    the remaining tiles align/place/merge normally."""
    import shutil

    from ipp_tpu.geometry.stacks import TileGrid
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (3, 220, 220), smooth=8.0)
    tiles, _ = cut_tiles(vol, 3, 3, (90, 90), 40, jitter=2, rng=rng)
    ch_dir = tmp_path / "raw" / "Ex_488_Em_525"
    ch_dir.mkdir(parents=True)
    write_tile_grid(ch_dir, tiles, overlap_nominal_px=40,
                    voxel_um=(0.41, 0.41, 0.1))
    # remove a CORNER stack entirely
    victims = sorted(ch_dir.glob("*/*"))
    shutil.rmtree(victims[0])
    grid = TileGrid.from_directory(ch_dir, voxel_um=(0.41, 0.41, 0.1))
    assert grid.n_rows == 3 and grid.n_cols == 3
    assert sum(s is None for row in grid.stacks for s in row) == 1

    rc = main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x", "--no-preprocess", "--skip-inspection",
        "--search-radius", "6", "--subvol-dim", "3",
    ])
    assert rc == 0
    outs = sorted((tmp_path / "stitched" / "Ex_488_Em_525")
                  .glob("img_*.tif"))
    assert len(outs) == 3
    img = np.asarray(tio.imread(outs[1]))
    assert img.max() > 0
    # the placement XML round-trips with 8 stacks
    g2 = TileGrid.from_xml(tmp_path / "stitched" /
                           "Ex_488_Em_525_placement.xml")
    assert len(g2.flattened()) == 8


def test_process_images_reference_default_flags():
    """The CLI surface mirrors the reference's defaults: gaussian denoise
    and destriping ON (reference process_images.py:1667 --no_gaussian /
    --no-de_stripe), MAX tile blending unless --cosine-blending
    (reference :374,1346), and the compat no-ops --skipconf /
    --enable-axis-correction parse cleanly."""
    from ipp_tpu.pipeline.process_images import build_parser

    p = build_parser()
    base = ["--input", "/x", "--stitched", "/y"]
    a = p.parse_args(base)
    assert a.gaussian is True
    assert a.de_stripe is True
    assert a.cosine_blending is False
    assert a.bleach_correction_channels == []

    a = p.parse_args(base + ["--no-gaussian", "--no-de-stripe",
                             "--cosine-blending", "--skipconf",
                             "--enable-axis-correction",
                             "--bleach-correction",
                             "--bleach-correction-channels",
                             "Ex_488_Em_525"])
    assert a.gaussian is False
    assert a.de_stripe is False
    assert a.cosine_blending is True
    assert a.skipconf and a.enable_axis_correction
    assert a.bleach_correction_channels == ["Ex_488_Em_525"]
    # reference-style underscore aliases
    a = p.parse_args(base + ["--no-de_stripe", "--cosine_blending"])
    assert a.de_stripe is False and a.cosine_blending is True


def test_check_block_coverage_production_assert():
    """The in-pipeline coverage invariant (the reference's
    check_block_coverage_planes, LsDeconv.m:421) — every autosplit
    output passes it; a tampered plan list fails loudly."""
    import pytest as _pytest

    from ipp_tpu.pipeline.deconvolve import (BlockPlan, _check_block_coverage,
                                             autosplit)

    plans, halo, _ = autosplit((50, 300, 200), (9, 9, 9),
                               max_block_elems=120 * 120 * 60,
                               strict_accuracy=False)
    _check_block_coverage(plans, (50, 300, 200))  # passes (also run inside)
    with _pytest.raises(AssertionError, match="ragged|uncovered|covers"):
        _check_block_coverage(plans[:-1], (50, 300, 200))
    hole = list(plans)
    (z0, z1), yx0, yx1 = hole[0].core
    hole[0] = BlockPlan(hole[0].index, ((z0 + 1, z1), yx0, yx1),
                        hole[0].halo)
    with _pytest.raises(AssertionError):
        _check_block_coverage(hole, (50, 300, 200))


def test_stitch_test_middle_slice(tmp_path, rng):
    """--stitch-test (terastitcher --test, ui/CLI.cpp:87): ONE output —
    the middle slice blended at nominal stage coordinates, no alignment,
    no other artifacts."""
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (6, 200, 200), smooth=8.0)
    tiles, _ = cut_tiles(vol, 2, 2, (120, 120), 48, jitter=0, rng=rng)
    ch_dir = tmp_path / "raw" / "Ex_488_Em_525"
    ch_dir.mkdir(parents=True)
    write_tile_grid(ch_dir, tiles, overlap_nominal_px=48,
                    voxel_um=(0.41, 0.41, 0.1))
    rc = main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x", "--stitch-test",
    ])
    assert rc == 0
    out = (tmp_path / "stitched" / "Ex_488_Em_525_test"
           / "test_middle_slice_000000.tif")
    assert out.exists()
    img = tio.imread(out)
    assert img.ndim == 2 and img.max() > 0
    # with zero jitter, stage coordinates are exact: the slice matches
    # the phantom's middle plane over the tiled extent (blending of
    # identical overlap content)
    mid = vol[vol.shape[0] // 2][:img.shape[0], :img.shape[1]]
    corr = np.corrcoef(img.ravel().astype(np.float64),
                       mid.ravel().astype(np.float64))[0, 1]
    # stage names quantize to tenths of um (= sub-pixel placement error
    # at 0.41 um/px), so the match is high but not exact — which is the
    # POINT of the test mode: it shows stage precision
    assert corr > 0.95, corr
    # exclusive mode: the full pipeline did NOT run
    assert not (tmp_path / "stitched" / "Ex_488_Em_525").exists()


def test_stitch_mip_mode(tmp_path, rng):
    """--stitch-mip stitches the <channel>_MIP single-plane hierarchy
    (reference process_images.py:1076-1082): subvol depth forced to 1,
    no npz, stitched series of exactly one plane."""
    from ipp_tpu.pipeline.process_images import main

    vol = make_phantom(rng, (1, 200, 200), smooth=8.0)
    for ch in ("Ex_488_Em_525_MIP", "Ex_561_Em_600_MIP"):
        tiles, _ = cut_tiles(vol, 2, 2, (120, 120), 48, jitter=2, rng=rng)
        ch_dir = tmp_path / "raw" / ch
        ch_dir.mkdir(parents=True)
        write_tile_grid(ch_dir, tiles, overlap_nominal_px=48,
                        voxel_um=(0.41, 0.41, 0.1))
    (tmp_path / "rgb_out").mkdir()
    rc = main([
        "--input", str(tmp_path / "raw"),
        "--stitched", str(tmp_path / "stitched"),
        "--objective", "15x", "--no-preprocess", "--stitch-mip",
        "--search-radius", "8",
        "--downsampled-voxel", "16",  # must be ignored in MIP mode
        "--composite", str(tmp_path / "rgb_out"),
    ])
    assert rc == 0
    out_dir = tmp_path / "stitched" / "Ex_488_Em_525_MIP"
    outs = sorted(out_dir.glob("img_*.tif"))
    assert len(outs) == 1
    assert tio.imread(outs[0]).max() > 0
    assert not list((tmp_path / "stitched").glob("*.npz"))
    # MIP composite: lands in <parent>/<input>_composite_MIP (reference
    # process_images.py:1108) and both _MIP channels keep their base
    # colors (488 -> blue ch, 561 -> green ch), not a single-channel 'g'
    comps = sorted((tmp_path / "rgb_out" / "raw_composite_MIP")
                   .glob("*.tif"))
    assert len(comps) == 1
    img = tio.imread(comps[0])
    assert img[..., 1].max() > 0 and img[..., 2].max() > 0


def test_align_images_cli(tmp_path, rng):
    """Standalone align_images.py-surface CLI: downsampled ECC alignment,
    scaled application to the original series, RGB outputs, alignments
    txt, per-channel .ims (reference align_images.py:716-756)."""
    from ipp_tpu.pipeline.align_channels import main, roll_pad

    vol = make_phantom(rng, (16, 96, 96), smooth=5.0).astype(np.float32)
    shift = (1, 3, -2)
    moved = roll_pad(vol.copy(), shift)
    # originals: 2x the downsampled resolution in y/x (ratio 2), same z
    def upsample(v):
        return np.repeat(np.repeat(v, 2, axis=1), 2, axis=2)

    dirs = {}
    for name, v in (("red", vol), ("green", moved)):
        d = tmp_path / f"{name}_orig"
        d.mkdir()
        big = upsample(v).astype(np.uint16)
        for z in range(big.shape[0]):
            tio.imwrite(d / f"img_{z:06d}.tif", big[z])
        stackp = tmp_path / f"{name}_down.tif"
        tio.write_tiff_stack(stackp, v.astype(np.uint16))
        dirs[name] = (d, stackp)
    out = tmp_path / "aligned"
    rc = main([
        "--red", str(dirs["red"][0]), str(dirs["red"][1]),
        "--green", str(dirs["green"][0]), str(dirs["green"][1]),
        "-o", str(out), "--write_alignments", "--save_singles",
        "--generate_ims", "--dtype", "uint16",
        "--dx", "1", "2", "--dy", "1", "2", "--dz", "1", "1",
    ])
    assert rc == 0
    txt = (out / "alignments.txt").read_text()
    assert f"green: dz,dy,dx = {tuple(-s for s in shift)}" in txt
    rgb = sorted((out / "downsampled" / "RGB").glob("img_*.tif"))
    assert len(rgb) == 16
    plane = tio.imread(rgb[6])
    assert plane.shape == (96, 96, 3) and plane[..., 0].max() > 0
    # original green series: offsets scaled by voxel ratios (y/x x2, z x1)
    og = sorted((out / "original" / "green").glob("img_*.tif"))
    assert len(og) == 16
    assert tio.imread(og[0]).shape == (192, 192)
    # per-channel .ims exist and open
    from ipp_tpu.io.ims import ImarisReader

    r = ImarisReader(out / "downsampled" / "green.ims")
    assert r.shape == (16, 96, 96)


def test_align_images_cli_mismatched_shapes(tmp_path, rng):
    """Per-channel downsampled stacks of different shapes are center-padded
    to a common shape before aligning and the outputs trimmed back to the
    reference channel's shape (reference align_images.py:103-119,624)."""
    from ipp_tpu.pipeline.align_channels import main

    red = make_phantom(rng, (12, 64, 64), smooth=5.0).astype(np.uint16)
    green = np.pad(red, ((0, 1), (0, 0), (2, 2)))  # (13, 64, 68)
    rp, gp = tmp_path / "red.tif", tmp_path / "green.tif"
    tio.write_tiff_stack(rp, red)
    tio.write_tiff_stack(gp, green)
    for name, v in (("red", red), ("green", green)):
        d = tmp_path / f"{name}_orig"
        d.mkdir()
        for z in range(v.shape[0]):
            tio.imwrite(d / f"img_{z:06d}.tif", v[z])
    out = tmp_path / "aligned"
    rc = main([
        "--red", str(tmp_path / "red_orig"), str(rp),
        "--green", str(tmp_path / "green_orig"), str(gp),
        "-o", str(out), "--dtype", "uint16",
        "--dx", "1", "1", "--dy", "1", "1", "--dz", "1", "1",
    ])
    assert rc == 0
    rgb = sorted((out / "downsampled" / "RGB").glob("img_*.tif"))
    assert len(rgb) == 12  # trimmed back to the reference channel depth
    assert tio.imread(rgb[0]).shape == (64, 64, 3)


def _smooth(n):
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


@pytest.mark.parametrize("vol_shape", [(7912, 12778, 8266),
                                       (256, 2048, 2048), (97, 301, 1999)])
def test_autosplit_smooth_axes_tile_exactly(vol_shape):
    """Planned and work shapes are 2,3,5,7-smooth FFT sizes no larger than
    the reference's MAX_BLOCK_DIM, and the cores tile the volume exactly
    (each axis an interval chain from 0 to its extent)."""
    from ipp_tpu.pipeline.deconvolve import (MAX_BLOCK_DIM, autosplit,
                                             fft_work_shape)

    plans, halo, planned = autosplit(vol_shape, (13, 9, 9),
                                     bytes_limit=H100_BYTES_LIMIT)
    work = fft_work_shape(plans, halo)
    for p, w in zip(planned, work):
        assert _smooth(p) and _smooth(w) and w <= p <= MAX_BLOCK_DIM
    for ax in range(3):
        ivs = sorted({p.core[ax] for p in plans})
        assert ivs[0][0] == 0 and ivs[-1][1] == vol_shape[ax]
        assert all(a[1] == b[0] for a, b in zip(ivs, ivs[1:]))
        # every core plus its halos fits the work shape
        assert max(hi - lo for lo, hi in ivs) + 2 * halo[ax] <= work[ax]
    n_grid = np.prod([len({p.core[ax] for p in plans}) for ax in range(3)])
    assert len(plans) == n_grid


@pytest.mark.parametrize("bytes_limit", [16 * 2 ** 30, 4 * 2 ** 30])
def test_autosplit_respects_bytes_limit(bytes_limit):
    """The default block budget is the device's bytes_limit over the RL
    working set: the planned block's working set fits the limit, and a
    smaller limit plans smaller blocks."""
    from ipp_tpu.pipeline.deconvolve import (RL_BYTES_PER_VOXEL, autosplit,
                                             default_block_elems)

    assert default_block_elems(bytes_limit) == bytes_limit // RL_BYTES_PER_VOXEL
    _, _, planned = autosplit((7912, 12778, 8266), (13, 9, 9),
                              bytes_limit=bytes_limit)
    assert np.prod(planned) * RL_BYTES_PER_VOXEL <= bytes_limit
    _, _, bigger = autosplit((7912, 12778, 8266), (13, 9, 9),
                             bytes_limit=4 * bytes_limit)
    assert np.prod(planned) < np.prod(bigger)

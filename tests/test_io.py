import numpy as np
import pytest

from ipp_tpu.io import tiff as tio
from ipp_tpu.io import raw as rio


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("compression", [None, "zlib"])
def test_tiff_roundtrip(tmp_path, rng, dtype, compression):
    if np.issubdtype(dtype, np.integer):
        img = rng.integers(0, np.iinfo(dtype).max, (100, 130)).astype(dtype)
    else:
        img = rng.standard_normal((100, 130)).astype(dtype)
    p = tmp_path / "x.tif"
    tio.imwrite(p, img, compression=compression)
    out = tio.imread(p)
    np.testing.assert_array_equal(out, img)


def test_tiff_pil_interop(tmp_path, rng):
    """Files we write must be readable by PIL and vice versa."""
    from PIL import Image

    img = rng.integers(0, 65535, (64, 80)).astype(np.uint16)
    p = tmp_path / "ours.tif"
    tio.imwrite(p, img)
    with Image.open(p) as im:
        np.testing.assert_array_equal(np.asarray(im), img)

    p2 = tmp_path / "pil.tif"
    Image.fromarray(img).save(p2)
    np.testing.assert_array_equal(tio.imread(p2), img)


def test_tiff_rgb_roundtrip(tmp_path, rng):
    img = rng.integers(0, 255, (33, 47, 3)).astype(np.uint8)
    p = tmp_path / "rgb.tif"
    tio.imwrite(p, img)
    np.testing.assert_array_equal(tio.imread(p), img)


def test_tiff_atomic_no_partial(tmp_path, rng):
    img = rng.integers(0, 65535, (32, 32)).astype(np.uint16)
    p = tmp_path / "a.tif"
    tio.imwrite(p, img)
    assert not (tmp_path / "a.tif.tmp").exists()


def test_tiff_multi_strip(tmp_path, rng):
    img = rng.integers(0, 65535, (600, 700)).astype(np.uint16)
    p = tmp_path / "big.tif"
    tio.write_tiff(p, img, rows_per_strip=37, compression="zlib")
    np.testing.assert_array_equal(tio.read_tiff(p), img)


def test_tiff_zlib_levels(tmp_path, rng):
    """'zlib:N' selects the deflate level: every level round-trips, level
    9 compresses a redundant image at least as well as level 1, and a
    malformed level string raises."""
    img = np.tile(rng.integers(0, 4000, (16, 700)).astype(np.uint16),
                  (40, 1))
    sizes = {}
    for level in (1, 9):
        p = tmp_path / f"l{level}.tif"
        tio.write_tiff(p, img, compression=f"zlib:{level}",
                       rows_per_strip=64)
        np.testing.assert_array_equal(tio.read_tiff(p), img)
        sizes[level] = p.stat().st_size
    assert sizes[9] <= sizes[1]
    with pytest.raises(Exception):
        tio.write_tiff(tmp_path / "bad.tif", img, compression="zstd")


def test_raw_golden_cross_roundtrip(tmp_path, rng):
    """Golden vs the reference's own pystripe/raw.py (numpy-only, runs
    verbatim): files written by either side read identically by the other,
    including the big-endian-payload heuristic branch."""
    import importlib.util

    from tests.refshims import REF

    path = REF / "pystripe" / "raw.py"
    if not path.exists():
        pytest.skip(f"reference {path} unavailable")
    spec = importlib.util.spec_from_file_location("ref_raw", path)
    ref_raw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_raw)
    from ipp_tpu.io import raw as our_raw

    img = rng.integers(0, 65535, (37, 61)).astype(np.uint16)
    p_ref, p_ours = tmp_path / "ref.raw", tmp_path / "ours.raw"
    ref_raw.raw_imsave(p_ref, img)
    our_raw.raw_imsave(p_ours, img)
    assert p_ref.read_bytes() == p_ours.read_bytes()
    np.testing.assert_array_equal(np.asarray(our_raw.raw_imread(p_ref)), img)
    np.testing.assert_array_equal(np.asarray(ref_raw.raw_imread(p_ours)), img)
    # big-endian payload: byte-swapped header + pixels, both readers must
    # flip via the smaller-width heuristic (pystripe/raw.py:33-39)
    p_be = tmp_path / "be.raw"
    with open(p_be, "wb") as f:
        np.array([img.shape[1], img.shape[0]], ">u4").tofile(f)
        img.astype(">u2").tofile(f)
    np.testing.assert_array_equal(np.asarray(our_raw.raw_imread(p_be)), img)
    np.testing.assert_array_equal(np.asarray(ref_raw.raw_imread(p_be)), img)


def test_bigtiff_roundtrip(tmp_path, rng):
    img = rng.integers(0, 65535, (128, 200)).astype(np.uint16)
    p = tmp_path / "bt.tif"
    tio.write_tiff(p, img, bigtiff=True)
    np.testing.assert_array_equal(tio.read_tiff(p), img)


def test_raw_roundtrip(tmp_path, rng):
    img = rng.integers(0, 65535, (55, 77)).astype(np.uint16)
    p = tmp_path / "x.raw"
    rio.raw_imsave(p, img)
    out = rio.raw_imread(p)
    np.testing.assert_array_equal(np.asarray(out), img)


def test_partial_read_truncated_file(tmp_path, rng):
    """Truncated TIFFs salvage their intact leading strips
    (reference repair chain role, pystripe/core.py:212-250)."""
    from ipp_tpu.io.tiff import read_tiff_partial

    img = rng.integers(0, 65535, (64, 48)).astype(np.uint16)
    p = tmp_path / "t.tif"
    tio.write_tiff(p, img, rows_per_strip=8)
    data = p.read_bytes()
    # cut 30% off the end: trailing strips unreadable
    (tmp_path / "trunc.tif").write_bytes(data[:int(len(data) * 0.7)])
    out, failed = read_tiff_partial(tmp_path / "trunc.tif")
    assert out.shape == img.shape and failed > 0
    np.testing.assert_array_equal(out[:16], img[:16])  # head intact
    # imread-level salvage (after retries) returns the same plane
    out2 = tio.imread(tmp_path / "trunc.tif", retries=1)
    np.testing.assert_array_equal(out2, out)


def test_partial_read_corrupt_middle_strip(tmp_path, rng):
    from ipp_tpu.io.tiff import read_tiff_partial

    img = rng.integers(0, 65535, (64, 32)).astype(np.uint16)
    p = tmp_path / "c.tif"
    tio.write_tiff(p, img, compression="zlib", rows_per_strip=8)
    data = bytearray(p.read_bytes())
    # stomp bytes in the middle of the strip data area
    mid = len(data) // 2
    data[mid:mid + 40] = b"\xff" * 40
    (tmp_path / "bad.tif").write_bytes(bytes(data))
    out, failed = read_tiff_partial(tmp_path / "bad.tif")
    assert failed >= 1
    # at least half the strips survive and match
    rows_ok = [r for r in range(0, 64, 8)
               if np.array_equal(out[r:r + 8], img[r:r + 8])]
    assert len(rows_ok) >= 4


def test_read_tiff_fuzz_never_crashes(tmp_path, rng):
    """Malformed-file corpus: random mutations of valid TIFFs must raise
    TiffError or return an array — never crash or hang (modeled on
    load_bl_tif_test.m's fuzz suite with error-reason statistics)."""
    from ipp_tpu.io.tiff import TiffError, read_tiff, read_tiff_partial

    img = rng.integers(0, 65535, (32, 32)).astype(np.uint16)
    base = tmp_path / "base.tif"
    tio.write_tiff(base, img, compression="zlib", rows_per_strip=4)
    data = base.read_bytes()
    outcomes = {"ok": 0, "tiff_error": 0, "salvaged": 0}
    for i in range(60):
        buf = bytearray(data)
        kind = i % 3
        if kind == 0:  # truncate at a random point
            buf = buf[:int(rng.integers(4, len(buf)))]
        elif kind == 1:  # flip random bytes
            for _ in range(8):
                buf[int(rng.integers(0, len(buf)))] = int(rng.integers(256))
        else:  # corrupt the IFD area
            off = int(rng.integers(4, min(200, len(buf) - 4)))
            buf[off:off + 4] = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        p = tmp_path / f"fuzz_{i}.tif"
        p.write_bytes(bytes(buf))
        try:
            out = read_tiff(p)
            assert out.size > 0
            outcomes["ok"] += 1
        except (TiffError, Exception):
            try:
                out, failed = read_tiff_partial(p)
                outcomes["salvaged"] += 1
            except Exception:
                outcomes["tiff_error"] += 1
    assert sum(outcomes.values()) == 60, outcomes


def test_bigtiff_roundtrip_forced(tmp_path, rng):
    """BigTIFF layout (8-byte offsets) round-trips through both codecs."""
    from ipp_tpu import native

    img = rng.integers(0, 65535, (256, 300)).astype(np.uint16)
    p = tmp_path / "big.tif"
    tio.write_tiff(p, img, bigtiff=True, rows_per_strip=50)
    np.testing.assert_array_equal(tio.read_tiff(p), img)
    if native.available():
        np.testing.assert_array_equal(native.tiff_read(p), img)


def test_multipage_tiff_stack_roundtrip(tmp_path, rng):
    """3D multi-page TIFF read/write (TeraStitcher tiff3D plugin role),
    interoperable with PIL's multi-frame reader."""
    from PIL import Image

    from ipp_tpu.io.tiff import read_tiff_stack, write_tiff_stack

    vol = rng.integers(0, 65535, (7, 40, 52)).astype(np.uint16)
    p = tmp_path / "stack.tif"
    write_tiff_stack(p, vol)
    np.testing.assert_array_equal(read_tiff_stack(p), vol)
    # PIL sees all frames
    with Image.open(p) as im:
        assert im.n_frames == 7
        im.seek(3)
        np.testing.assert_array_equal(np.asarray(im), vol[3])
    # compressed variant
    p2 = tmp_path / "stackz.tif"
    write_tiff_stack(p2, vol, compression="zlib")
    np.testing.assert_array_equal(read_tiff_stack(p2), vol)


def test_nrrd_truncation_fuzz(tmp_path, rng):
    """Corrupt/truncated NRRD files raise cleanly (never return silently
    wrong arrays) — same fuzz contract as the TIFF/DCIMG/IMS corpora."""
    from ipp_tpu.io.nrrd import read_nrrd, write_nrrd

    vol = rng.integers(0, 65535, (6, 12, 10)).astype(np.uint16)
    src = tmp_path / "ok.nrrd"
    write_nrrd(src, vol)
    blob = src.read_bytes()
    back, _ = read_nrrd(src)
    np.testing.assert_array_equal(back, vol)

    for frac in (0.05, 0.3, 0.6, 0.95):
        bad = tmp_path / f"cut_{int(frac * 100)}.nrrd"
        bad.write_bytes(blob[: int(len(blob) * frac)])
        try:
            out, _ = read_nrrd(bad)
        except Exception:
            continue  # clean failure
        # a permissive parse must still return exactly the right prefix
        np.testing.assert_array_equal(out, vol)

    scrambled = bytearray(blob)
    scrambled[:4] = b"XXXX"
    bad = tmp_path / "magic.nrrd"
    bad.write_bytes(bytes(scrambled))
    with pytest.raises(ValueError, match="not a NRRD"):
        read_nrrd(bad)


def test_generic2d_plane_series(tmp_path, rng):
    """Generic 2D plugin (io/generic2d.py — the reference's optional
    opencv2D/bioformats2D input role, opencv2D.cpp:110): 16-bit PNG and
    JPEG-2000 plane series are discovered and decoded by the stack layer
    and the converter."""
    from ipp_tpu.io.generic2d import (GENERIC_2D_SUFFIXES, imread_generic,
                                      imwrite_generic)

    vol = (rng.random((4, 24, 20)) * 60000).astype(np.uint16)
    for ext in (".png", ".jp2"):
        d = tmp_path / f"series{ext[1:]}"
        d.mkdir()
        assert ext in GENERIC_2D_SUFFIXES
        for z in range(4):
            imwrite_generic(d / f"img_{z:06d}{ext}", vol[z])
        back = np.stack([imread_generic(p) for p in sorted(d.iterdir())])
        np.testing.assert_array_equal(back, vol)  # both are lossless here

        # converter source discovery
        from ipp_tpu.pipeline.convert import _open_source

        reader, nz = _open_source(d)
        assert nz == 4
        np.testing.assert_array_equal(reader(2), vol[2])

    # TileStack plane discovery accepts the generic suffixes
    from ipp_tpu.geometry.stacks import TileStack

    d = tmp_path / "stack" / "000000" / "000000_000000"
    d.mkdir(parents=True)
    for z in range(4):
        imwrite_generic(d / f"{z:06d}.png", vol[z])
    st = TileStack(root_dir=tmp_path / "stack",
                   dir_name="000000/000000_000000", row=0, col=0)
    assert st.depth == 4
    np.testing.assert_array_equal(st.read_plane(1), vol[1])

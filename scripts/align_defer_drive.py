"""Time compute_displacements (e2e align) on the bench's 5x5x48z grid —
measures the deferred-dispatch NCC restructure on the device.
  python scripts/align_defer_drive.py
"""
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ipp_tpu.utils.jaxconfig import enable_persistent_cache

enable_persistent_cache()

from ipp_tpu.geometry.stacks import TileGrid  # noqa: E402
from ipp_tpu.io import tiff as tio  # noqa: E402
from ipp_tpu.stitch.align import compute_displacements  # noqa: E402
from ipp_tpu.utils import iostat  # noqa: E402

rng = np.random.default_rng(0)
overlap, nz, tile_hw, n_rc = 64, 48, 512, 5
full = tile_hw * n_rc - overlap * (n_rc - 1)
zz = np.arange(nz, dtype=np.float32)[:, None, None]
yy = np.arange(full + 16, dtype=np.float32)[None, :, None]
xx = np.arange(full + 16, dtype=np.float32)[None, None, :]
vol = (np.sin(yy / 17.3 + zz / 3.1) * np.cos(xx / 23.7 - zz / 5.9)
       + 0.6 * np.sin(yy / 5.1) * np.sin(xx / 7.7)
       + 0.3 * np.sin((yy + xx) / 41.0 + zz / 2.3))
vol = ((vol - vol.min()) / (vol.max() - vol.min()) * 8000).astype(np.float32)
vol += rng.normal(0, 60, vol.shape).astype(np.float32)
vol = np.clip(vol, 0, 65535)

td = tempfile.TemporaryDirectory()
root = Path(td.name) / "ch"
rng2 = np.random.default_rng(1)
for r in range(n_rc):
    for c in range(n_rc):
        yn, xn = r * (tile_hw - overlap), c * (tile_hw - overlap)
        y0 = yn + int(rng2.integers(0, 7))
        x0 = xn + int(rng2.integers(0, 7))
        d = root / f"{xn * 10:06d}" / f"{xn * 10:06d}_{yn * 10:06d}"
        d.mkdir(parents=True)
        for z in range(nz):
            tio.imwrite(d / f"{z:06d}.tif",
                        vol[z, y0:y0 + tile_hw, x0:x0 + tile_hw]
                        .astype(np.uint16))

grid = TileGrid.from_directory(root)
for rep in range(4):
    iostat.enable()
    t0 = time.time()
    cands = compute_displacements(grid, overlap_v=overlap, overlap_h=overlap,
                                  displ_max_v=12, displ_max_h=12,
                                  displ_max_d=3, subvol_dim=24)
    dt = time.time() - t0
    st = iostat.disable()
    n_chunks = len(next(iter(cands.values())))
    n_pc = len(cands) * n_chunks
    print(f"rep {rep}: {dt:.2f}s ({n_pc / dt:.1f} pair-chunks/s; "
          f"decode {st.get('host_decode_s', 0):.1f}s(thr), "
          f"ncc device {st.get('device_ncc_s', 0):.1f}s)", file=sys.stderr)

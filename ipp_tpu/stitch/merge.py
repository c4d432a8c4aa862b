"""Step 6 — streamed merge of a placed tile grid to a 2D TIFF series,
with on-the-fly isotropic downsampling and NPZ export for atlas registration.

Re-design of the reference's merge path:
- TSV plane gather + blend (tsv/volume.py:575-647) -> PlaneBlender (weights
  cached across z, accumulation on device),
- parallel_image_processor's z-plane streaming runtime with process pools
  (parallel_image_processor.py:219-445) -> host thread prefetch + one device
  call per plane (XLA overlaps transfer/compute),
- alternating max/mean xy downsample + batched z block_reduce + final exact
  z resize + savez (parallel_image_processor.py:411-435, 684-751),
- resume via existing-output detection (reference --resume semantics,
  parallel_image_processor.py:281-307).
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..geometry.extent import VExtent
from ..geometry.stacks import TileGrid
from ..io import tiff as tio
from ..ops.resample import (block_reduce, isotropic_downsample_plane,
                            plan_isotropic_downsampling, resize)
from ..utils.progress import ProgressReporter
from .blend import PlaneBlender

__all__ = ["merge_to_tif_series", "downsampled_npz", "make_diag_stack"]


def _z_reduce(stack: np.ndarray, n_halvings: int) -> np.ndarray:
    """Alternating max/mean halvings along z
    (reference: parallel_image_processor.py:697-703)."""
    out = stack
    for i in range(n_halvings):
        if out.shape[0] <= 1:
            break
        out = np.asarray(block_reduce(out, (2, 1, 1),
                                      "max" if i % 2 == 0 else "mean"))
    return out


def merge_to_tif_series(
    grid: TileGrid,
    out_dir,
    cosine_blending: bool = True,
    post_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    post_fn_device: Optional[Callable] = None,
    dtype=np.uint16,
    compression: Optional[str] = None,
    tif_prefix: str = "img",
    target_voxel_um: Optional[float] = None,
    resume: bool = False,
    io_threads: int = 8,
    rotation: int = 0,
    flip_ud: bool = False,
    mipmap_level: Optional[int] = None,
    volume: Optional[VExtent] = None,
    output_pattern: Optional[str] = None,
    progress: Optional[ProgressReporter] = None,
    mesh=None,
    plane_batch: int = 1,
) -> Tuple[Path, Optional[np.ndarray]]:
    """Merge all z planes to `out_dir/img_ZZZZZZ.tif`.

    post_fn: optional per-plane post-processing (the process_img equivalent:
    destripe/bleach/8-bit), applied to the blended float plane.
    post_fn_device: the same post-processing as a device-side BATCHED
    function ((B, H, W) float32 device array -> processed device array in
    the output dtype) — on the batched blend path it runs on the canvas
    before the fetch, mesh-parallel under the plane sharding (and the
    fetch moves integer-width bytes); post_fn remains the fallback for
    the per-plane and decimated paths.  The two must agree numerically.
    target_voxel_um: if set, also accumulate the isotropic downsample and
    return it as a float32 (z', y', x') volume (caller writes the npz).
    rotation: 0/90/180/270 — rotate each output plane (reference
    convert_one_plane, tsv/convert.py:130-135); flip_ud flips the rows
    (the reference's merge-time flip, LsDeconv stack_info.flip_upside_down
    and flip_script.py's role applied inline).
    mesh: a jax.sharding.Mesh with a 'data' axis — planes then blend in
    batches of n_data sharded over the mesh, the device-mesh replacement
    for Parastitcher's MPI master_step6 output-slab fan-out (reference
    pyscripts/Parastitcher.py:519-620), with the writer threads draining
    per-device outputs.
    """
    if rotation not in (0, 90, 180, 270):
        raise ValueError(f"rotation must be 0/90/180/270, got {rotation}")
    if post_fn_device is not None and post_fn is None:
        raise ValueError("post_fn_device needs the per-plane post_fn as "
                         "the fallback for non-batched paths")
    # mipmap preview mode: every 2^level-th plane at 1/2^level resolution
    # (reference convert_to_2D_tif mipmap_level, tsv/convert.py:59-97:
    # z stepped by the decimation AND plane[::d, ::d])
    dec = 1 << mipmap_level if mipmap_level else 1
    if dec > 1 and target_voxel_um is not None:
        raise ValueError("mipmap_level is a preview mode; the isotropic "
                         "downsample needs full-res planes")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stacks = grid.flattened()
    # multi-process (jax.distributed): each process merges a contiguous
    # z slab with its LOCAL devices — the reference's Parastitcher
    # master_step6 output-slab rank fan-out (Parastitcher.py:519-620)
    # without collectives; the global mesh path stays for single-process
    # multi-device runs
    from ..parallel.distributed import is_multihost

    n_procs = 1
    try:
        import jax as _jax

        if is_multihost():
            n_procs = _jax.process_count()
    except Exception:
        pass
    if n_procs > 1:
        if target_voxel_um is not None:
            raise ValueError(
                "multi-process merge partitions z across ranks; the "
                "isotropic downsample needs the full z sequence — run "
                "it single-process")
        mesh = None
    # volume: optional sub-extent to merge; output_pattern: reference-style
    # '{z:...}'-formatted plane paths keyed by ABSOLUTE z (tsv/convert.py
    # --volume / --output-pattern semantics, :116-127,336-341)
    bbox = volume if volume is not None else grid.volume
    depth = bbox.z1 - bbox.z0

    def plane_path(zi: int) -> Path:
        if output_pattern is not None:
            return Path(output_pattern.format(z=bbox.z0 + zi))
        return out_dir / f"{tif_prefix}_{zi:06d}.tif"
    blender = PlaneBlender([s.extent for s in stacks], cosine=cosine_blending)

    ds_planes: List[np.ndarray] = []
    ds_target = None
    ds_methods = None
    n_z_halvings = 0
    if target_voxel_um is not None:
        vox_v, vox_h, vox_d = grid.voxel_um
        plane_hw = (bbox.y1 - bbox.y0, bbox.x1 - bbox.x0)
        vox_hw = (vox_v, vox_h)
        if rotation in (90, 270):
            # the downsample sees the ROTATED written plane (reference
            # parallel_image_processor.py:341-366: rot90 precedes the
            # block_reduce; calculate_down_sampling_target swaps axes)
            plane_hw = plane_hw[::-1]
            vox_hw = vox_hw[::-1]
        ds_target, ds_methods = plan_isotropic_downsampling(
            plane_hw, vox_hw, target_voxel_um)
        # z ladder: ceil(sqrt(r_z)) alternating methods over chunks of
        # floor(r_z) planes (reference parallel_image_processor.py:250-252
        # and :575 down_sampling_z_steps)
        n_z_halvings = int(np.ceil(np.sqrt(target_voxel_um / vox_d)))

    write_q: "queue.Queue[Optional[Tuple[Path, np.ndarray]]]" = queue.Queue(maxsize=16)
    errors: List[BaseException] = []

    def writer():
        while True:
            item = write_q.get()
            if item is None:
                return
            path, img = item
            try:
                # output_pattern may put z in a directory component
                path.parent.mkdir(parents=True, exist_ok=True)
                tio.imwrite(path, img, compression=compression)
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)

    writers = [threading.Thread(target=writer, daemon=True)
               for _ in range(max(1, io_threads // 2))]
    for w in writers:
        w.start()

    z_chunk: List[np.ndarray] = []
    reduced_chunks: List[np.ndarray] = []
    chunk_len = (max(1, int(target_voxel_um // vox_d))
                 if target_voxel_um is not None else 1)

    # prefetch the next batch's tile crops on reader threads while the
    # device blends the current batch (the reference overlaps via process
    # pools; here one batch of read-ahead suffices to hide IO)
    from concurrent.futures import ThreadPoolExecutor

    read_pool = ThreadPoolExecutor(max_workers=io_threads)

    use_mesh = mesh is not None and int(
        np.prod([v for v in mesh.shape.values()])) > 1
    n_data = int(mesh.shape["data"]) if use_mesh else 1
    # single device: plane_batch planes per dispatch amortize the
    # per-dispatch overhead across planes
    batch = n_data if use_mesh else max(1, int(plane_batch))
    sharding = None
    if use_mesh:
        from ..parallel.mesh import data_sharding

        sharding = data_sharding(mesh, 3)

    def batch_ext_of(zi: int, zj: int) -> VExtent:
        return VExtent(bbox.x0, bbox.x1, bbox.y0, bbox.y1,
                       bbox.z0 + zi, bbox.z0 + zj)

    def prefetch(zi: int):
        zj = min(zi + batch, depth)
        if zj <= zi:
            return {}
        ext = batch_ext_of(zi, zj)
        hits = blender.weights_for_batch(ext)
        if hits is None:  # z-staggered layout: per-plane fallback reads
            return {}
        # explicit RAM admission before committing a batch of tile reads
        # (the reference converter's free_ram_is_not_enough poll +
        # RAM-sized merge pool, parallel_image_processor.py:210-217,
        # process_images.py:644-655): one in-flight batch holds the
        # crops, the canvas and the fetched result
        from ..utils.memory import ram_gate

        batch_bytes = sum(
            4 * int(np.prod(inter.shape)) for _i, inter, _w in hits)
        ram_gate(2 * batch_bytes)
        futs = {}
        for i, inter, _w in hits:
            futs[(i, inter)] = read_pool.submit(stacks[i].imread, inter)
        return futs

    # fetch the blended canvas at the OUTPUT integer width when nothing
    # downstream needs the float values (no per-plane post-processing —
    # the isotropic downsample reads the WRITTEN plane, so it never needs
    # the float canvas): device-side rint+clip+cast halves the
    # device->host bytes of the merge's transfer-bound fetch
    fetch_dtype = (dtype if (post_fn is None
                             and np.issubdtype(np.dtype(dtype), np.integer))
                   else np.float32)

    def emit_plane(zi: int, merged: np.ndarray, already_post: bool = False):
        """Post-process + enqueue one blended plane for writing and fold
        it into the isotropic downsample accumulation.  already_post:
        the plane went through post_fn_device on the device — skip the
        host post."""
        path = plane_path(zi)
        if dec > 1:
            merged = merged[::dec, ::dec]
        if already_post or (merged.dtype == np.dtype(dtype)
                            and post_fn is None):
            merged_out = merged  # already converted on device
        else:
            merged_out = post_fn(merged) if post_fn is not None else merged
            if merged_out.dtype != np.dtype(dtype):
                # skip when post_fn already produced the target integer
                # dtype: np.rint on an integer plane would round-trip a
                # float64 copy of the full stitched canvas
                if np.issubdtype(np.dtype(dtype), np.integer):
                    info = np.iinfo(dtype)
                    merged_out = np.clip(np.rint(merged_out),
                                         info.min, info.max)
                merged_out = merged_out.astype(dtype)
        if rotation:
            merged_out = np.rot90(merged_out, rotation // 90)
        if flip_ud:
            merged_out = merged_out[::-1]
        if not (resume and path.exists()):
            write_q.put((path, np.ascontiguousarray(merged_out)))

        if target_voxel_um is not None:
            # the accumulation input is the WRITTEN plane (post-processed,
            # converted, rotated/flipped) as float32 — the reference
            # downsamples the saved fun() output
            # (parallel_image_processor.py:355-384), with uniform planes
            # short-circuited to zeros (:374-375)
            v0 = merged_out.flat[0]
            if merged_out.flat[-1] == v0 and (merged_out == v0).all():
                z_chunk.append(np.zeros(ds_target, np.float32))
                if len(z_chunk) == chunk_len:
                    reduced_chunks.append(
                        _z_reduce(np.stack(z_chunk), n_z_halvings)[0])
                    z_chunk.clear()
                if progress is not None:
                    progress.step()
                return
            small = np.asarray(isotropic_downsample_plane(
                merged_out, ds_target, ds_methods))
            z_chunk.append(small)
            if len(z_chunk) == chunk_len:
                reduced_chunks.append(
                    _z_reduce(np.stack(z_chunk), n_z_halvings)[0])
                z_chunk.clear()
        if progress is not None:
            progress.step()

    if dec > 1:
        # non-contiguous z: per-plane reads, no batch prefetch
        mm_lo, mm_hi = 0, depth
        if n_procs > 1:
            from ..parallel.distributed import process_slice

            mm_lo, mm_hi = process_slice(depth)
            mm_lo = -(-mm_lo // dec) * dec  # first decimated plane in slab
        for z in range(mm_lo, mm_hi, dec):
            path = plane_path(z)
            if resume and path.exists():
                if progress is not None:
                    progress.step()
                continue
            ext1 = batch_ext_of(z, z + 1)
            futs1 = {(i, inter): read_pool.submit(stacks[i].imread, inter)
                     for i, inter, _w in blender.weights_for(ext1)}
            merged = blender.blend_plane(
                ext1,
                lambda i, e: (futs1[(i, e)].result() if (i, e) in futs1
                              else stacks[i].imread(e)),
                dtype=fetch_dtype)
            emit_plane(z, merged)
        for _ in writers:
            write_q.put(None)
        for w in writers:
            w.join()
        read_pool.shutdown(wait=False)
        if errors:
            raise errors[0]
        return out_dir, None

    z_lo, z_hi = 0, depth
    if n_procs > 1:
        from ..parallel.distributed import process_slice

        z_lo, z_hi = process_slice(depth)
    next_futs = prefetch(z_lo) if z_hi > z_lo else {}
    # one batch of fetch-in-flight: batch k's device->host copy streams
    # back (blend_planes_async kicks copy_to_host_async) while batch
    # k+1's reads/uploads/blend dispatch — the two transfer directions
    # overlap (the reference overlaps via process pools)
    from ..utils.lagged import OneInFlight

    lag = OneInFlight()  # items: (zi, zj, finish_callable, batch_post)

    def drain(item):
        zi_, zj_, finish, bp = item
        merged3_ = finish() if callable(finish) else finish
        for k, z in enumerate(range(zi_, zj_)):
            emit_plane(z, merged3_[k], already_post=bp)

    for zi in range(z_lo, z_hi, batch):
        zj = min(zi + batch, z_hi)
        futs = next_futs
        next_futs = prefetch(zj) if zj < z_hi else {}
        paths = [plane_path(z) for z in range(zi, zj)]
        if (resume and target_voxel_um is None
                and all(p.exists() for p in paths)):
            continue
        ext = batch_ext_of(zi, zj)
        finish = blender.blend_planes_async(
            ext,
            lambda i, e: (futs[(i, e)].result() if (i, e) in futs
                          else stacks[i].imread(e)),
            dtype=(dtype if post_fn_device is not None else fetch_dtype),
            sharding=sharding, pad_to=n_data, device_post=post_fn_device)
        batch_post = finish is not None and post_fn_device is not None
        if finish is None:
            # layout changes across the batch (tiles start/end mid-z):
            # blend plane by plane — bitwise the same math, just unbatched,
            # with the same reader-thread prefetch as the batched path
            plane_futs = []
            for z in range(zi, zj):
                ext1 = batch_ext_of(z, z + 1)
                plane_futs.append({
                    (i, inter): read_pool.submit(stacks[i].imread, inter)
                    for i, inter, _w in blender.weights_for(ext1)})
            finish = np.stack([
                blender.blend_plane(
                    batch_ext_of(z, z + 1),
                    lambda i, e, fz=plane_futs[z - zi]: (
                        fz[(i, e)].result() if (i, e) in fz
                        else stacks[i].imread(e)),
                    dtype=fetch_dtype)
                for z in range(zi, zj)])
        prev = lag.put((zi, zj, finish, batch_post))
        if prev is not None:
            drain(prev)
    for item in lag.flush():
        drain(item)

    if z_chunk:
        reduced_chunks.append(_z_reduce(np.stack(z_chunk), n_z_halvings)[0])
        z_chunk.clear()

    for _ in writers:
        write_q.put(None)
    for w in writers:
        w.join()
    read_pool.shutdown(wait=False)
    if errors:
        raise errors[0]

    ds_volume = None
    if target_voxel_um is not None and reduced_chunks:
        ds_volume = np.stack(reduced_chunks)
    return out_dir, ds_volume


def downsampled_npz(
    ds_volume: np.ndarray,
    npz_path,
    source_voxel_zyx: Tuple[float, float, float],
    full_shape_zyx: Tuple[int, int, int],
    target_voxel_um: float,
) -> Path:
    """Exact final z resize + voxel-coordinate axes + compressed npz
    (reference: parallel_image_processor.py:684-751 and
    generate_voxel_spacing :459-474)."""
    npz_path = Path(npz_path)
    tz = max(1, int(round(full_shape_zyx[0] / (target_voxel_um / source_voxel_zyx[0]))))
    ty = max(1, int(round(full_shape_zyx[1] / (target_voxel_um / source_voxel_zyx[1]))))
    tx = max(1, int(round(full_shape_zyx[2] / (target_voxel_um / source_voxel_zyx[2]))))
    vol = np.asarray(resize(ds_volume, (tz, ty, tx)))
    # axes: source locations centered at 0, downsampled start = mean of the
    # first source block, then steps of exactly target_voxel
    # (reference generate_voxel_spacing, parallel_image_processor.py:459-474)
    axes = []
    for n_full, vox, n_target in zip(full_shape_zyx, source_voxel_zyx,
                                     (tz, ty, tx)):
        block = n_full / n_target
        start = round((block - n_full) / 2.0 * vox)
        axes.append(start + target_voxel_um * np.arange(n_target))
    np.savez_compressed(npz_path, I=vol,
                        xI=np.array(axes, dtype="object"))
    return npz_path


def make_diag_stack(
    grid: TileGrid,
    out_dir,
    mipmap_level: Optional[int] = None,
    dtype=np.uint16,
    tif_prefix: str = "diag",
    progress: Optional[ProgressReporter] = None,
) -> Path:
    """Diagnostics stack: each output plane is an RGB image where every
    intersecting tile renders into its own channel (cycled mod 3), so tile
    seams and misplacements are visible at a glance (reference
    make_diag_stack/make_diag_plane, tsv/convert.py:234-282 +
    TSVVolumeBase.make_diagnostic_img, tsv/volume.py:649-668).

    mipmap_level decimates planes by 2**level (both z step and in-plane).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stacks = grid.flattened()
    bbox = grid.volume
    dec = 1 if mipmap_level is None else (1 << mipmap_level)
    info = np.iinfo(dtype) if np.issubdtype(np.dtype(dtype), np.integer) else None
    for zi, z in enumerate(range(bbox.z0, bbox.z1, dec)):
        ext = VExtent(bbox.x0, bbox.x1, bbox.y0, bbox.y1, z, z + 1)
        rgb = np.zeros((ext.y1 - ext.y0, ext.x1 - ext.x0, 3), np.float32)
        for i, s in enumerate(stacks):
            if not s.extent.intersects(ext):
                continue
            inter = s.extent.intersection(ext)
            img = s.imread(inter)[0].astype(np.float32)
            rgb[inter.y0 - ext.y0:inter.y1 - ext.y0,
                inter.x0 - ext.x0:inter.x1 - ext.x0, i % 3] = img
        if dec > 1:
            rgb = rgb[::dec, ::dec]
        if info is not None:
            rgb = np.clip(np.rint(rgb), info.min, info.max)
        tio.imwrite(out_dir / f"{tif_prefix}_{zi:06d}.tif",
                    rgb.astype(dtype))
        if progress is not None:
            progress.step()
    return out_dir

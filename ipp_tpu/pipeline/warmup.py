"""Compile-warmup tool: pre-populate the persistent XLA cache for a run
(VERDICT r4 item 2).

A cold ipp_tpu CLI process pays XLA compiles for every novel shape.  The
reference pays zero compile cost (process_images.py:1062 runs
immediately); this tool closes that operational gap: it enumerates the
exact (shape, config) executables a pipeline invocation will need —
tile batch shapes, NCC z-chunk shapes, the nominal merge layout, the
decon autosplit plan — traces EQUIVALENT computations and compiles them
into the persistent on-disk cache, then prints the program inventory.
A production run with the same arguments then hits the disk cache for
every heavy program.

The persistent cache keys on the compiled HLO + compile options, not on
Python function identity, so the warmup does not need the pipeline's own
closures — only the same shapes, dtypes and baked-in constants.  Two
classes of program cannot be predicted and are reported as such:

- value-dependent post chains: --auto-params / --bleach-correction bake
  data-estimated clips/dark/bit-shift into the merged-plane executable;
- alignment-dependent merge layouts: the blend executable keys on the
  PLACED tile offsets.  The warmup primes the nominal (stage-coordinate)
  layout, which matches when alignment lands on the stage grid or when
  --stitch-on-reference-alignment reuses a placement.

usage:
  python -m ipp_tpu.pipeline.warmup stitch <process_images args...>
  python -m ipp_tpu.pipeline.warmup decon <deconvolve args...>

The cache lives where JAX_COMPILATION_CACHE_DIR says, or at the
checkout's .jax_cache (ipp_tpu.utils.jaxconfig), so a warmup helps every
later process that sees the same directory.
"""

from __future__ import annotations

import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from ..utils.jaxconfig import enable_persistent_cache
from ..utils.log import Logger

__all__ = ["Program", "stitch_programs", "decon_programs",
           "run_programs", "main"]


@dataclass
class Program:
    name: str
    detail: str
    fn: Optional[Callable] = None  # None: listed but not primeable
    note: str = ""


def _rand(shape, dtype=np.uint16, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(1, 1000, shape).astype(dtype)
    return rng.random(shape, dtype=np.float32).astype(dtype)


def stitch_programs(args, log: Logger) -> List[Program]:
    """Enumerate the executables one process_images invocation needs.

    Mirrors main()/process_channel's shape derivations exactly
    (process_images.py) — any drift is caught by the completeness test
    (tests/test_warmup.py), which asserts a post-warmup pipeline run adds
    no new heavy entries to the persistent cache.
    """
    from ..geometry.stacks import TileGrid
    from .process_images import (get_voxel_sizes, preprocess_cfg_from_args,
                                 resolve_channels)

    programs: List[Program] = []
    channels = resolve_channels(args)
    if not channels:
        raise FileNotFoundError(f"no channels under {args.input}")

    flat = None
    if args.flat is not None:
        from ..io import tiff as _tio

        flat = _tio.imread(args.flat).astype(np.float32)
        flat = flat / max(float(flat.mean()), 1e-6)

    from ..parallel.mesh import default_mesh

    mesh, plane_batch = default_mesh()
    use_mesh = mesh is not None and int(
        np.prod([v for v in mesh.shape.values()])) > 1

    seen = set()
    for ch in channels:
        ch_path = args.input / ch
        vx, vy, vz, tile_size = get_voxel_sizes(args.objective, ch_path)
        # header-only discovery: lists directories + reads one TIFF header
        grid = TileGrid.from_directory(ch_path, voxel_um=(vy, vx, vz))
        stacks = grid.flattened()
        th, tw = stacks[0].plane_shape
        depth = min(s.depth for s in stacks)
        rows, cols = grid.n_rows, grid.n_cols

        new_tile = None
        if args.isotropic and not (vx == vy == vz):
            new_tile = (int(round(th * vy / vz)), int(round(tw * vx / vz)))
        cfg = preprocess_cfg_from_args(args, flat, new_tile)

        # tile dtype from one decoded plane FILE (cameras write u16, but
        # converted/derived datasets can be f32 — the destripe executable
        # keys on it; TileStack.imread would cast, the raw file doesn't)
        from ..io import tiff as _tio

        tile_dtype = np.asarray(_tio.imread(stacks[0].paths[0])).dtype

        key = (th, tw, depth, rows, cols, new_tile, str(tile_dtype))
        if key in seen:
            continue  # identical channel geometry: same executables
        seen.add(key)

        # ---- 1. preprocess batch (the dominant cold compile) ----------
        if cfg is not None:
            # a full batch of 8 plus the dataset's tail batch: the
            # executor pads the tail to 8 and slices [:tail] — that
            # slice is its own (tail-sized) executable
            n_total = sum(s.depth for s in stacks)
            n_prime = n_total if n_total <= 8 else 8 + (n_total % 8)

            def prime_destripe(cfg=cfg, th=th, tw=tw, dt=tile_dtype,
                               n_prime=n_prime):
                # drive the REAL batch_filter on the tiles so mesh/batch
                # decisions match production
                from .pystripe_cli import batch_filter

                with tempfile.TemporaryDirectory() as td:
                    from ..io import tiff as _tio

                    src = Path(td) / "in"
                    src.mkdir()
                    for i in range(n_prime):
                        _tio.imwrite(src / f"w_{i:02d}.tif",
                                     _rand((th, tw), dt, seed=i))
                    batch_filter(src, Path(td) / "out", cfg, workers=2)

            programs.append(Program(
                f"{ch}: destripe batch",
                f"(8, {th}, {tw}) {tile_dtype} + tail "
                f"{n_prime - 8 if n_prime > 8 else n_prime}",
                prime_destripe))

        # preprocessed tiles feed the stitch stages: the shape comes from
        # the process chain's output metadata, while the merge reads
        # through TileStack.imread which casts to the grid's declared
        # dtype (geometry/stacks.py TileStack.dtype) — use exactly that
        if cfg is not None:
            from ..ops.process import _out_meta

            (th, tw), _dt = _out_meta((th, tw), cfg, tile_dtype)
        merge_dtype = stacks[0].dtype

        # ---- 2. NCC z-chunk executables --------------------------------
        # mirror process_channel's overlap/z-chunk math.  With
        # --isotropic the production grid is built from the RESIZED
        # preprocessed tiles at voxel (vz, vz, vz): stage positions in px
        # rescale accordingly, so the pair-step geometry is recomputed on
        # a vz-voxel view of the same directory
        geo = grid
        if new_tile is not None:
            geo = TileGrid.from_directory(ch_path, voxel_um=(vz, vz, vz))
        overlap_v = max(1, int(round(th * 0.1)))
        overlap_h = max(1, int(round(tw * 0.1)))

        def _first_adjacent(dr, dc, geo=geo):
            for r in range(rows - dr):
                for c in range(cols - dc):
                    a = geo.stacks[r][c]
                    b = geo.stacks[r + dr][c + dc]
                    if a is not None and b is not None:
                        return a, b
            return None

        pair_h = _first_adjacent(0, 1)
        if pair_h is not None:
            oh = tw - (pair_h[1].abs_h - pair_h[0].abs_h)
            if 0 < oh < tw:
                overlap_h = oh
        pair_v = _first_adjacent(1, 0)
        if pair_v is not None:
            ov = th - (pair_v[1].abs_v - pair_v[0].abs_v)
            if 0 < ov < th:
                overlap_v = ov
        subvol = 1 if args.stitch_mip else args.subvol_dim
        n_sub = max(1, depth // max(1, subvol))
        bounds = np.linspace(0, depth, n_sub + 1).astype(int)
        n_ns = sum(1 for r in range(rows - 1) for c in range(cols)
                   if grid.stacks[r][c] is not None
                   and grid.stacks[r + 1][c] is not None)
        n_we = sum(1 for r in range(rows) for c in range(cols - 1)
                   if grid.stacks[r][c] is not None
                   and grid.stacks[r][c + 1] is not None)
        sr = args.search_radius
        # production: grid.flattened()[0].depth (process_images.py), NOT
        # the min depth (which only bounds the z-chunk range)
        dd = min(sr, max(1, stacks[0].depth // 8))
        chunk_shapes = set()
        for k in range(n_sub):
            dz = int(bounds[k + 1]) - int(bounds[k])
            if dz > 0:
                chunk_shapes.add(dz)
        for dz in sorted(chunk_shapes):
            for side, n_pairs, ov in (("ns", n_ns, overlap_v),
                                      ("we", n_we, overlap_h)):
                if n_pairs == 0:
                    continue

                def prime_ncc(side=side, n_pairs=n_pairs, ov=ov, dz=dz,
                              th=th, tw=tw, sr=sr, dd=dd):
                    from ..ops.ncc import align_pairs_batched

                    a = _rand((n_pairs, dz, th, tw), np.float32)
                    b = _rand((n_pairs, dz, th, tw), np.float32, seed=1)
                    align_pairs_batched(a, b, side, ov, sr, sr, dd,
                                        mesh=mesh if use_mesh else None)

                programs.append(Program(
                    f"{ch}: ncc {side}", f"({n_pairs}, {dz}, {th}, {tw}) "
                    f"search {sr}/{dd}", prime_ncc))

        # ---- 3. merge blend + post + downsample (nominal layout) -------
        value_dep = (args.auto_params or args.bleach_correction
                     or args.background_subtraction)
        bbox = grid.volume
        canvas = (bbox.y1 - bbox.y0, bbox.x1 - bbox.x0)
        batch = (int(mesh.shape["data"]) if use_mesh
                 else max(1, int(plane_batch)))
        convert8 = args.convert_to_8bit
        # with preprocessing on, dark is applied per tile and the merge
        # post sees dark=0 (main: `dark=args.dark if args.no_preprocess
        # else 0.0`)
        dark = args.dark if args.no_preprocess else 0.0
        bit_shift = args.bit_shift
        out_dtype = np.uint8 if convert8 else np.uint16

        if value_dep:
            programs.append(Program(
                f"{ch}: merge post", f"canvas {canvas}", None,
                note="value-dependent (auto-estimated clips/dark/bit "
                     "shift bake into the executable) — compiles in-run"))

        def prime_merge(grid=grid, bbox=bbox, canvas=canvas, batch=batch,
                        value_dep=value_dep, convert8=convert8, dark=dark,
                        bit_shift=bit_shift, out_dtype=out_dtype,
                        vy=vy, vx=vx, vz=vz, depth=depth,
                        merge_dtype=merge_dtype):
            import jax
            import jax.numpy as jnp

            from ..geometry.extent import VExtent
            from ..stitch.blend import PlaneBlender

            blender = PlaneBlender([s.extent for s in grid.flattened()],
                                   cosine=args.cosine_blending)
            sharding = None
            if use_mesh:
                from ..parallel.mesh import data_sharding

                sharding = data_sharding(mesh, 3)
            post_dev = None
            fetch_dtype = np.float32
            if not value_dep and (convert8 or dark > 0):
                from ..ops.intensity import convert_to_8bit as to8
                from ..ops.intensity import subtract_dark

                def _dark_to8(x):
                    x = jnp.clip(x, 0, 65535).astype(jnp.uint16)
                    if dark > 0:
                        x = subtract_dark(x, dark)
                    if convert8:
                        x = to8(x, bit_shift if bit_shift is not None
                                else 8)
                    return x

                # lambda wrapper: the persistent-cache key includes the
                # jit'd function NAME, and production jits a lambda
                # (process_images.py post_fn_device).  fetch dtype stays
                # float32 — merge's rule is `dtype if post_fn is None`
                # (stitch/merge.py fetch_dtype), and the post path sets a
                # host post_fn
                post_dev = jax.jit(lambda x: _dark_to8(x))
                fetch_dtype = np.float32
            elif not value_dep:
                fetch_dtype = out_dtype  # device-side cast path

            def reader(i, inter):
                return _rand((inter.z1 - inter.z0,) + inter.shape[1:],
                             merge_dtype, seed=i)

            # the merge's z loop emits full batches of `batch` planes and
            # one tail batch — each distinct B is its own executable
            b_sizes = set()
            for zi in range(0, depth, batch):
                b_sizes.add(min(zi + batch, depth) - zi)
            for bz in sorted(b_sizes):
                ext = VExtent(bbox.x0, bbox.x1, bbox.y0, bbox.y1,
                              bbox.z0, bbox.z0 + bz)
                blender.blend_planes(ext, reader, dtype=fetch_dtype,
                                     sharding=sharding,
                                     pad_to=batch if use_mesh else 1,
                                     device_post=post_dev)
            # estimate-params single plane (auto_params/bleach runs)
            if value_dep:
                ext1 = VExtent(bbox.x0, bbox.x1, bbox.y0, bbox.y1,
                               bbox.z0, bbox.z0 + 1)
                blender.blend_plane(ext1, lambda i, e: _rand(
                    e.shape[1:], seed=i), dtype=np.uint16)
            # isotropic downsample ladder + z reduction + final npz
            # resize, exactly as the merge tail runs them
            # (stitch/merge.py:370-405, downsampled_npz)
            if args.downsampled_voxel is not None:
                from ..ops.resample import (isotropic_downsample_plane,
                                            plan_isotropic_downsampling)
                from ..stitch.merge import _z_reduce, downsampled_npz

                tv = args.downsampled_voxel
                plane_hw, vox_hw = canvas, (vy, vx)
                if args.rot90:
                    plane_hw, vox_hw = canvas[::-1], (vx, vy)
                tgt, methods = plan_isotropic_downsampling(
                    plane_hw, vox_hw, tv)
                small = np.asarray(isotropic_downsample_plane(
                    _rand(plane_hw, out_dtype), tgt, methods))
                n_zh = int(np.ceil(np.sqrt(tv / vz)))
                chunk_len = max(1, int(tv // vz))
                lens = ([chunk_len] * (depth // chunk_len)
                        + ([depth % chunk_len] if depth % chunk_len
                           else []))
                chunks = [_z_reduce(np.stack([small] * n), n_zh)[0]
                          for n in sorted(set(lens))]
                ds_vol = np.stack([chunks[0]] * len(lens))
                vox_zyx = ((vz, vx, vy) if args.rot90 else (vz, vy, vx))
                with tempfile.TemporaryDirectory() as td:
                    downsampled_npz(ds_vol, Path(td) / "w.npz", vox_zyx,
                                    (depth,) + tuple(plane_hw), tv)

        programs.append(Program(
            f"{ch}: merge blend", f"canvas {canvas} x{batch} "
            f"({len(stacks)} tiles, nominal layout)", prime_merge,
            note="layout-dependent: primed for the nominal stage layout"))
    return programs


def decon_programs(args, log: Logger) -> List[Program]:
    """Enumerate the RL executables a deconvolve invocation needs: the
    autosplit plan's uniform work shape (deconvolve.py autosplit +
    fft_work_shape are deterministic given volume/psf/budget)."""
    from ..ops.psf import make_psf
    from .deconvolve import (TiffDirVolume, autosplit, block_elems_arg,
                             fft_work_shape)

    psf_xyz, _fx, _fz = make_psf(
        dxy=args.dxy, dz=args.dz, NA=args.na, n=args.rf,
        lambda_ex=args.lambda_ex, lambda_em=args.lambda_em,
        fcyl=args.fcyl, slitwidth=args.slitwidth)
    psf = np.transpose(psf_xyz, (2, 1, 0))
    vol = TiffDirVolume(args.input)
    plans, halo, _ = autosplit(
        vol.shape, psf.shape, block_elems_arg(args.max_block_mvox),
        strict_accuracy=not args.no_strict_accuracy)
    uni = fft_work_shape(plans, halo)

    quantize = not args.destripe_sigma  # deconvolve.py:514

    def prime_block():
        import jax
        import jax.numpy as jnp

        from ..ops.deconv import gauss3d, richardson_lucy

        # blocks enter in the VOLUME's native dtype and convert on device
        # (deconvolve.py single-device loop: jnp.asarray(block).astype)
        x = jnp.asarray(_rand(uni, vol.dtype)).astype(jnp.float32)
        if args.gaussian_sigma:
            x = gauss3d(x, tuple(args.gaussian_sigma))
        if args.dark > 0:
            x = jnp.maximum(x - args.dark, 0.0)
        dec = richardson_lucy(
            x, jnp.asarray(psf), niter=args.niter, lam=args.lam,
            stop_criterion=args.stop_criterion,
            regularize_interval=args.regularize_interval,
            fft_shape=uni,
            classic=not args.reference_scheme)

        # the finish crop+quantize tail compiles as its OWN executable
        # (deconvolve.py _finish_ops is a separate jit)
        crop = tuple(slice(h, h + (u - 2 * h)) for h, u in zip(halo, uni))

        def finish(d):
            core = d[crop]
            if not quantize:
                return core, None, None
            qmin = jnp.min(core)
            qmax = jnp.max(core)
            s = 65535.0 / jnp.maximum(qmax - qmin, 1e-30)
            q = jnp.clip(jnp.rint((core - qmin) * s), 0, 65535)
            return q.astype(jnp.uint16), qmin, qmax

        out = jax.jit(finish)(dec)
        float(np.asarray(out[0]).sum())  # force compile + run

    programs = [Program(
        "decon block", f"work {uni}, halo {halo}, {len(plans)} blocks, "
        f"niter {args.niter}", prime_block)]
    import jax as _jax

    if len(_jax.devices()) > 1:
        programs.append(Program(
            "decon mesh batch", f"{len(_jax.devices())}-device shard_map",
            None,
            note="mesh-batched blocks compile a shard_map executable on "
                 "the actual mesh — prime by running the pipeline once; "
                 "the single-device block program above covers 1-chip "
                 "hosts"))
    return programs


def run_programs(programs: List[Program], log: Logger) -> List[dict]:
    inventory = []
    for p in programs:
        entry = {"name": p.name, "detail": p.detail, "note": p.note}
        if p.fn is None:
            log.info(f"SKIP  {p.name} [{p.detail}] — {p.note}")
            entry["secs"] = None
        else:
            t0 = time.time()
            p.fn()
            entry["secs"] = round(time.time() - t0, 2)
            log.info(f"OK    {p.name} [{p.detail}] {entry['secs']}s"
                     + (f" — {p.note}" if p.note else ""))
        inventory.append(entry)
    return inventory


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("stitch", "decon"):
        print("usage: warmup {stitch|decon} <pipeline args...>",
              file=sys.stderr)
        return 2
    sub, rest = argv[0], argv[1:]
    enable_persistent_cache()
    log = Logger()
    if sub == "stitch":
        from .process_images import build_parser

        args = build_parser().parse_args(rest)
        programs = stitch_programs(args, log)
    else:
        from .deconvolve import build_parser

        args = build_parser().parse_args(rest)
        programs = decon_programs(args, log)
    t0 = time.time()
    inv = run_programs(programs, log)
    primed = sum(1 for e in inv if e["secs"] is not None)
    log.info(f"warmup complete: {primed}/{len(inv)} programs primed in "
             f"{time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

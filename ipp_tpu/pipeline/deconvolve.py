"""Volume deconvolution pipeline — the LsDeconvolveMultiGPU equivalent.

Re-design of LsDeconv.m's orchestration (LsDeconvolveMultiGPU/LsDeconv.m):

- `autosplit` block planning with halo padding: halos come from neighboring
  data when available, symmetric padding at volume edges (the reference
  interpolation-pads x/y and real-data-pads z, LsDeconv.m:173-174, 817-898).
  Blocks are OVERLAP-SAVE — the FFT work shape equals the padded block
  shape (no zero pad), circular wraparound lands in the discarded halo
  (4x the PSF half-extent), every axis is a 2,3,5,7-smooth FFT size, and
  the block is as large as the device's memory holds,
- per-block pipeline: load -> optional 3D gaussian prefilter -> dark
  subtract -> RL decon -> optional z destripe -> stats (LsDeconv.m:906-947),
- on a multi-device mesh, blocks are symmetric-padded to one uniform shape
  and shard_map'ed over the 'data' axis so EVERY device runs the fast
  unbatched 3D RL executable on its local blocks — the replacement for
  per-GPU semaphore work-stealing (LsDeconv.m:644-706).  Blocks are
  autosplit to fit one device; intra-block z sharding stays available via
  ops.deconv.richardson_lucy_sharded_z for unsplittable volumes,
- global rescale stats are per-block percentiles [100-clipval, clipval]
  reduced to deconvmin/deconvmax in-process (replaces min_max.mat + named
  semaphores, LsDeconv.m:770-797, deconvolved_stats :1300-1304), final
  rescale (v - deconvmin) * dtype_max * amplification / (deconvmax -
  deconvmin) (postprocess_save + load_slab_lz4 scaling, LsDeconv.m:1080-1093),
- reassembly streams one PLANE at a time from memory-mapped bricks
  (bounded memory; the reference holds one slab, LsDeconv.m:1060-1108),
- resume via a block-manifest JSON + per-block .npy brick cache
  (replaces block.mat + 0-byte claim files + LZ4 bricks).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..io import tiff as tio
from ..ops.deconv import richardson_lucy
from ..ops.destripe import filter_streaks
from ..ops.fftutil import next_fast_len
from ..utils.jaxconfig import enable_persistent_cache
from ..utils.lagged import OneInFlight
from ..utils.log import Logger
from ..utils.progress import ProgressReporter

__all__ = ["BlockPlan", "autosplit", "deconvolve_volume"]

MAX_BLOCK_ELEMS = 1290 ** 3  # reference limit (LsDeconv.m:312-315)
MAX_BLOCK_DIM = 1281


@dataclass
class BlockPlan:
    """One block: core extent [z0:z1, y0:y1, x0:x1] plus halo sizes."""

    index: int
    core: Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]
    halo: Tuple[int, int, int]

    def padded_bounds(self, vol_shape) -> List[Tuple[int, int]]:
        out = []
        for (lo, hi), h, n in zip(self.core, self.halo, vol_shape):
            out.append((max(0, lo - h), min(n, hi + h)))
        return out


# Device bytes one voxel of the padded block costs while a block is in
# flight on the single-device path (deconvolve_volume -> richardson_lucy),
# from peak_bytes_in_use and memory_analysis on an H100
# (scripts/blocksize_sweep.py, PERF.md):
#   RL program at radix-2/5 shapes: input 4, output 4, XLA temporaries
#     20 (observed, estimate, ratio, complex half spectra), cuFFT work
#     area ~8                                                        = 36
#   cuFFT's work area grows with odd factors (16 B/vox asked for a
#     (840, 1200, 1215) block)                                       = 8
#   the previous block's output, on the device until it is fetched   = 6
#   headroom for allocator fragmentation                             = 6
# The gaussian prefilter runs before the RL program and peaks lower.
RL_BYTES_PER_VOXEL = 56


def _device_bytes_limit() -> int:
    """Bytes the first device lets this process allocate; host backends
    report none, so there it is a quarter of physical RAM."""
    import os

    import jax

    stats = jax.devices()[0].memory_stats() or {}
    if stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4


def default_block_elems(bytes_limit: Optional[int] = None) -> int:
    """Largest padded block (voxels) whose RL working set fits the device,
    capped at the reference's MAX_BLOCK_ELEMS."""
    if bytes_limit is None:
        bytes_limit = _device_bytes_limit()
    return min(int(bytes_limit) // RL_BYTES_PER_VOXEL, MAX_BLOCK_ELEMS)


# RL cost model, from 6-iteration RL times on an H100 (PERF.md block
# sweep): ~0.43 ns per padded voxel for axes whose only factors are 2
# and 5, times a factor per axis that has a 3 or a 7 in it, plus a fixed
# ~1.7 ms per block (~4 Mi voxel-equivalents).
_AXIS_PRIME_COST = {3: 1.08, 7: 1.07}
_BLOCK_OVERHEAD_VOX = 4 * 2 ** 20


def _axis_cost(p: int) -> float:
    f = 1.0
    for prime, cost in _AXIS_PRIME_COST.items():
        if p % prime == 0:
            f *= cost
    return f


def _axis_candidates(n: int, h: int, max_dim: int) -> List[int]:
    """Padded-size candidates for one axis: 2,3,5,7-smooth sizes (FFT axes
    XLA transforms fast) from a core of 1 up to the whole axis, at most
    `max_dim`."""
    top = min(next_fast_len(n + 2 * h), max_dim)
    return [p for p in range(2 * h + 1, top + 1) if next_fast_len(p) == p]


def autosplit(vol_shape: Tuple[int, int, int], psf_shape: Tuple[int, int, int],
              max_block_elems: Optional[int] = None,
              strict_accuracy: bool = False,
              bytes_limit: Optional[int] = None,
              ):
    """Split a volume into overlap-save blocks; returns
    (plans, halo, planned_padded_shape).

    Reference role: autosplit + split_stack (LsDeconv.m:308-385).  The FFT
    work shape IS the padded block shape (no extra zero pad) — circular
    wraparound lands in the discarded halo, the overlap-save formulation
    of block convolution.  The halo is therefore 4x the PSF half-extent
    (wrap contamination decays below 1e-4 NRMSE at 4 half-widths for a
    10-iteration RL; tests/test_pipeline.py).  Every padded axis is
    2,3,5,7-smooth and at most MAX_BLOCK_DIM (the reference's limit); the
    block's voxels are at most `max_block_elems`, by default what the
    device's `bytes_limit` holds at RL_BYTES_PER_VOXEL.  Among those
    shapes the plan minimizes the modelled RL time of the whole volume,
    blocks * (voxels * axis costs + _BLOCK_OVERHEAD_VOX).
    """
    if max_block_elems is None:
        max_block_elems = default_block_elems(bytes_limit)
    max_block_elems = min(max_block_elems, MAX_BLOCK_ELEMS)

    def search(halo):
        cands = [np.asarray(_axis_candidates(n, h, MAX_BLOCK_DIM), np.int64)
                 for n, h in zip(vol_shape, halo)]
        nblk = [-(-n // np.maximum(c - 2 * h, 1))
                for n, h, c in zip(vol_shape, halo, cands)]
        fac = [np.array([_axis_cost(int(p)) for p in c]) for c in cands]
        vyx = cands[1][:, None] * cands[2][None, :]
        fyx = fac[1][:, None] * fac[2][None, :]
        byx = nblk[1][:, None] * nblk[2][None, :]
        best, best_cost = None, float("inf")
        for pz, bz, fz in zip(cands[0], nblk[0], fac[0]):
            vox = pz * vyx
            cost = np.where(vox <= max_block_elems,
                            bz * byx * (vox * fz * fyx + _BLOCK_OVERHEAD_VOX),
                            np.inf)
            i = int(np.argmin(cost))
            c = float(cost.flat[i])
            if c < best_cost:
                iy, ix = np.unravel_index(i, cost.shape)
                best = (int(pz), int(cands[1][iy]), int(cands[2][ix]))
                best_cost = c
        return best

    # halo ladder: prefer 4x the PSF half-extent (wrap error < 1e-4); under
    # tight block budgets step down toward the reference's psf/2 minimum
    # rather than starving the cores (LsDeconv pads by the PSF half extents)
    best = halo = fallback = None
    chosen_m = 4
    for m in (4, 3, 2, 1):
        halo_m = tuple(max((p // 2) * m, 8 if m >= 4 else 1, 1)
                       for p in psf_shape)
        cand = search(halo_m)
        if cand is None:
            continue
        cores_ok = all(max(1, p - 2 * h) >= 2 * h
                       for p, h in zip(cand, halo_m))
        if cores_ok or m == 1:
            best, halo, chosen_m = cand, halo_m, m
            break
        if fallback is None:
            fallback = (cand, halo_m, m)  # feasible but core-starved
    if best is None and fallback is not None:
        best, halo, chosen_m = fallback
    if best is None:  # budget smaller than any candidate: minimal split
        halo = tuple(max(p // 2, 1) for p in psf_shape)
        best = tuple(next_fast_len(min(16, n + 2 * h))
                     for n, h in zip(vol_shape, halo))
        chosen_m = 1
    if chosen_m < 4:
        msg = (
            f"decon block budget forced the overlap-save halo down to "
            f"{chosen_m}x the PSF half-extent ({halo}); wraparound error "
            f"in core voxels grows beyond the <1e-4 NRMSE of the 4x halo "
            f"(measured ladder: 3x ~4e-4, 2x ~2e-3). "
            f"Raise --max-block-mvox to restore the full halo.")
        # strict gate (north-star protection): a halo of <=2x the PSF
        # half-extent measures >=2e-3 core NRMSE — beyond the 1e-3 output
        # tolerance (reference halo semantics: LsDeconv.m:173-174).  3x
        # (~4e-4) still passes, so it stays a warning either way.
        if strict_accuracy and chosen_m <= 2:
            raise ValueError(
                msg + " (strict accuracy mode: refusing to run beyond the "
                "1e-3 NRMSE budget; pass --no-strict-accuracy to override)")
        import warnings

        warnings.warn(msg, stacklevel=2)
    cores = [max(1, p - 2 * h) for p, h in zip(best, halo)]
    plans = []
    idx = 0
    for iz in range(math.ceil(vol_shape[0] / cores[0])):
        for iy in range(math.ceil(vol_shape[1] / cores[1])):
            for ix in range(math.ceil(vol_shape[2] / cores[2])):
                core = []
                for ax, i in zip(range(3), (iz, iy, ix)):
                    lo = i * cores[ax]
                    hi = min((i + 1) * cores[ax], vol_shape[ax])
                    core.append((lo, hi))
                if all(hi > lo for lo, hi in core):
                    plans.append(BlockPlan(idx, tuple(core), halo))
                    idx += 1
    _check_block_coverage(plans, vol_shape)
    return plans, halo, tuple(best)


def _check_block_coverage(plans: List["BlockPlan"], vol_shape) -> None:
    """Production invariant (the reference's check_block_coverage_planes,
    LsDeconv.m:421): block cores must tile the volume exactly — every
    voxel covered by exactly one core.  Checked per axis as interval
    chains (cores are an axis-aligned grid), so it is O(nblocks) not
    O(voxels)."""
    per_axis = [sorted({p.core[ax] for p in plans}) for ax in range(3)]
    for ax, ivs in enumerate(per_axis):
        pos = 0
        for lo, hi in ivs:
            if lo != pos or hi <= lo:
                raise AssertionError(
                    f"decon block plan leaves axis {ax} uncovered or "
                    f"overlapped at {pos} (next core [{lo}, {hi}))")
            pos = hi
        if pos != vol_shape[ax]:
            raise AssertionError(
                f"decon block plan covers axis {ax} to {pos} of "
                f"{vol_shape[ax]}")
    expected = int(np.prod([len(ivs) for ivs in per_axis]))
    unique = {p.core for p in plans}
    if len(plans) != expected or len(unique) != expected:
        # len(unique) check: a duplicated cell plus a missing one keeps
        # len(plans) == expected but still corrupts coverage
        raise AssertionError(
            f"decon block plan grid is ragged: {len(plans)} blocks "
            f"({len(unique)} unique) for a "
            f"{'x'.join(str(len(i)) for i in per_axis)} core grid")


def fft_work_shape(plans: List[BlockPlan], halo) -> Tuple[int, int, int]:
    """Overlap-save FFT work shape that every block is read at: the
    largest core plus both halos per axis, rounded up to a 2,3,5,7-smooth
    size (at most the planned shape, which is smooth), so a run compiles
    one executable and the FFT needs no zero pad."""
    return tuple(
        next_fast_len(max(hi - lo for p in plans for (lo, hi) in [p.core[a]])
                      + 2 * halo[a])
        for a in range(3))


class TiffDirVolume:
    """z-indexed TIFF directory as a random-access (D, H, W) volume
    (reference load_bl_tif.cpp role)."""

    def __init__(self, directory: Path):
        self.dir = Path(directory)
        self.paths = sorted(p for p in self.dir.iterdir()
                            if p.suffix.lower() in (".tif", ".tiff"))
        if not self.paths:
            raise FileNotFoundError(f"no TIFFs in {directory}")
        first = tio.imread(self.paths[0])
        self.plane_shape = first.shape
        self.dtype = first.dtype
        self._cache = {0: first}

    @property
    def shape(self):
        return (len(self.paths),) + tuple(self.plane_shape)

    def read_block(self, bounds) -> np.ndarray:
        (z0, z1), (y0, y1), (x0, x1) = bounds
        from .. import native

        # keep the native dtype: uploading u16 halves H2D traffic; the
        # device converts to f32
        block = native.read_block(self.paths[z0:z1], y0, y1, x0, x1,
                                  dtype=self.dtype)
        if block is not None:
            return block
        out = np.empty((z1 - z0, y1 - y0, x1 - x0), self.dtype)
        for i, z in enumerate(range(z0, z1)):
            plane = self._cache.get(z)
            if plane is None:
                plane = tio.imread(self.paths[z])
            out[i] = plane[y0:y1, x0:x1]
        return out


def _pad_symmetric_safe(a: np.ndarray, pads) -> np.ndarray:
    """np.pad(mode='symmetric') in rounds: numpy caps each round's pad at
    the current size, so halos wider than a thin edge block mirror-tile."""
    pads = [list(p) for p in pads]
    while True:
        cur = [(min(p[0], a.shape[i]), min(p[1], a.shape[i]))
               for i, p in enumerate(pads)]
        if all(c == (0, 0) for c in cur):
            return a
        a = np.pad(a, cur, mode="symmetric")
        for p, c in zip(pads, cur):
            p[0] -= c[0]
            p[1] -= c[1]


def read_block_uniform(vol, plan: BlockPlan, uni_shape) -> np.ndarray:
    """Read a plan's halo-padded block and symmetric-pad it to the uniform
    shape: missing halos at volume edges mirror real data (the reference's
    symmetric edge pad, LsDeconv.m:877-898) and remainder blocks fill their
    tail the same way.  The core always lands at offset `halo`."""
    bounds = plan.padded_bounds(vol.shape)
    block = vol.read_block(bounds)
    pads = []
    for (lo, hi), h, (b0, b1), u in zip(plan.core, plan.halo, bounds,
                                        uni_shape):
        pre = h - (lo - b0)
        pads.append((pre, u - pre - (b1 - b0)))
    if any(p != (0, 0) for p in pads):
        block = _pad_symmetric_safe(block, pads)
    return block


def _block_stats(core: np.ndarray, clip_percentile: float):
    """Per-block rescale percentiles (reference deconvolved_stats,
    LsDeconv.m:1300-1304): [100-clipval, clipval]."""
    lb, ub = np.percentile(core, [100.0 - clip_percentile, clip_percentile])
    return float(lb), float(ub)


def deconvolve_volume(
    input_dir,
    output_dir,
    psf: np.ndarray,
    niter: int = 10,
    lam: float = 0.0,
    stop_criterion: float = 0.0,
    regularize_interval: int = 0,
    gaussian_sigma: Optional[Tuple[float, float, float]] = None,
    dark: float = 0.0,
    destripe_sigma: Optional[float] = None,
    out_dtype=np.uint16,
    amplification: float = 1.0,
    clip_percentile: float = 99.999,
    batch_blocks: Optional[int] = None,
    max_block_elems: Optional[int] = None,
    resume: bool = False,
    classic_rl: bool = True,
    mesh=None,
    strict_accuracy: bool = True,
    adaptive_psf: bool = False,
    cache_dir=None,
    start_block: int = 0,
    dry_run: bool = False,
    log: Optional[Logger] = None,
) -> Path:
    """End-to-end volume deconvolution (the LsDeconv CLI semantics:
    29-parameter surface reduced to the ones with effect; LsDeconv.m:44-75).

    With more than one device (or an explicit `mesh`), blocks run as
    data-parallel batches sharded over the mesh's 'data' axis — the role of
    the reference's per-GPU parfor work-stealing (LsDeconv.m:644-706).
    Early stop (stop_criterion) applies on both paths: per block on the
    single-device path, and per block inside the mesh batch too (each
    block's while_loop exits independently under lax.map, matching the
    reference's per-block stop, decon.m:155-204).
    """
    enable_persistent_cache()
    import jax
    import jax.numpy as jnp

    from ..ops.deconv import gauss3d

    log = log or Logger()
    vol = TiffDirVolume(input_dir)
    output_dir = Path(output_dir)
    brick_dir = (Path(cache_dir) if cache_dir is not None
                 else output_dir / "bricks")
    brick_dir.mkdir(parents=True, exist_ok=True)
    output_dir.mkdir(parents=True, exist_ok=True)
    plans, halo, planned = autosplit(vol.shape, psf.shape, max_block_elems,
                                     strict_accuracy=strict_accuracy)
    if dry_run:
        # plan-only mode (reference decwrap --dry-run)
        log.info(f"DRY RUN: volume {vol.shape}, {len(plans)} blocks, "
                 f"halo {halo}, work shape {planned}")
        for p_ in plans:
            log.info(f"  block {p_.index:05d}: core {p_.core}")
        return output_dir
    if adaptive_psf and mesh is not None and mesh is not False:
        raise ValueError(
            "adaptive_psf runs the per-block blind-Wiener path and cannot "
            "combine with an explicit multi-device mesh; pass mesh=None")
    if adaptive_psf and mesh is None:
        # blind Wiener PSF re-estimation runs the unbatched per-block
        # path (reference deconFFT_Wiener, decon.m:206-321)
        import jax as _jax

        if len(_jax.devices()) > 1:
            log.warn("--adaptive-psf runs blocks sequentially on one "
                     "device (per-block PSF state)")
        mesh = False

    if mesh is None and len(jax.devices()) > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh()
    if mesh is False:
        mesh = None
    use_mesh = mesh is not None and int(np.prod(list(mesh.shape.values()))) > 1
    n_data = int(mesh.shape["data"]) if use_mesh else 1
    log.info(f"volume {vol.shape} -> {len(plans)} blocks, halo {halo}, "
             f"{'mesh ' + str(dict(mesh.shape)) if use_mesh else 'single device'}")

    manifest_path = output_dir / "blocks_manifest.json"
    stats = {"min": float("inf"), "max": float("-inf")}
    quant = {}  # brick index -> [qmin, qmax] for u16-quantized bricks
    if (resume or start_block > 0) and manifest_path.exists():
        # start_block implies earlier blocks came from a previous run
        # (the reference's split-across-machines workflow): their
        # stats/quant entries must survive this run's manifest writes
        old = json.loads(manifest_path.read_text())
        stats = old.get("stats", stats)
        quant = old.get("quant", quant)

    prog = ProgressReporter(len(plans), desc="decon blocks")
    psf_j = jnp.asarray(psf, jnp.float32)

    from concurrent.futures import ThreadPoolExecutor

    todo = [p_ for p_ in plans
            if p_.index >= max(0, start_block)
            and not (resume and
                     (brick_dir / f"block_{p_.index:05d}.npy").exists())]
    n_skipped = len(plans) - len(todo)
    for _ in range(n_skipped):
        prog.step()

    # bricks travel device->host as u16 with a per-block affine range:
    # halves the transfer AND the brick-cache IO; the quantization step
    # (block range / 65535) is far below the final u16 rescale's own
    # rounding.  The z-destripe path keeps f32 bricks (it filters the
    # values before the range is final).
    quantize = destripe_sigma is None

    def save_core(plan: BlockPlan, core: np.ndarray, qrange=None):
        if destripe_sigma:
            # z-destripe each xz slice (reference filter_subband_3d_z.m)
            core = np.asarray(
                filter_streaks(core.transpose(1, 0, 2),
                               sigma=(destripe_sigma, destripe_sigma),
                               wavelet="db9")).transpose(1, 0, 2)
        if qrange is not None:
            qmin, qmax = float(qrange[0]), float(qrange[1])
            lb, ub = np.percentile(core, [100.0 - clip_percentile,
                                          clip_percentile])
            s = (qmax - qmin) / 65535.0
            lb, ub = lb * s + qmin, ub * s + qmin
            quant[str(plan.index)] = [qmin, qmax]
        else:
            lb, ub = _block_stats(core, clip_percentile)
        stats["min"] = min(stats["min"], float(lb))
        stats["max"] = max(stats["max"], float(ub))
        # manifest BEFORE brick: a crash between the two leaves a quant
        # entry without a brick (block simply redone on --resume); the
        # other order would leave a u16 brick whose codes resume would
        # reassemble as raw intensities
        manifest_path.write_text(json.dumps(
            {"stats": stats, "quant": quant, "n_blocks": len(plans),
             "vol_shape": vol.shape}))
        np.save(brick_dir / f"block_{plan.index:05d}.npy",
                core.astype(np.uint16 if qrange is not None
                            else np.float32))
        prog.step()

    uni = fft_work_shape(plans, halo)

    def _finish_ops(uni_shape):
        """Device-side tail: crop to the uniform max core (the halo never
        leaves the device) and optionally quantize to u16 — both shrink
        the device->host transfer."""
        crop = tuple(slice(h, h + (u - 2 * h)) for h, u in
                     zip(halo, uni_shape))

        def finish(dec):
            core = dec[crop]
            if not quantize:
                return core, None, None
            qmin = jnp.min(core)
            qmax = jnp.max(core)
            s = 65535.0 / jnp.maximum(qmax - qmin, 1e-30)
            q = jnp.clip(jnp.rint((core - qmin) * s), 0, 65535)
            return q.astype(jnp.uint16), qmin, qmax

        return finish

    if use_mesh and todo:
        # ---- data-parallel batches over the mesh --------------------------
        from ..parallel.distributed import device_put_global
        from ..parallel.mesh import data_sharding

        fft_shape = uni
        # blocks are autosplit to fit ONE device, so the pipeline always
        # runs pure data parallelism: a mesh with a 'z' axis folds it into
        # 'data' (intra-block z sharding remains available through the
        # richardson_lucy_sharded_z op for volumes that cannot be split)
        z_par = int(mesh.shape.get("z", 1))
        if z_par > 1:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(int(np.prod(list(mesh.shape.values()))),
                             z_parallel=1)
            n_data = int(mesh.shape["data"])
        sharding = data_sharding(mesh, 4)
        batch = batch_blocks or n_data
        batch = max(n_data, (batch // n_data) * n_data)
        groups = [todo[i:i + batch] for i in range(0, len(todo), batch)]

        # ONE jitted program per run: upload u16, convert on device, prefilter,
        # RL — all collectives live in a single XLA module (eager per-op
        # dispatch on sharded arrays can deadlock the CPU in-process
        # communicator).  shard_map: each device runs the unbatched 3D RL
        # on its local blocks
        from jax.sharding import PartitionSpec as P

        from ..ops.deconv import (_rl_fft_iterations, edge_taper_3d,
                                  gauss3d, pad_to_shape, unpad)

        finish = _finish_ops(uni)

        def one_block(b):
            x = b.astype(jnp.float32)
            if gaussian_sigma is not None:
                x = gauss3d(x, gaussian_sigma)
            if dark > 0:
                x = jnp.maximum(x - dark, 0.0)
            psf_n = psf_j / jnp.sum(psf_j)
            x = edge_taper_3d(x, psf_n)
            x, pre, post = pad_to_shape(x, fft_shape)
            # stop_criterion passes through: each block's lax.while_loop
            # exits on its own relative-norm criterion (decon.m:155-204
            # fires per block there too), and under lax.map a converged
            # block really does skip its remaining iterations
            out = _rl_fft_iterations(
                x, psf_n, niter=int(niter), fft_shape=fft_shape,
                lam=float(lam), stop_criterion=float(stop_criterion),
                regularize_interval=int(regularize_interval),
                classic=bool(classic_rl))
            core, qmin, qmax = finish(unpad(out, pre, post))
            if qmin is None:
                return core, jnp.float32(0), jnp.float32(0)
            return core, qmin, qmax

        def local(blocks_raw):  # (B/n_data, D, H, W) on each device
            return jax.lax.map(one_block, blocks_raw)

        spec = P("data", None, None, None)
        from ..parallel.mesh import shard_map_unchecked

        step = jax.jit(shard_map_unchecked(
            local, mesh=mesh, in_specs=spec,
            out_specs=(spec, P("data"), P("data"))))

        def read_group(group):
            # explicit RAM admission before staging a mesh batch of
            # blocks (the reference's free_ram_is_not_enough poll)
            from ..utils.memory import ram_gate

            ram_gate(2 * n_data * 4 * int(np.prod(uni)))
            blocks = [read_block_uniform(vol, p_, uni) for p_ in group]
            # short tail: repeat the last block so the batch (and its
            # sharding) keeps the compiled shape; extras are dropped
            while len(blocks) % n_data:
                blocks.append(blocks[-1])
            return np.stack(blocks)

        # read-ahead deep enough to feed the mesh: decode the next batch
        # on host threads while the device runs RL on the current one
        read_pool = ThreadPoolExecutor(max_workers=min(8, max(2, n_data)))
        next_fut = read_pool.submit(read_group, groups[0])
        mesh_lag = OneInFlight()

        def _drain_mesh(item):
            group_, dec_, qmins_, qmaxs_ = item
            dec_ = np.asarray(dec_)
            qmins_ = np.asarray(qmins_)
            qmaxs_ = np.asarray(qmaxs_)
            for bi, (plan, d) in enumerate(zip(group_, dec_)):
                core_sz = [hi - lo for lo, hi in plan.core]
                core = d[:core_sz[0], :core_sz[1], :core_sz[2]]
                save_core(plan, core,
                          (qmins_[bi], qmaxs_[bi]) if quantize else None)

        for gi, group in enumerate(groups):
            blocks = next_fut.result()
            if gi + 1 < len(groups):
                next_fut = read_pool.submit(read_group, groups[gi + 1])
            dec, qmins, qmaxs = step(device_put_global(blocks, sharding))
            # lagged fetch (same as the single-device path): batch gi
            # streams device->host (copy_to_host_async) while batch gi+1
            # uploads and runs — the two directions overlap instead of
            # serializing
            prev = mesh_lag.put((group, dec, qmins, qmaxs), dec)
            if prev is not None:
                _drain_mesh(prev)
        for item in mesh_lag.flush():
            _drain_mesh(item)
        read_pool.shutdown(wait=False)
    elif todo:
        # ---- single device: one-block read-ahead overlaps IO with RL ------
        # blocks still read at the uniform shape: symmetric edge padding is
        # the reference behavior (LsDeconv.m:877-898) and one shape means
        # one compiled executable for the whole run
        fft_shape = uni
        finish = jax.jit(_finish_ops(uni))
        read_pool = ThreadPoolExecutor(max_workers=1)
        next_fut = read_pool.submit(read_block_uniform, vol, todo[0], uni)
        lag = OneInFlight()  # device->host of block i overlaps RL i+1

        def drain(item):
            plan, core_dev, qmin_dev, qmax_dev = item
            core = np.asarray(core_dev)
            core_sz = [hi - lo for lo, hi in plan.core]
            core = core[:core_sz[0], :core_sz[1], :core_sz[2]]
            save_core(plan, core,
                      (float(qmin_dev), float(qmax_dev))
                      if quantize else None)

        for i, plan in enumerate(todo):
            block = next_fut.result()
            next_fut = (read_pool.submit(read_block_uniform, vol,
                                         todo[i + 1], uni)
                        if i + 1 < len(todo) else None)
            x = jnp.asarray(block).astype(jnp.float32)
            if gaussian_sigma is not None:
                x = gauss3d(x, gaussian_sigma)
            if dark > 0:
                x = jnp.maximum(x - dark, 0.0)
            # single-block path: the unbatched 3D RL executable
            if adaptive_psf:
                from ..ops.deconv import richardson_lucy_wiener

                dec, _psf_est = richardson_lucy_wiener(
                    x, psf_j, niter=niter, lam=lam,
                    regularize_interval=regularize_interval,
                    fft_shape=fft_shape)
            else:
                dec = richardson_lucy(
                    x, psf_j, niter=niter, lam=lam,
                    stop_criterion=stop_criterion,
                    regularize_interval=regularize_interval,
                    fft_shape=fft_shape,
                    classic=classic_rl)
            outs = tuple(finish(dec))
            prev = lag.put((plan,) + outs, outs[0])
            if prev is not None:
                drain(prev)
        for item in lag.flush():
            drain(item)
        read_pool.shutdown(wait=False)

    # streamed reassembly: one output plane in RAM at a time, bricks
    # memory-mapped; global percentile rescale (reference postprocess_save,
    # LsDeconv.m:950-1180)
    missing = [p_.index for p_ in plans
               if not (brick_dir / f"block_{p_.index:05d}.npy").exists()]
    if missing:
        # start_block / partial runs: reassemble once every brick exists
        # (the reference's postprocess_save equally needs all blocks,
        # LsDeconv.m:950)
        log.warn(f"{len(missing)} brick(s) missing (e.g. block "
                 f"{missing[0]:05d}); skipping reassembly — re-run with "
                 "--resume once all blocks are done")
        return output_dir
    log.info(f"reassembling, global stats {stats}")
    info = np.iinfo(out_dtype)
    deconvmin, deconvmax = stats["min"], stats["max"]
    scale = info.max * amplification / max(deconvmax - deconvmin, 1e-30)

    write_pool = ThreadPoolExecutor(max_workers=4)
    pending_writes = []
    z_splits = sorted({p.core[0] for p in plans})
    for (z0, z1) in z_splits:
        zplans = [p for p in plans if p.core[0] == (z0, z1)]
        bricks = {p.index: np.load(brick_dir / f"block_{p.index:05d}.npy",
                                   mmap_mode="r") for p in zplans}
        for i, z in enumerate(range(z0, z1)):
            plane = np.zeros(vol.shape[1:], np.float32)
            for p in zplans:
                (_, _), (y0, y1), (x0, x1) = p.core
                part = bricks[p.index][i]
                qr = quant.get(str(p.index))
                if qr is not None:  # dequantize u16 brick
                    part = (part.astype(np.float32)
                            * ((qr[1] - qr[0]) / 65535.0) + qr[0])
                elif part.dtype == np.uint16:
                    raise RuntimeError(
                        f"brick {p.index} is u16 but has no quant range "
                        f"in the manifest — stale/corrupt brick cache; "
                        f"delete {brick_dir} and re-run")
                plane[y0:y1, x0:x1] = part
            plane = np.clip((plane - deconvmin) * scale,
                            0, info.max).astype(out_dtype)
            pending_writes.append(write_pool.submit(
                tio.imwrite, output_dir / f"img_{z:06d}.tif", plane))
        for f in pending_writes:
            f.result()
        pending_writes.clear()
    write_pool.shutdown(wait=True)

    # run manifest (the decwrap.py JSON log role)
    import time as _time

    manifest_path.write_text(json.dumps({
        "stats": stats, "quant": quant,
        "n_blocks": len(plans), "vol_shape": vol.shape,
        "params": {
            "niter": niter, "lambda": lam, "stop_criterion": stop_criterion,
            "regularize_interval": regularize_interval,
            "gaussian_sigma": gaussian_sigma, "dark": dark,
            "destripe_sigma": destripe_sigma,
            "out_dtype": str(np.dtype(out_dtype)),
            "amplification": amplification,
            "clip_percentile": clip_percentile,
            "classic_rl": classic_rl,
            "psf_shape": list(psf.shape), "halo": list(halo),
            "mesh": dict(mesh.shape) if use_mesh else None,
        },
        "deconvmin": deconvmin, "deconvmax": deconvmax, "scale": scale,
        "finished": _time.strftime("%Y-%m-%d %H:%M:%S"),
    }, indent=1))
    log.info(f"deconvolved series written to {output_dir}")
    return output_dir


def block_elems_arg(max_block_mvox: Optional[float]) -> Optional[int]:
    """--max-block-mvox (Mi-voxels) as autosplit's max_block_elems."""
    return None if max_block_mvox is None else int(max_block_mvox * 2 ** 20)


def build_parser():
    """CLI exposing the LsDeconv parameter surface that has effect here
    (reference decwrap.py + the 29 positional MATLAB args, LsDeconv.m:44-75:
    optics -> PSF, iterations, damping lambda, stop criterion, regularization
    interval, gaussian prefilter, dark, destripe sigma, bit depth,
    amplification, clip percentile, resume, block size)."""
    import argparse

    p = argparse.ArgumentParser(
        description="Richardson-Lucy volume deconvolution "
                    "(LsDeconvolveMultiGPU equivalent)")
    p.add_argument("--input", "-i", required=True, type=Path,
                   help="directory of z-plane TIFFs")
    p.add_argument("--output", "-o", required=True, type=Path)
    p.add_argument("--dxy", type=float, default=406.0,
                   help="xy voxel size in nm")
    p.add_argument("--dz", type=float, default=800.0, help="z step in nm")
    p.add_argument("--na", type=float, default=0.4)
    p.add_argument("--rf", type=float, default=1.45,
                   help="refractive index")
    p.add_argument("--lambda-ex", type=float, default=488.0)
    p.add_argument("--lambda-em", type=float, default=525.0)
    p.add_argument("--fcyl", type=float, default=80000.0)
    p.add_argument("--slitwidth", type=float, default=12000.0)
    p.add_argument("--niter", "-n", type=int, default=10)
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--stop-criterion", type=float, default=0.0)
    p.add_argument("--regularize-interval", type=int, default=0)
    p.add_argument("--gaussian-sigma", type=float, nargs=3, default=None,
                   metavar=("Z", "Y", "X"))
    p.add_argument("--dark", type=float, default=0.0)
    p.add_argument("--destripe-sigma", type=float, default=0.0)
    p.add_argument("--bit-depth", type=int, default=16, choices=[8, 16])
    p.add_argument("--amplification", type=float, default=1.0)
    p.add_argument("--clip-percentile", type=float, default=99.999)
    p.add_argument("--max-block-mvox", type=float, default=None,
                   help="block budget in Mi-voxels of the padded block "
                        "(default: what the device's memory holds)")
    p.add_argument("--reference-scheme", action="store_true",
                   help="use the reference's bl-as-y RL variant")
    p.add_argument("--batch-blocks", type=int, default=None,
                   help="blocks per device batch on a multi-device mesh")
    p.add_argument("--adaptive-psf", action="store_true",
                   help="blind Wiener PSF re-estimation per iteration "
                        "(reference deconFFT_Wiener)")
    p.add_argument("--cache-drive", "--cache-dir", type=Path, default=None,
                   help="brick cache location (default OUTPUT/bricks)")
    p.add_argument("--start-block", type=int, default=0,
                   help="skip blocks below this index (reference "
                        "starting_block)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the block plan and exit")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-strict-accuracy", action="store_true",
                   help="proceed (with a warning) when the block budget "
                        "forces the overlap-save halo to <=2x the PSF "
                        "half-extent, where core NRMSE exceeds the 1e-3 "
                        "spec; by default that configuration is an error")
    return p


def main(argv=None) -> int:
    import numpy as _np

    from ..ops.psf import make_psf

    args = build_parser().parse_args(argv)
    log = Logger()
    psf_xyz, fwhm_xy, fwhm_z = make_psf(
        dxy=args.dxy, dz=args.dz, NA=args.na, n=args.rf,
        lambda_ex=args.lambda_ex, lambda_em=args.lambda_em,
        fcyl=args.fcyl, slitwidth=args.slitwidth)
    psf = _np.transpose(psf_xyz, (2, 1, 0))  # -> (z, y, x)
    log.info(f"PSF {psf.shape}, FWHM xy {fwhm_xy:.0f} nm z {fwhm_z:.0f} nm")
    deconvolve_volume(
        args.input, args.output, psf, niter=args.niter, lam=args.lam,
        stop_criterion=args.stop_criterion,
        regularize_interval=args.regularize_interval,
        gaussian_sigma=tuple(args.gaussian_sigma) if args.gaussian_sigma else None,
        dark=args.dark,
        destripe_sigma=args.destripe_sigma or None,
        out_dtype=_np.uint8 if args.bit_depth == 8 else _np.uint16,
        amplification=args.amplification,
        clip_percentile=args.clip_percentile,
        max_block_elems=block_elems_arg(args.max_block_mvox),
        batch_blocks=args.batch_blocks,
        resume=args.resume,
        classic_rl=not args.reference_scheme,
        strict_accuracy=not args.no_strict_accuracy,
        adaptive_psf=args.adaptive_psf,
        cache_dir=args.cache_drive,
        start_block=args.start_block,
        dry_run=args.dry_run,
        log=log)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

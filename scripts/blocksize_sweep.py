"""RL decon block-size sweep: time per padded voxel and device bytes per
voxel of 6-iteration Richardson-Lucy (the reference's optics PSF) at
2,3,5,7-smooth block shapes.  Feeds the planner's cost model and memory
budget (pipeline/deconvolve.py: _AXIS_PRIME_COST, _BLOCK_OVERHEAD_VOX,
RL_BYTES_PER_VOXEL); the measured table is in PERF.md.

    python scripts/blocksize_sweep.py [Z,Y,X ...]

Each shape runs in a fresh process, one after the other, so
peak_bytes_in_use is that shape's own and a shape that does not fit costs
only its own run.  The parent never imports JAX.
"""
import os
import subprocess
import sys
import time

SHAPES = ["256,256,256", "512,512,512", "768,768,768", "640,1000,1000",
          "768,1024,1024", "1000,1000,1000", "1024,1024,1024"]


def one(shape_arg: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ipp_tpu.ops import deconv as dc
    from ipp_tpu.ops.psf import make_psf
    from ipp_tpu.utils.jaxconfig import enable_persistent_cache

    enable_persistent_cache()
    shape = tuple(int(v) for v in shape_arg.split(","))
    psf_xyz, _, _ = make_psf(dxy=406.0, dz=800.0, NA=0.4, n=1.45,
                             lambda_ex=488.0, lambda_em=525.0,
                             fcyl=80000.0, slitwidth=12000.0)
    psf = jnp.asarray(np.transpose(psf_xyz, (2, 1, 0)), jnp.float32)
    vol = jax.random.uniform(jax.random.key(0), shape, jnp.float32,
                             100.0, 1100.0)
    kw = dict(niter=6, fft_shape=shape, lam=0.0, stop_criterion=0.0,
              regularize_interval=0, edge_taper=True, classic=True,
              sharding=None)
    t0 = time.perf_counter()
    compiled = dc._rl_single.lower(vol, psf, **kw).compile()
    t_compile = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    jax.block_until_ready(compiled(vol, psf))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(vol, psf))
        best = min(best, time.perf_counter() - t0)
    n = float(np.prod(shape))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0)
    print(f"{shape}: compile {t_compile:.1f} s, {best * 1e3:.2f} ms/block, "
          f"{best / n * 1e9:.4f} ns/vox, temp "
          f"{ma.temp_size_in_bytes / n:.1f} B/vox, peak_bytes_in_use "
          f"{peak / n:.1f} B/vox", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        sys.exit(0)
    bad = 0
    for shape in sys.argv[1:] or SHAPES:
        r = subprocess.run([sys.executable, __file__, "--one", shape])
        if r.returncode:
            print(f"({shape}): failed with exit code {r.returncode}",
                  flush=True)
            bad += 1
    sys.exit(1 if bad else 0)

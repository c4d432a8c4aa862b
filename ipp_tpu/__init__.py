"""ipp_tpu — whole-brain light-sheet microscopy preprocessing on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
ucla-brain/image-preprocessing-pipeline (reference layout: pystripe destriping,
TeraStitcher alignment/placement, TSV blending/merge, LsDeconvolveMultiGPU
Richardson-Lucy deconvolution), built for one or more GPUs:

- fused destripe/flat/dark/8-bit tile kernels, vmapped over tile batches and
  sharded over a ``jax.sharding.Mesh`` (replaces pystripe's process pools,
  reference: pystripe/core.py:1687-1771);
- batched FFT normalized cross-correlation for pairwise tile displacement over
  the *whole* search window in one pass (replaces TeraStitcher crossmips'
  O(search^2) NCC loop, reference: src/crossmips/libcrossmips.cpp:101);
- host-side MST global placement on tiny graphs (reference: TPAlgoMST.cpp:66);
- cosine (sin^2) blending with per-tile weight maps precomputed once and reused
  across all z planes (reference recomputes per plane, tsv/volume.py:430-647);
- Richardson-Lucy FFT deconvolution as sharded 3D FFTs over the device mesh
  with real-data halos (replaces the MATLAB+CUDA multi-GPU work-stealing
  runtime, reference: LsDeconvolveMultiGPU/LsDeconv.m, decon.m).
"""

__version__ = "0.1.0"

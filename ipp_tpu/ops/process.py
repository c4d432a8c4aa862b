"""process_img — the fused per-tile processing pipeline.

Re-design of the reference's per-tile workhorse (pystripe/core.py:1190-1382
process_img), with the same stages and defaults, as a composition of the
device ops in this package:

    flat-field divide -> gaussian denoise -> block-reduce downsample ->
    destripe + bleach correction -> dark subtraction -> lightsheet
    correction -> resize -> 16/8-bit conversion -> flip/rotate

Uniform-tile short-circuit (is_uniform_2d -> zeros) and automatic
threshold estimation stay host-side; everything else is jit-compiled per
tile shape and batchable over a leading axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from . import destripe as ds
from . import intensity as it
from . import lightsheet as lsc
from . import resample as rs

__all__ = ["ProcessConfig", "process_img", "process_batch_fn",
           "is_uniform_2d"]


def is_uniform_2d(img: np.ndarray) -> bool:
    """True if every pixel equals the first one
    (reference numba is_uniform_2d, pystripe/core.py:94-123)."""
    return bool((img == img.flat[0]).all())


@dataclass
class ProcessConfig:
    """Mirror of process_img's keyword surface (pystripe/core.py:1190-1236)."""

    flat: Optional[np.ndarray] = None
    gaussian_filter_2d: bool = False
    down_sample: Optional[Tuple[int, int]] = None
    down_sample_method: str = "max"
    new_size: Optional[Tuple[int, int]] = None
    sigma: Tuple[float, float] = (0.0, 0.0)
    level: int = 0
    wavelet: str = "coif15"
    crossover: float = 10.0
    threshold: Optional[float] = None
    padding_mode: str = "wrap"
    bidirectional: bool = False
    bleach_correction_frequency: Optional[float] = None
    bleach_correction_max_method: bool = False
    bleach_correction_clip_min: Optional[float] = None
    bleach_correction_clip_med: Optional[float] = None
    bleach_correction_clip_max: Optional[float] = None
    dark: float = 0.0
    lightsheet: bool = False
    artifact_length: int = 150
    background_window_size: int = 200
    percentile: float = 0.25
    lightsheet_vs_background: float = 2.0
    rotate: int = 0
    flip_upside_down: bool = False
    convert_to_16bit: bool = False
    convert_to_8bit: bool = False
    bit_shift_to_right: int = 8
    d_type: Optional[str] = None


def _out_meta(img_shape, cfg: ProcessConfig, in_dtype):
    """Output (shape, dtype) for the uniform-tile short-circuit
    (reference: pystripe/core.py:1231-1246)."""
    tile = tuple(img_shape)
    if cfg.new_size is not None:
        tile = tuple(cfg.new_size)
    elif cfg.down_sample is not None:
        tile = tuple(-(-s // d) for s, d in zip(tile, cfg.down_sample))
    if cfg.rotate in (90, 270):
        tile = (tile[1], tile[0])
    if cfg.convert_to_16bit:
        dt = np.uint16
    elif cfg.convert_to_8bit:
        dt = np.uint8
    else:
        dt = np.dtype(cfg.d_type) if cfg.d_type else in_dtype
    return tile, dt


def process_img(img: np.ndarray, cfg: Optional[ProcessConfig] = None,
                fetch: bool = True, **kwargs) -> np.ndarray:
    """Apply the full tile pipeline; accepts a config or the reference's
    keyword arguments.

    fetch=False returns the jax device array instead of blocking on a
    host fetch — the handle lagged-fetch callers (convert/executor) need
    so batch k's copy_to_host_async download can overlap batch k+1's
    upload/dispatch.  Uniform short-circuits still return numpy."""
    if cfg is None:
        cfg = ProcessConfig(**kwargs)
    in_dtype = img.dtype

    # host-only short-circuit: skipped when tracing (shard_map/jit callers
    # handle uniform tiles themselves)
    if isinstance(img, np.ndarray) and is_uniform_2d(img):
        # img may carry leading batch dims; the output geometry math is 2D
        tile, dt = _out_meta(img.shape[-2:], cfg, in_dtype)
        return np.zeros(img.shape[:-2] + tile, dt)

    x = jnp.asarray(img)

    if cfg.flat is not None:
        if cfg.flat.shape == tuple(x.shape[-2:]):
            x = it.apply_flat(x.astype(jnp.float32), jnp.asarray(cfg.flat))
        # shape mismatch: reference warns and skips (pystripe/core.py:1248-1255)

    if cfg.gaussian_filter_2d:
        # reference: cv2.GaussianBlur ksize 5, sigma 1 (pystripe/core.py:1284)
        x = it.gaussian_blur2d(x.astype(jnp.float32), 1.0, radius=2)

    if cfg.down_sample is not None:
        # x may carry a leading batch dim (the batched tile path)
        bs = (1,) * (x.ndim - 2) + tuple(cfg.down_sample)
        x = rs.block_reduce(x, bs, cfg.down_sample_method)

    needs_streaks = (cfg.bleach_correction_frequency is not None
                     or tuple(cfg.sigma) > (0, 0))
    if needs_streaks:
        clip_min = cfg.bleach_correction_clip_min
        clip_med = cfg.bleach_correction_clip_med
        clip_max = cfg.bleach_correction_clip_max
        if needs_host_stats(cfg):
            import jax as _jax

            if isinstance(x, _jax.core.Tracer):
                raise ValueError(
                    "bleach clips must be resolved host-side before traced "
                    "(sharded/jitted) process_img calls — run "
                    "ops.stats.threshold_multiotsu on sample planes first")
            from .stats import threshold_multiotsu

            lb, mb, ub = threshold_multiotsu(
                np.log1p(np.asarray(x, dtype=np.float32)), classes=4)
            clip_min = lb if clip_min is None else clip_min
            clip_med = mb if clip_med is None else clip_med
            clip_max = ub if clip_max is None else clip_max
        x = ds.filter_streaks(
            x, sigma=tuple(cfg.sigma), level=cfg.level, wavelet=cfg.wavelet,
            crossover=cfg.crossover, threshold=cfg.threshold,
            padding_mode=cfg.padding_mode, bidirectional=cfg.bidirectional,
            bleach_correction_frequency=cfg.bleach_correction_frequency,
            bleach_correction_max_method=cfg.bleach_correction_max_method,
            bleach_correction_clip_min=clip_min,
            bleach_correction_clip_med=clip_med,
            bleach_correction_clip_max=clip_max)

    if cfg.dark is not None and cfg.dark > 0:
        x = it.subtract_dark(x, cfg.dark)

    if cfg.lightsheet:
        x = lsc.correct_lightsheet(
            x, percentile=cfg.percentile,
            artifact_length=cfg.artifact_length,
            background_window_size=cfg.background_window_size,
            lightsheet_vs_background=cfg.lightsheet_vs_background)

    if cfg.new_size is not None and tuple(x.shape[-2:]) != tuple(cfg.new_size):
        upscaling = tuple(x.shape[-2:]) < tuple(cfg.new_size)
        x = rs.resize(x, x.shape[:-2] + tuple(cfg.new_size),
                      anti_aliasing=not upscaling)

    if cfg.convert_to_16bit and x.dtype != jnp.uint16:
        x = it.convert_to_16bit(x)
    elif cfg.convert_to_8bit and x.dtype != jnp.uint8:
        x = it.convert_to_8bit(x, cfg.bit_shift_to_right)
    else:
        dt = np.dtype(cfg.d_type) if cfg.d_type else in_dtype
        if np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            x = jnp.clip(jnp.rint(x.astype(jnp.float32)), info.min, info.max)
        x = x.astype(dt)

    if cfg.flip_upside_down:
        x = jnp.flip(x, axis=-2)
    if cfg.rotate in (90, 180, 270):
        x = jnp.rot90(x, cfg.rotate // 90, axes=(-2, -1))

    # fetch to host for eager callers; keep tracers symbolic so the whole
    # function composes under jit/shard_map
    import jax as _jax

    if isinstance(x, _jax.core.Tracer) or not fetch:
        return x
    return np.asarray(x)


def needs_host_stats(cfg: ProcessConfig) -> bool:
    """True when process_img must run host-side per plane: unresolved
    bleach clips trigger a per-IMAGE multi-Otsu (the reference resolves
    them per plane, pystripe/core.py:696-727) — batching such planes
    would make the clips a batch-global statistic."""
    return (cfg.bleach_correction_frequency is not None
            and (cfg.bleach_correction_clip_min is None
                 or cfg.bleach_correction_clip_med is None
                 or cfg.bleach_correction_clip_max is None))


def process_batch_fn(cfg: ProcessConfig):
    """One jitted batch-process_img per cfg, cached on the cfg object.

    The jitted closure compiles process_img's whole op chain into ONE
    executable per (batch, H, W) shape (no per-op dispatch for the
    converter stream and the tile executor) and returns the DEVICE array
    (fetch=False), which the callers' one-batch-in-flight lagged fetch
    needs to overlap batch k's download with batch k+1's upload.
    Callers must gate on needs_host_stats(cfg) (jit would raise) and
    handle uniform tiles themselves (the short-circuit is skipped under
    tracing)."""
    fn = getattr(cfg, "_jit_batch_fn", None)
    if fn is None:
        if needs_host_stats(cfg):
            raise ValueError("cfg resolves bleach clips per plane — "
                             "gate on needs_host_stats(cfg)")
        import jax as _jax

        fn = _jax.jit(lambda b: process_img(b, cfg, fetch=False))
        cfg._jit_batch_fn = fn
    return fn

"""Down/Up-sampling: block_reduce, anti-aliased resize, isotropic planning.

Device equivalents of the reference's skimage-based resampling:

- block_reduce (skimage semantics: pad to a block multiple with zeros, then
  reduce) — used for tile downsampling (pystripe/core.py:1296-1302) and the
  on-the-fly alternating max/mean isotropic downsample of the merge stage
  (parallel_image_processor.py:176-187, 411-435).
- resize: order-1 interpolation with optional gaussian anti-aliasing
  (sigma=(factor-1)/2 per axis), matching skimage.transform.resize within
  float tolerance (used for new_size tiles and the exact z-axis resize,
  parallel_image_processor.py:720-724).
- plan_isotropic_downsampling: the reference's voxel-size-driven plan of
  alternating max/mean halvings (calculate_down_sampling_target,
  parallel_image_processor.py:156-189).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["block_reduce", "resize", "plan_isotropic_downsampling",
           "isotropic_downsample_plane", "IsotropicAccumulator"]


def block_reduce(img: jnp.ndarray, block_size, func: str = "max") -> jnp.ndarray:
    """skimage.measure.block_reduce equivalent (zero padding to a multiple of
    block_size, then reduce each block with func)."""
    if np.isscalar(block_size):
        block_size = (int(block_size),) * img.ndim
    block_size = tuple(int(b) for b in block_size)
    assert len(block_size) == img.ndim
    pads = [(0, (-s) % b) for s, b in zip(img.shape, block_size)]
    if any(p[1] for p in pads):
        img = jnp.pad(img, pads, mode="constant")
    new_shape = []
    for s, b in zip(img.shape, block_size):
        new_shape += [s // b, b]
    x = img.reshape(new_shape)
    axes = tuple(range(1, 2 * img.ndim, 2))
    if func == "max":
        return jnp.max(x, axis=axes)
    if func == "min":
        return jnp.min(x, axis=axes)
    if func == "mean":
        return jnp.mean(x.astype(jnp.float32), axis=axes)
    if func == "sum":
        # skimage's default reducer; accumulate wide like np.sum does
        return jnp.sum(x.astype(jnp.int64 if
                                jnp.issubdtype(x.dtype, jnp.integer)
                                else jnp.float32), axis=axes)
    if func == "median":
        return jnp.median(x.astype(jnp.float32), axis=axes)
    raise ValueError(f"unsupported reduce func {func!r}")


def _aa_sigma(in_len: int, out_len: int) -> float:
    factor = in_len / out_len
    return max(0.0, (factor - 1.0) / 2.0)


def _gauss_blur_axis(x: jnp.ndarray, sigma: float, axis: int) -> jnp.ndarray:
    if sigma <= 0:
        return x
    radius = max(1, int(4.0 * sigma + 0.5))
    t = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    xm = jnp.moveaxis(x, axis, -1)
    pad = [(0, 0)] * (xm.ndim - 1) + [(radius, radius)]
    xp = jnp.pad(xm, pad, mode="reflect")
    lhs = xp.reshape(-1, 1, xp.shape[-1])
    rhs = jnp.asarray(k)[None, None, :]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, (1,), "VALID", dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    return jnp.moveaxis(out.reshape(xm.shape), -1, axis)


def resize(img: jnp.ndarray, out_shape: Sequence[int],
           anti_aliasing: Optional[bool] = None) -> jnp.ndarray:
    """Order-1 resize with skimage-style gaussian anti-aliasing on
    downscale.  Output is float32."""
    out_shape = tuple(int(s) for s in out_shape)
    x = img.astype(jnp.float32)
    if anti_aliasing is None:
        anti_aliasing = any(o < s for o, s in zip(out_shape, x.shape))
    if anti_aliasing:
        for ax, (s, o) in enumerate(zip(x.shape, out_shape)):
            if o < s:
                x = _gauss_blur_axis(x, _aa_sigma(s, o), ax)
    return jax.image.resize(x, out_shape, method="linear")


def plan_isotropic_downsampling(
    plane_shape: Tuple[int, int],
    source_voxel_yx: Tuple[float, float],
    target_voxel: float,
) -> Tuple[Tuple[int, int], List[Tuple[Optional[str], Optional[str]]]]:
    """Plan the alternating max/mean halvings that take merged planes toward
    an isotropic target voxel (reference calculate_down_sampling_target,
    parallel_image_processor.py:156-189).

    Returns (target_shape_yx, [(method_y, method_x) per halving]) where
    methods alternate max/mean starting with max on y and mean on x."""
    reduction = np.array([target_voxel / source_voxel_yx[0],
                          target_voxel / source_voxel_yx[1]])
    target_shape = tuple(max(1, int(round(s / r)))
                         for s, r in zip(plane_shape, reduction))
    factors = np.floor(np.sqrt(reduction)).astype(int)
    meth_y: List[Optional[str]] = ["max" if i % 2 == 0 else "mean"
                                   for i in range(factors[0])]
    meth_x: List[Optional[str]] = ["mean" if i % 2 == 0 else "max"
                                   for i in range(factors[1])]
    if len(meth_y) > len(meth_x):
        meth_x += [None] * (len(meth_y) - len(meth_x))
    elif len(meth_x) > len(meth_y):
        meth_y += [None] * (len(meth_x) - len(meth_y))
    return target_shape, list(zip(meth_y, meth_x))


def isotropic_downsample_plane(img, target_shape: Tuple[int, int],
                               methods, resize_final: bool = True):
    """Apply a planned in-plane downsample ladder to one plane: per-AXIS
    block reductions — y then x, each with its own method and each guarded
    by the target shape — then an anti-aliased resize to the exact target
    (reference parallel_image_processor.py:376-384: separate (2,1)/(1,2)
    block_reduce calls per rung, skipped once ceil(dim/2) would undershoot
    the target).  Output is float32."""
    small = jnp.asarray(img).astype(jnp.float32)
    for my, mx in methods:
        if my is not None and -(-small.shape[0] // 2) >= target_shape[0]:
            small = block_reduce(small, (2, 1), my)
        if mx is not None and -(-small.shape[1] // 2) >= target_shape[1]:
            small = block_reduce(small, (1, 2), mx)
    if resize_final and tuple(small.shape) != tuple(target_shape):
        small = resize(small, target_shape)
    return small


class IsotropicAccumulator:
    """Streamed isotropic downsample of a plane series — the converter's
    equivalent of the reference worker z_stack + tail
    (parallel_image_processor.py:334-435: per-plane xy ladder into z
    chunks of floor(r_z) planes, each reduced by ceil(sqrt(r_z))
    alternating-from-max z halvings, uniform planes/chunks short-circuited
    to zeros; the merge stage has its own inline twin in stitch/merge.py).

    add(plane) returns the reduced chunk plane (float32) when a chunk
    completes, else None; flush() drains a partial tail chunk; volume()
    stacks everything for the exact final z resize (downsampled_npz)."""

    def __init__(self, plane_shape: Tuple[int, int],
                 voxel_zyx: Tuple[float, float, float],
                 target_voxel: float, alternating: bool = True):
        self.target_shape, self.methods = plan_isotropic_downsampling(
            plane_shape, (voxel_zyx[1], voxel_zyx[2]), target_voxel)
        if not alternating:
            # the reference converter passes a non-empty --downsample-method
            # by default -> EVERY rung becomes (mean, mean), including the
            # None-padded slots of the shorter axis — the per-axis
            # ceil(dim/2) >= target guard in isotropic_downsample_plane is
            # what stops over-reduction, exactly as in the reference
            # (parallel_image_processor.py:184-187, convert.py:129)
            self.methods = [("mean", "mean") for _ in self.methods]
        self.chunk_len = max(1, int(target_voxel // voxel_zyx[0]))
        self.n_z = int(np.ceil(np.sqrt(target_voxel / voxel_zyx[0])))
        self._chunk: List[np.ndarray] = []
        self._reduced: List[np.ndarray] = []

    def _reduce_chunk(self) -> np.ndarray:
        stack = np.stack(self._chunk)
        self._chunk.clear()
        if (stack == stack.flat[0]).all():   # is_uniform_3d (:413-415)
            out = np.zeros(self.target_shape, np.float32)
        else:
            for i in range(self.n_z):
                if stack.shape[0] <= 1:
                    break
                stack = np.asarray(block_reduce(
                    stack, (2, 1, 1), "max" if i % 2 == 0 else "mean"))
            out = stack[0]
        self._reduced.append(out)
        return out

    def add(self, plane: np.ndarray):
        v0 = plane.flat[0]
        if plane.flat[-1] == v0 and (plane == v0).all():
            small = np.zeros(self.target_shape, np.float32)
        else:
            small = np.asarray(isotropic_downsample_plane(
                plane, self.target_shape, self.methods))
        self._chunk.append(small)
        if len(self._chunk) == self.chunk_len:
            return self._reduce_chunk()
        return None

    def flush(self):
        if self._chunk:
            return self._reduce_chunk()
        return None

    def volume(self) -> np.ndarray:
        if not self._reduced:
            return np.zeros((0,) + tuple(self.target_shape), np.float32)
        return np.stack(self._reduced)

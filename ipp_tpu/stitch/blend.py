"""Cosine (sin^2) tile blending — reference-exact weights, device accumulation.

Re-design of the TSV blending path (reference tsv/volume.py:430-647):

- `get_distance_from_edge` / `compute_cosine` are ported faithfully on the
  host (numpy, small 2D maps), BUT the per-stack weight maps are computed
  once per plane-layout and cached — the reference recomputes them for every
  z plane, which dominated its merge cost; for a constant-z tile grid the
  weights are identical for all planes.
- accumulation (sum of weighted tiles + weight normalization) runs on device
  in one jitted executable per plane layout (static tile extents ->
  dynamic_update_slice adds).
"""

from __future__ import annotations

import enum
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.extent import VExtent
from ..utils import iostat

__all__ = ["distance_from_edge", "cosine_blend_weight", "PlaneBlender"]


class Edge(enum.Flag):
    XMIN = enum.auto()
    XMAX = enum.auto()
    YMIN = enum.auto()
    YMAX = enum.auto()
    ZMIN = enum.auto()
    ZMAX = enum.auto()


def distance_from_edge(tgt: VExtent, stack: VExtent, ostack: VExtent) -> np.ndarray:
    """Per-voxel distance to the nearest relevant edge of the stack/ostack
    overlap (faithful port of tsv/volume.py:490-556)."""
    edges = Edge(0)
    if ostack.x1 > stack.x0 > ostack.x0:
        edges |= Edge.XMIN
    if ostack.x0 < stack.x1 < ostack.x1:
        edges |= Edge.XMAX
    if ostack.y1 > stack.y0 > ostack.y0:
        edges |= Edge.YMIN
    if ostack.y0 < stack.y1 < ostack.y1:
        edges |= Edge.YMAX
    volume = stack.intersection(ostack)
    assert volume.contains(tgt)
    max_distance = np.inf
    if ostack.x1 != stack.x1 and ostack.x0 != stack.x0:
        max_distance = volume.shape[2]
    if ostack.y1 != stack.y1 and ostack.y0 != stack.y0:
        max_distance = min(max_distance, volume.shape[1])
    if np.isinf(max_distance) and ostack.z1 != stack.z1 and ostack.z0 != stack.z0:
        max_distance = min(max_distance, volume.shape[0])
        if ostack.z1 > stack.z0 > ostack.z0:
            edges |= Edge.ZMIN
        if ostack.z0 < stack.z1 < ostack.z1:
            edges |= Edge.ZMAX
    result = np.ones(tgt.shape, np.float32) * max_distance
    for idx, flag in enumerate((Edge.ZMIN, Edge.YMIN, Edge.XMIN)):
        if edges & flag:
            sl = [np.newaxis] * 3
            sl[idx] = slice(0, tgt.shape[idx])
            ramp = np.arange(tgt.start(idx) - volume.start(idx) + 1,
                             tgt.end(idx) - volume.start(idx) + 1)
            result = np.minimum(result, ramp[tuple(sl)])
    for idx, flag in enumerate((Edge.ZMAX, Edge.YMAX, Edge.XMAX)):
        if edges & flag:
            sl = [np.newaxis] * 3
            sl[idx] = slice(0, tgt.shape[idx])
            ramp = np.arange(volume.end(idx) - tgt.start(idx),
                             volume.end(idx) - tgt.end(idx), -1)
            result = np.minimum(result, ramp[tuple(sl)])
    return result


def cosine_blend_weight(intersection: VExtent, stack_ext: VExtent,
                        others: Sequence[VExtent]) -> np.ndarray:
    """Blend weight for one stack over its intersection with the read volume:
    product over overlapping neighbors of sin^2(atan2(d, od))
    (reference compute_cosine, tsv/volume.py:430-466)."""
    w = np.ones(intersection.shape, np.float32)
    for o_ext in others:
        if not intersection.intersects(o_ext):
            continue
        iv = intersection.intersection(o_ext)
        d = distance_from_edge(iv, stack_ext, o_ext)
        od = distance_from_edge(iv, o_ext, stack_ext)
        if np.min(d) == np.inf:
            d[:] = np.max(od)
        elif np.min(od) == np.inf:
            od[:] = np.max(d)
        blending = np.sin(np.arctan2(d, od)).astype(np.float32) ** 2
        sl = intersection.local_slices(iv)
        w[sl] *= blending
    return w


@partial(jax.jit, static_argnames=("offsets", "canvas_shape", "cosine"))
def _blend_accumulate(parts: Tuple[jnp.ndarray, ...],
                      weights: Tuple[jnp.ndarray, ...],
                      offsets: Tuple[Tuple[int, int], ...],
                      canvas_shape: Tuple[int, int],
                      cosine: bool):
    if cosine:
        acc = jnp.zeros(canvas_shape, jnp.float32)
        mul = jnp.zeros(canvas_shape, jnp.float32)
        for part, w, (oy, ox) in zip(parts, weights, offsets):
            p = part.astype(jnp.float32) * w
            acc = jax.lax.dynamic_update_slice(
                acc, jax.lax.dynamic_slice(acc, (oy, ox), p.shape) + p, (oy, ox))
            mul = jax.lax.dynamic_update_slice(
                mul, jax.lax.dynamic_slice(mul, (oy, ox), w.shape) + w, (oy, ox))
        eps = jnp.float32(np.finfo(np.float16).eps)  # reference uses f16 eps
        return jnp.where(mul > eps, acc / mul, acc / eps)
    acc = jnp.zeros(canvas_shape, jnp.float32)
    for part, _w, (oy, ox) in zip(parts, weights, offsets):
        cur = jax.lax.dynamic_slice(acc, (oy, ox), part.shape)
        acc = jax.lax.dynamic_update_slice(
            acc, jnp.maximum(cur, part.astype(jnp.float32)), (oy, ox))
    return acc


@partial(jax.jit, static_argnames=("offsets", "canvas_shape", "cosine"))
def _blend_accumulate_planes(parts: Tuple[jnp.ndarray, ...],
                             weights: Tuple[jnp.ndarray, ...],
                             offsets: Tuple[Tuple[int, int], ...],
                             canvas_shape: Tuple[int, int],
                             cosine: bool):
    """Batched form of _blend_accumulate: parts are (B, h, w) z-plane stacks
    sharing one xy layout and one 2D weight map per tile (constant across z
    for column-aligned grids).  The batch axis stays leading so a 'data'
    sharding turns this into the mesh-parallel step 6
    (Parastitcher master_step6's output-slab fan-out, Parastitcher.py:570)."""
    B = parts[0].shape[0]
    shape3 = (B,) + tuple(canvas_shape)
    if cosine:
        acc = jnp.zeros(shape3, jnp.float32)
        mul = jnp.zeros(canvas_shape, jnp.float32)
        for part, w, (oy, ox) in zip(parts, weights, offsets):
            p = part.astype(jnp.float32) * w[None]
            cur = jax.lax.dynamic_slice(acc, (0, oy, ox), p.shape)
            acc = jax.lax.dynamic_update_slice(acc, cur + p, (0, oy, ox))
            curw = jax.lax.dynamic_slice(mul, (oy, ox), w.shape)
            mul = jax.lax.dynamic_update_slice(mul, curw + w, (oy, ox))
        eps = jnp.float32(np.finfo(np.float16).eps)  # reference uses f16 eps
        return jnp.where(mul[None] > eps, acc / mul[None], acc / eps)
    acc = jnp.zeros(shape3, jnp.float32)
    for part, _w, (oy, ox) in zip(parts, weights, offsets):
        cur = jax.lax.dynamic_slice(acc, (0, oy, ox), part.shape)
        acc = jax.lax.dynamic_update_slice(
            acc, jnp.maximum(cur, part.astype(jnp.float32)), (0, oy, ox))
    return acc


def _cast_on_device(out, dtype):
    """Device-side round/clip/cast for integer outputs, so the fetch
    moves integer-width bytes.  A device_post hook may already have
    produced the target dtype — passed through unchanged."""
    if (np.issubdtype(np.dtype(dtype), np.integer)
            and out.dtype != np.dtype(dtype)):
        info = np.iinfo(dtype)
        out = jnp.clip(jnp.rint(out.astype(jnp.float32)),
                       info.min, info.max).astype(dtype)
    return out


def _to_output_dtype(out, dtype):
    """_cast_on_device + host fetch; non-integer dtypes cast host-side
    only when needed.  Shared by blend_plane and blend_planes."""
    out_np = np.asarray(_cast_on_device(out, dtype))
    return (out_np if out_np.dtype == np.dtype(dtype)
            else out_np.astype(dtype))


class PlaneBlender:
    """Blends one z plane of a placed tile grid into a canvas.

    Weight maps are cached per (stack extent, neighbor extents) — constant
    across z for column-aligned grids, so the per-plane work is pure device
    accumulation."""

    def __init__(self, extents: Sequence[VExtent], cosine: bool = True):
        self.extents = list(extents)
        self.cosine = cosine
        self._weight_cache: Dict[Tuple, np.ndarray] = {}

    def weights_for(self, volume: VExtent) -> List[Tuple[int, VExtent, np.ndarray]]:
        """[(stack_index, intersection, weight2d)] for stacks hitting volume."""
        hits = [(i, e) for i, e in enumerate(self.extents) if e.intersects(volume)]
        out = []
        for i, ext in hits:
            inter = ext.intersection(volume)
            others = tuple(self.extents[j].intersection(volume)
                           for j, e2 in hits if j != i
                           and self.extents[j].intersection(volume).intersects(inter))
            key = (inter, ext, others)
            w = self._weight_cache.get(key)
            if w is None:
                w3 = cosine_blend_weight(inter, ext, others)
                w = w3[0] if w3.shape[0] == 1 else w3
                # cache as a device array: weight maps are reused for every
                # z plane, so the host->HBM upload happens once per layout
                w = jnp.asarray(w, jnp.float32)
                self._weight_cache[key] = w
            out.append((i, inter, w))
        return out

    def weights_for_batch(self, volume: VExtent):
        """Like weights_for, but for a MULTI-plane volume sharing one xy
        layout: returns [(stack_index, 3D intersection, weight2d)] with the
        weights computed once on the first plane, or None when the layout
        is not constant across the volume's z range (some stack starts or
        ends mid-batch) — callers then fall back to per-plane blending."""
        z0 = volume.z0
        plane = VExtent(volume.x0, volume.x1, volume.y0, volume.y1,
                        z0, z0 + 1)
        # a stack intersecting ANY plane of the batch must cover ALL of it
        # with the same xy footprint, else weights differ across planes
        for e in self.extents:
            if e.intersects(volume):
                inter = e.intersection(volume)
                if inter.z0 != volume.z0 or inter.z1 != volume.z1:
                    return None
        hits = self.weights_for(plane)
        out = []
        for i, inter_p, w in hits:
            inter = self.extents[i].intersection(volume)
            out.append((i, inter, w))
        return out

    def blend_planes_async(self, volume: VExtent, reader, dtype=np.uint16,
                           sharding=None, pad_to: int = 1,
                           device_post=None):
        """blend_planes with the FETCH deferred: returns None on layout
        change (caller falls back, same contract), else a zero-arg
        callable producing the (B, H, W) host array.  The device->host
        copy starts immediately (copy_to_host_async), so the caller can
        dispatch the NEXT batch's uploads/blend while this one streams
        back — the two transfer directions overlap and the merge loop
        stops serializing fetch against upload."""
        out = self._blend_planes_device(volume, reader, dtype, sharding,
                                        pad_to, device_post)
        if out is None:
            return None
        dev, B = out
        # IPP_TPU_MERGE_ASYNC=0 drops the early host-copy kick (the fetch
        # then happens inside finish(), still one batch behind the
        # dispatch loop) — escape hatch for backends whose async copy
        # misbehaves
        import os as _os

        if _os.environ.get("IPP_TPU_MERGE_ASYNC", "1") != "0":
            try:
                dev.copy_to_host_async()
            except Exception:  # noqa: BLE001 — backend without async copy
                pass

        def finish() -> np.ndarray:
            with iostat.span("device_fetch",
                             int(np.prod(dev.shape))
                             * np.dtype(dtype).itemsize):
                out_np = np.asarray(dev)
            return (out_np if out_np.dtype == np.dtype(dtype)
                    else out_np.astype(dtype))[:B]

        return finish

    def blend_planes(self, volume: VExtent, reader, dtype=np.uint16,
                     sharding=None, pad_to: int = 1,
                     device_post=None) -> Optional[np.ndarray]:
        """Blend a batch of B = volume.shape[0] z planes in ONE device call.

        reader(stack_index, 3D intersection) -> (B, h, w) crop stack.
        With `sharding` (a NamedSharding over the batch axis), the blend
        runs mesh-parallel — each device accumulates its planes (the
        master_step6 slab fan-out, reference Parastitcher.py:570).  pad_to
        pads the batch by edge replication to a device-count multiple.
        device_post: optional device-side per-plane post-processing hook
        ((B', H, W) float32 -> (B', H, W) any dtype, batch semantics) run
        on the accumulated canvas BEFORE the fetch — under a batch
        sharding it executes mesh-parallel (the process_img role of the
        reference's merge workers, parallel_image_processor.py:334-384)
        and the fetch then moves post-processed (integer-width) bytes.
        Returns (B, H, W) in `dtype`, or None if the xy layout is not
        constant across the batch (caller falls back to blend_plane).
        """
        out = self._blend_planes_device(volume, reader, dtype, sharding,
                                        pad_to, device_post)
        if out is None:
            return None
        dev, B = out
        if isinstance(dev, np.ndarray):  # empty-volume fast path
            return dev
        with iostat.span("device_fetch",
                         int(np.prod(dev.shape)) * np.dtype(dtype).itemsize):
            out_np = np.asarray(dev)
        return (out_np if out_np.dtype == np.dtype(dtype)
                else out_np.astype(dtype))[:B]

    def _blend_planes_device(self, volume, reader, dtype, sharding,
                             pad_to, device_post):
        """Shared device-side half of blend_planes: reads, uploads,
        accumulates, device-post-processes and device-casts — returns
        (device array in `dtype` (integer targets) or f32, B), a plain
        (B, H, W) ndarray for empty volumes, or None on a mid-batch
        layout change."""
        hits = self.weights_for_batch(volume)
        if hits is None:
            return None
        B = volume.shape[0]
        canvas_shape = volume.shape[1:]
        if not hits:
            return np.zeros((B,) + canvas_shape, dtype), B
        parts, weights, offsets = [], [], []
        pad = (-B) % max(1, pad_to)
        for i, inter, w in hits:
            img = reader(i, inter)
            img = np.asarray(img)
            assert img.shape[0] == B, (img.shape, B)
            if pad:
                img = np.concatenate([img] + [img[-1:]] * pad, axis=0)
            # device_put the HOST array straight onto the sharding: going
            # through jnp.asarray first would commit the whole stack to
            # device 0 and pay a second device-to-device relayout
            with iostat.span("device_upload", img.nbytes):
                part = (jax.device_put(img, sharding) if sharding is not None
                        else jnp.asarray(img))
            parts.append(part)
            weights.append(w if self.cosine
                           else jnp.ones(img.shape[1:], jnp.float32))
            offsets.append((inter.y0 - volume.y0, inter.x0 - volume.x0))
        with iostat.span("device_dispatch"):
            out = _blend_accumulate_planes(
                tuple(parts), tuple(weights), tuple(offsets), canvas_shape,
                self.cosine)
            if device_post is not None:
                out = device_post(out)
            # kept on device for the async-fetch path
            out = _cast_on_device(out, dtype)
        return out, B

    def blend_plane(self, volume: VExtent,
                    reader, dtype=np.uint16) -> np.ndarray:
        """Blend one plane (volume.shape[0] == 1).

        reader(stack_index, intersection) -> 2D array for that stack's crop.
        Returns the blended (H, W) plane in `dtype`
        (reference TSVVolumeBase.imread, tsv/volume.py:575-647).
        """
        assert volume.shape[0] == 1
        hits = self.weights_for(volume)
        canvas_shape = volume.shape[1:]
        if not hits:
            return np.zeros(canvas_shape, dtype)
        parts, weights, offsets = [], [], []
        for i, inter, w in hits:
            img = reader(i, inter)
            img2 = img[0] if img.ndim == 3 else img
            with iostat.span("device_upload", img2.nbytes):
                parts.append(jnp.asarray(img2))
            ww = (w if self.cosine
                  else jnp.ones(img2.shape, jnp.float32))
            weights.append(ww)
            offsets.append((inter.y0 - volume.y0, inter.x0 - volume.x0))
        with iostat.span("device_dispatch"):
            out = _blend_accumulate(tuple(parts), tuple(weights),
                                    tuple(offsets), canvas_shape, self.cosine)
        with iostat.span("device_fetch",
                         int(np.prod(out.shape)) * np.dtype(dtype).itemsize):
            return _to_output_dtype(out, dtype)

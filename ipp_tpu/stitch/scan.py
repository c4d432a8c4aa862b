"""Piezo-stack scanner alignment — the tsv/scan.py equivalent.

Re-design of the reference's "dragonfly" aligner (tsv/scan.py:31-1143):
a 3D grid of ScanStacks (x, y, z indices) aligned pairwise along x, y AND
z, with the reference's three distinctive mechanisms:

- **dark-frame masking** (tsv/scan.py:392-458, align_plane_x:318-333):
  pixels at or below the dark level are excluded; a pair whose overlap has
  fewer than sqrt(area) above-dark pixels on either side scores 0 and
  contributes nothing;
- **AverageDrift** (tsv/scan.py:136-160): the median inter-stack offset
  per adjacency direction (with outlier rejection,
  compute_median_min_max_without_outliers:470-478) — the stage-vs-
  objective axis misalignment.  Alignment runs in rounds: round k+1
  re-centers its search window on the round-k drift and shrinks the slop
  (calculate_next_round_parameters:501-528);
- **per-stack linear drift** (ScanStack.x_off_per_z/y_off_per_z,
  tsv/scan.py:85-117): within one piezo travel the frames creep linearly
  in x/y; estimated from first-vs-last-plane NCC and applied as a per-z
  integer shift when reading planes.

Global positions come from a reliability-weighted least-squares solve over
all pairwise links (scores as weights, anchor at the first stack) — the
same relaxation as stitch.place.place_tiles_lqp, replacing the reference's
per-axis median chains (flat_adjust_stacks:724-818) which cannot reconcile
loop inconsistencies.

Each adjacent pair is scored as a batched plane-sweep (sample planes of
one stack vs a z-window of the other with all (dy, dx) shifts at once via
ops/ncc.ncc_maps_batched — the reference's align_one_x/y/z structure,
tsv/scan.py:841-1063, without its nested Pearson loops); blending uses
distance-to-edge weights (the reference's EDT-weighted blend — exact for
box-shaped stacks as a separable min-ramp).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..geometry.extent import VExtent
from ..io import tiff as tio
from ..io.raw import raw_imread
from ..ops.ncc import (NCCParams, ncc_map, ncc_maps_batched,
                       peak_and_widths)
from ..utils.log import Logger

__all__ = ["ScanStack", "Scanner", "AverageDrift"]


def _imread(path: Path) -> np.ndarray:
    """Suffix-dispatched plane read (reference tsv/scan.py:16-21 imread:
    .raw via the raw codec, anything else as TIFF)."""
    if str(path).endswith(".raw"):
        return np.asarray(raw_imread(path))
    return tio.imread(path)


@dataclass
class AverageDrift:
    """Median offset between adjacent stacks per adjacency direction
    (reference AverageDrift, tsv/scan.py:136-160): `<axis>off<dir>` is the
    axis-offset of stacks adjacent along dir."""

    xoffx: int = 0
    yoffx: int = 0
    zoffx: int = 0
    xoffy: int = 0
    yoffy: int = 0
    zoffy: int = 0
    xoffz: int = 0
    yoffz: int = 0
    zoffz: int = 0

    def for_side(self, side: str) -> Tuple[int, int, int]:
        """(dy, dx, dz) window recentering for a side ('we', 'ns', 'tb')."""
        d = {"we": (self.yoffx, self.xoffx, self.zoffx),
             "ns": (self.yoffy, self.xoffy, self.zoffy),
             "tb": (self.yoffz, self.xoffz, self.zoffz)}[side]
        return d


def _median_without_outliers(vals: List[float], stds: float = 3.0) -> float:
    """reference compute_median_min_max_without_outliers
    (tsv/scan.py:470-478)."""
    if not vals:
        return 0.0
    arr = np.asarray(vals, np.float64)
    med = np.median(arr)
    lim = np.std(arr) * stds
    kept = arr[(arr >= med - lim) & (arr <= med + lim)]
    return float(np.median(kept)) if kept.size else float(med)


@dataclass
class ScanStack:
    """One piezo substack: z-ordered plane files at a nominal (x0, y0, z0)
    (reference ScanStack, tsv/scan.py:31-133)."""

    paths: List[Path]
    x0: int
    y0: int
    z0: int
    drift_x: float = 0.0  # per-z linear drift (reference x_off_per_z)
    drift_y: float = 0.0
    _shape: Optional[Tuple[int, int]] = field(default=None, repr=False)

    @property
    def plane_shape(self) -> Tuple[int, int]:
        if self._shape is None:
            self._shape = _imread(self.paths[0]).shape
        return self._shape

    @property
    def extent(self) -> VExtent:
        h, w = self.plane_shape
        return VExtent(self.x0, self.x0 + w, self.y0, self.y0 + h,
                       self.z0, self.z0 + len(self.paths))

    def read_plane(self, z: int, apply_drift: bool = True) -> np.ndarray:
        """Read plane z, undoing the per-z linear drift (reference
        ScanStack.read_plane trims by x_off_per_z*z, tsv/scan.py:108-117;
        here the shift wraps with np.roll and the wrapped strip zeroes)."""
        img = _imread(self.paths[z])
        if not apply_drift or (self.drift_x == 0 and self.drift_y == 0):
            return img
        dx = int(round(self.drift_x * z))
        dy = int(round(self.drift_y * z))
        if dx == 0 and dy == 0:
            return img
        out = np.roll(img, (-dy, -dx), axis=(0, 1))
        if dy > 0:
            out[-dy:] = 0
        elif dy < 0:
            out[:-dy] = 0
        if dx > 0:
            out[:, -dx:] = 0
        elif dx < 0:
            out[:, :-dx] = 0
        return out

    def read_volume(self, dark: float = 0.0,
                    apply_drift: bool = True) -> np.ndarray:
        vol = np.stack([self.read_plane(z, apply_drift)
                        for z in range(len(self.paths))])
        vol = vol.astype(np.float32)
        if dark > 0:
            vol = np.maximum(vol - dark, 0.0)
        return vol

    def estimate_drift(self, dark: float = 0.0, max_shift: int = 8) -> None:
        """Estimate the per-z linear creep from first-vs-last-plane NCC."""
        n = len(self.paths)
        if n < 2:
            return
        a = np.maximum(_imread(self.paths[0]).astype(np.float32) - dark, 0)
        b = np.maximum(_imread(self.paths[-1]).astype(np.float32) - dark, 0)
        m = ncc_map(a, b, max_shift, max_shift)
        u, v = np.unravel_index(np.argmax(m), m.shape)
        if m[u, v] <= 0.3:  # no reliable structure: keep zero drift
            return
        # ncc_map peak (u, v) means a[t+u] matches b[t], i.e. content crept
        # by -(u - max_shift) per full travel — negate for the creep rate
        self.drift_y = -(u - max_shift) / (n - 1)
        self.drift_x = -(v - max_shift) / (n - 1)


class Scanner:
    """3D grid of ScanStacks with pairwise alignment and weighted blending
    (reference Scanner, tsv/scan.py:161-1143)."""

    def __init__(self, stacks: Dict[Tuple[int, int, int], ScanStack],
                 dark: float = 0.0, slop: Tuple[int, int, int] = (10, 10, 5),
                 params: Optional[NCCParams] = None,
                 min_support: int = 5,
                 log: Optional[Logger] = None):
        self.stacks = dict(stacks)
        self.dark = dark
        self.slop = slop
        self.params = params or NCCParams(min_dim_ncc_src=8)
        self.min_support = min_support
        self.log = log or Logger()
        self.alignments: Dict[Tuple, Tuple[int, int, int]] = {}
        self.scores: Dict[Tuple, float] = {}
        self.drift = AverageDrift()
        # per-round LRU of decoded (drift-rolled, dark-subtracted) volumes:
        # each stack is read by up to 6 neighbor pairs per round — without
        # the cache the TIFF decode dominates wall-clock on real grids
        self._vol_cache: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()
        self.cache_volumes = 8

    def _read_cached(self, s: ScanStack) -> np.ndarray:
        # drift in the key: read_volume rolls planes by the per-stack
        # creep, so a drift re-estimate must invalidate the cached volume
        key = (id(s), s.drift_x, s.drift_y)
        vol = self._vol_cache.get(key)
        if vol is None:
            vol = s.read_volume(self.dark)
            self._vol_cache[key] = vol
            while len(self._vol_cache) > self.cache_volumes:
                self._vol_cache.popitem(last=False)
        else:
            self._vol_cache.move_to_end(key)
        return vol

    def _overlap(self, a: ScanStack, b: ScanStack, side: str) -> int:
        ea, eb = a.extent, b.extent
        if side == "we":
            return max(1, ea.x1 - eb.x0)
        if side == "ns":
            return max(1, ea.y1 - eb.y0)
        return max(1, ea.z1 - eb.z0)

    def _dark_support_ok(self, va: np.ndarray, vb: np.ndarray,
                         side: str, overlap: int) -> bool:
        """Dark-frame support check (reference align_plane_*:
        require >= sqrt(area) above-dark pixels in the overlap strips)."""
        if self.dark <= 0:
            return True
        if side == "we":
            sa, sb = va[:, :, -overlap:], vb[:, :, :overlap]
        elif side == "ns":
            sa, sb = va[:, -overlap:, :], vb[:, :overlap, :]
        else:
            sa, sb = va[-overlap:], vb[:overlap]
        need = np.sqrt(sa[0].size)
        # read_volume already subtracted dark, so "above dark" is > 0
        return (np.count_nonzero(sa > 0) / max(1, sa.shape[0]) >= need and
                np.count_nonzero(sb > 0) / max(1, sb.shape[0]) >= need)

    def _align_one(self, s0: ScanStack, s1: ScanStack, side: str,
                   recenter: Tuple[int, int, int],
                   slop: Tuple[int, int, int]):
        """One pair as a batched plane-sweep: sample target planes of s1 are
        scored against a z-window of s0 planes with all (dy, dx) shifts at
        once, and the best (z, peak) wins.

        This is the reference's align_one_x/y/z search structure
        (tsv/scan.py:841-1063: target plane vs src planes across a z range,
        full-plane correlation) driven through the batched all-shifts NCC
        map engine instead of nested Pearson loops.  Full-plane scoring is
        deliberate — the TeraStitcher MIP fusion (ops/ncc.align_pair)
        collapses the z axis into projections whose z-peak is unreliable on
        thin smooth structure, and its fuse_axis then silently falls back
        to the nominal z offset (observed: injected z jitter unrecovered on
        piezo grids); plane sweeps keep the full content per z candidate.
        """
        overlap = self._overlap(s0, s1, side)
        va = self._read_cached(s0)
        vb = self._read_cached(s1)
        if not self._dark_support_ok(va, vb, side, overlap):
            return None, 0.0
        dy, dx, dz = recenter
        sy, sx, sz = slop
        sy, sx, sz = sy + abs(dy), sx + abs(dx), sz + abs(dz)
        # bucket the strip width: stage landings jitter by a pixel or two,
        # so per-pair overlaps differ by +-1-2 px and every distinct width
        # would be its own XLA executable (same compile-poison rule as
        # _maps_bucketed).  Multiples of 4 collapse that jitter into one
        # shape while losing <=3 edge pixels; narrow strips (<=32 px) are
        # left exact — truncation there eats a meaningful fraction of the
        # seam signal (measured: a 24->16 cut flipped a clean 1.0-score
        # alignment to a wrong 0.56 one)
        if side != "tb" and overlap > 32:
            overlap = overlap - overlap % 4
        if side == "we":
            A, B = va[:, :, -overlap:], vb[:, :, :overlap]
        elif side == "ns":
            A, B = va[:, -overlap:, :], vb[:, :overlap, :]
        else:
            A, B = va, vb
        na, nb = A.shape[0], B.shape[0]
        nominal_dz = s1.z0 - s0.z0
        valid_t = [t for t in range(nb) if 0 <= t + nominal_dz < na]
        if not valid_t:
            return None, 0.0
        # reference z_skip="middle" samples one plane; quartiles add two
        # more cross-checks on deep stacks at negligible batch cost.  For
        # piezo z-pairs the valid window is only a few planes and the zi
        # clamp cuts the up-range, so sample its ends too (the reference's
        # align_stack_z uses exactly the first target plane)
        t_samples = {valid_t[len(valid_t) // 2]}
        if side == "tb":
            t_samples |= {valid_t[0], valid_t[-1]}
        elif len(valid_t) >= 8:
            t_samples |= {valid_t[len(valid_t) // 4],
                          valid_t[3 * len(valid_t) // 4]}
        cand = [(t, zi)
                for t in sorted(t_samples)
                for zi in range(t + nominal_dz - sz, t + nominal_dz + sz + 1)
                if 0 <= zi < na]
        # clamp the shift search to keep min_dim_ncc_src rows/cols in play
        # (align_pair's clamp, libcrossmips.cpp:260-262)
        p = self.params
        dv = min(sy, max(1, A.shape[1] - p.min_dim_ncc_src))
        dh = min(sx, max(1, A.shape[2] - p.min_dim_ncc_src))
        # decimation ladder (the reference starts at decimate=8,
        # tsv/stitch.py:157 / align_one:868-902): the z sweep scores
        # mean-pooled planes — the host->device batch shrinks by dec^2 —
        # and only the winning dz is re-scored at full resolution
        dec = 1
        while (dec < 8
               and min(A.shape[1], A.shape[2]) // (2 * dec) >= 4 * p.min_dim_ncc_src):
            dec *= 2
        if dec > 1 and len(cand) > len(t_samples):
            dz_best = self._coarse_dz(A, B, cand, dec, dv, dh)
            cand = [(t, zi) for t, zi in cand if zi - t == dz_best]
        batch_a = np.ascontiguousarray(
            np.stack([A[zi] for _, zi in cand]), np.float32)
        batch_b = np.ascontiguousarray(
            np.stack([B[t] for t, _ in cand]), np.float32)
        wr_v, wr_h = p.w_range(dv), p.w_range(dh)
        maps = self._maps_bucketed(batch_a, batch_b, dv + wr_v, dh + wr_h)
        best = None
        for i, (t, zi) in enumerate(cand):
            pv, ph, pk, _, _ = peak_and_widths(maps[i], dv, dh, wr_v, wr_h, p)
            if best is None or pk > best[0]:
                best = (pk, pv, ph, zi - t)
        pk, cv, ch, cd = best
        if side == "we":
            ch += va.shape[2] - overlap
        elif side == "ns":
            cv += va.shape[1] - overlap
        return (int(cv), int(ch), int(cd)), float(max(pk, 0.0))

    @staticmethod
    def _maps_bucketed(batch_a: np.ndarray, batch_b: np.ndarray,
                       du: int, dv: int) -> np.ndarray:
        """ncc_maps_batched with the batch size and search window rounded
        up to buckets, then cropped back.

        Every distinct (B, du, dv) compiles a fresh XLA executable; the
        candidate count and the drift-widened slops vary per pair and per
        round, which means many compiles for a real grid.  Rounding B to the next power of two (padding with
        repeats) and the delays to multiples of 4 makes the handful of
        shapes recur, so the persistent cache serves every later pair."""
        du_p = -(-max(du, 1) // 4) * 4
        dv_p = -(-max(dv, 1) // 4) * 4
        B = batch_a.shape[0]
        B_p = 1 << (B - 1).bit_length()
        if B_p > B:
            pad = np.broadcast_to(batch_a[:1], (B_p - B,) + batch_a.shape[1:])
            batch_a = np.concatenate([batch_a, pad])
            batch_b = np.concatenate(
                [batch_b, np.broadcast_to(batch_b[:1],
                                          (B_p - B,) + batch_b.shape[1:])])
        maps = np.asarray(ncc_maps_batched(
            jnp.asarray(batch_a), jnp.asarray(batch_b), du_p, dv_p),
            np.float64)
        return maps[:B, du_p - du:du_p + du + 1, dv_p - dv:dv_p + dv + 1]

    @staticmethod
    def _coarse_dz(A: np.ndarray, B: np.ndarray, cand, dec: int,
                   dv: int, dh: int) -> int:
        """Pick the best z offset from mean-pooled planes (the decimated
        first rung of the ladder; z itself is never decimated)."""
        def pool(img):
            h = img.shape[0] // dec * dec
            w = img.shape[1] // dec * dec
            return img[:h, :w].reshape(
                h // dec, dec, w // dec, dec).mean(axis=(1, 3))

        pa = {zi: None for _, zi in cand}
        pb = {t: None for t, _ in cand}
        for zi in pa:
            pa[zi] = pool(np.asarray(A[zi], np.float32))
        for t in pb:
            pb[t] = pool(np.asarray(B[t], np.float32))
        batch_a = np.stack([pa[zi] for _, zi in cand])
        batch_b = np.stack([pb[t] for t, _ in cand])
        du = max(1, -(-dv // dec)) + 1
        dw = max(1, -(-dh // dec)) + 1
        maps = Scanner._maps_bucketed(batch_a, batch_b, du, dw)
        peaks = maps.reshape(maps.shape[0], -1).max(axis=1)
        # best peak per dz (several t samples can share a dz)
        by_dz = {}
        for (t, zi), pk in zip(cand, peaks):
            d = zi - t
            if d not in by_dz or pk > by_dz[d]:
                by_dz[d] = pk
        return max(by_dz, key=by_dz.get)

    def align_all_stacks(self, rounds: int = 2) -> None:
        """Pairwise NCC alignment of every adjacent pair along x, y, z with
        drift-recentered rounds (reference align_all_stacks
        tsv/scan.py:327-460 + calculate_next_round_parameters:501-528)."""
        keys = set(self.stacks)
        neighbors = {"we": (1, 0, 0), "ns": (0, 1, 0), "tb": (0, 0, 1)}
        for rnd in range(max(1, rounds)):
            per_side: Dict[str, List[Tuple[int, int, int]]] = {
                "we": [], "ns": [], "tb": []}
            slop = tuple(max(2, s >> rnd) for s in self.slop)
            for (xi, yi, zi), s0 in sorted(self.stacks.items()):
                for side, (dx, dy, dz) in neighbors.items():
                    k1 = (xi + dx, yi + dy, zi + dz)
                    if k1 not in keys:
                        continue
                    s1 = self.stacks[k1]
                    coord, score = self._align_one(
                        s0, s1, side, self.drift.for_side(side), slop)
                    if coord is None:
                        self.log.info(
                            f"scan align {side} {(xi, yi, zi)}->{k1}: "
                            "insufficient above-dark support, skipped")
                        continue
                    self.alignments[((xi, yi, zi), k1)] = coord
                    self.scores[((xi, yi, zi), k1)] = score
                    # offsets relative to nominal positions feed the drift
                    cv, ch, cd = coord
                    per_side[side].append((
                        ch - (s1.x0 - s0.x0), cv - (s1.y0 - s0.y0),
                        cd - (s1.z0 - s0.z0)))
                    self.log.info(
                        f"scan align {side} {(xi, yi, zi)}->{k1}: "
                        f"coord={coord} score={score:.3f}")
            self.drift = self._estimate_drift(per_side)
            if rounds > 1 and rnd == 0:
                self.log.info(f"round {rnd} drift: {self.drift}")

    def _estimate_drift(self, per_side) -> AverageDrift:
        """Median per-direction offsets with outlier rejection
        (reference accumulate_offsets, tsv/scan.py:479-499 — ungated:
        min_support gates only the composite fill-in of MISSING links,
        see _composite_edges)."""
        def med(side, axis):
            if not per_side[side]:
                return 0
            return int(round(_median_without_outliers(
                [t[axis] for t in per_side[side]])))

        return AverageDrift(
            xoffx=med("we", 0), yoffx=med("we", 1), zoffx=med("we", 2),
            xoffy=med("ns", 0), yoffy=med("ns", 1), zoffy=med("ns", 2),
            xoffz=med("tb", 0), yoffz=med("tb", 1), zoffz=med("tb", 2))

    def estimate_stack_drifts(self) -> None:
        """Per-stack linear x/y creep (reference x_off_per_z/y_off_per_z)."""
        for s in self.stacks.values():
            s.estimate_drift(self.dark)

    def apply_alignments(self) -> None:
        """Solve for absolute stack positions as a score-weighted
        least-squares problem per axis (the place_tiles_lqp relaxation —
        reconciles loop-inconsistent links that the reference's median
        chains, flat_adjust_stacks:724-818, average away), then rebase.

        With no surviving links every stack keeps its nominal stage
        position, but the grid is STILL rebased to origin 0 — dragonfly
        stage coordinates are absolute (tens of thousands of pixels) and
        skipping the rebase would make downstream canvases allocate the
        whole stage extent."""
        if not self.alignments:
            self._rebase()
            return
        from scipy.sparse import lil_matrix
        from scipy.sparse.linalg import lsqr

        nodes = sorted(self.stacks)
        idx = {k: i for i, k in enumerate(nodes)}
        n = len(nodes)
        pos = np.zeros((n, 3))
        # edge list: (i, j, (dx, dy, dz), w)
        edges = []
        for (k0, k1), (cv, ch, cd) in self.alignments.items():
            w = max(self.scores.get((k0, k1), 0.1), 1e-3)
            edges.append((idx[k0], idx[k1], (ch, cv, cd), w))
        edges += self._composite_edges(idx)
        for axis in range(3):
            # edge rows + a weak per-stack prior toward the nominal stage
            # position: a stack with NO surviving links (dark-overlap
            # pairs are skipped) must stay at its stage coordinate rather
            # than collapse to lsqr's minimum-norm 0, and the prior also
            # fixes the solution's gauge
            A = lil_matrix((len(edges) + n, n))
            b = np.zeros(len(edges) + n)
            for i, (u, v, d, w) in enumerate(edges):
                sw = np.sqrt(w)
                A[i, v] = sw
                A[i, u] = -sw
                b[i] = sw * d[axis]
            # anchor node 0 firmly (weight 10: strong vs edge weights ~1
            # but small enough that lsqr's normal equations stay well
            # conditioned — the old 1000 anchor next to 1e-3 priors left
            # the weak rows unconverged) and give every other node a weak
            # prior so corrections flow away from the anchor instead of
            # splitting symmetrically (integer rounding would cancel a
            # +-0.5 split)
            for i, k in enumerate(nodes):
                nominal = (self.stacks[k].x0, self.stacks[k].y0,
                           self.stacks[k].z0)[axis]
                w_i = 10.0 if i == 0 else 0.01
                A[len(edges) + i, i] = w_i
                b[len(edges) + i] = w_i * nominal
            pos[:, axis] = lsqr(A.tocsr(), b, atol=1e-10, btol=1e-10,
                                iter_lim=10 * (n + len(edges)))[0]
        pos = np.rint(pos).astype(np.int64)
        for k, i in idx.items():
            s = self.stacks[k]
            s.x0, s.y0, s.z0 = int(pos[i, 0]), int(pos[i, 1]), int(pos[i, 2])
        self._rebase()

    _SIDES = {"we": (1, 0, 0), "ns": (0, 1, 0), "tb": (0, 0, 1)}

    def _composite_edges(self, idx) -> list:
        """Median fill-in for adjacent pairs with NO surviving link — the
        reference's composite-alignment fallback gated by min_support
        (flat_adjust_stacks, tsv/scan.py:748,760: a pair lacking a direct
        above-threshold link gets its peers' median offset, but only when
        at least min_support peers support the guess; otherwise the
        nominal offset stands).  Here the guesses enter the LS solve as
        low-weight edges (0.05, well below real link scores ~0.75+), so
        a real link always dominates and a loop-inconsistent guess is
        reconciled rather than chained."""
        by_side: Dict[str, List[Tuple[int, int, int]]] = {
            s: [] for s in self._SIDES}
        for (k0, k1), (cv, ch, cd) in self.alignments.items():
            delta = tuple(b - a for a, b in zip(k0, k1))
            for side, d in self._SIDES.items():
                if delta == d:
                    s0, s1 = self.stacks[k0], self.stacks[k1]
                    by_side[side].append((ch - (s1.x0 - s0.x0),
                                          cv - (s1.y0 - s0.y0),
                                          cd - (s1.z0 - s0.z0)))
        med = {side: tuple(int(round(np.median([v[a] for v in vals])))
                           for a in range(3))
               for side, vals in by_side.items()
               if len(vals) >= self.min_support}
        out = []
        for k0 in self.stacks:
            for side, d in self._SIDES.items():
                if side not in med:
                    continue
                k1 = tuple(a + b for a, b in zip(k0, d))
                if k1 not in self.stacks or (k0, k1) in self.alignments:
                    continue
                s0, s1 = self.stacks[k0], self.stacks[k1]
                mx, my, mz = med[side]
                out.append((idx[k0], idx[k1],
                            (s1.x0 - s0.x0 + mx, s1.y0 - s0.y0 + my,
                             s1.z0 - s0.z0 + mz), 0.05))
        if out:
            self.log.info(f"composite fill-in: {len(out)} unlinked "
                          f"adjacent pairs given per-side median offsets")
        return out

    def _rebase(self) -> None:
        """Shift all stack positions so the grid minimum sits at 0."""
        mx = min(s.x0 for s in self.stacks.values())
        my = min(s.y0 for s in self.stacks.values())
        mz = min(s.z0 for s in self.stacks.values())
        for s in self.stacks.values():
            s.x0 -= mx
            s.y0 -= my
            s.z0 -= mz

    @property
    def volume(self) -> VExtent:
        exts = [s.extent for s in self.stacks.values()]
        return VExtent(min(e.x0 for e in exts), max(e.x1 for e in exts),
                       min(e.y0 for e in exts), max(e.y1 for e in exts),
                       min(e.z0 for e in exts), max(e.z1 for e in exts))

    def imread(self, volume: VExtent, dtype=np.uint16) -> np.ndarray:
        """Distance-to-edge weighted blend of all intersecting stacks
        (reference Scanner EDT blending; exact for box stacks)."""
        acc = np.zeros(volume.shape, np.float32)
        wacc = np.zeros(volume.shape, np.float32)
        for s in self.stacks.values():
            ext = s.extent
            if not ext.intersects(volume):
                continue
            inter = ext.intersection(volume)
            block = np.stack([
                s.read_plane(z - s.z0)[inter.y0 - s.y0:inter.y1 - s.y0,
                                       inter.x0 - s.x0:inter.x1 - s.x0]
                for z in range(inter.z0, inter.z1)]).astype(np.float32)
            # separable distance-to-edge weight (EDT of a box)
            w = np.ones(inter.shape, np.float32)
            for ax, (lo, hi, elo, ehi) in enumerate((
                    (inter.z0, inter.z1, ext.z0, ext.z1),
                    (inter.y0, inter.y1, ext.y0, ext.y1),
                    (inter.x0, inter.x1, ext.x0, ext.x1))):
                coords = np.arange(lo, hi)
                dist = np.minimum(coords - elo + 1, ehi - coords)
                shape = [1, 1, 1]
                shape[ax] = len(coords)
                w = w * dist.reshape(shape).astype(np.float32)
            sl = volume.local_slices(inter)
            acc[sl] += block * w
            wacc[sl] += w
        out = np.where(wacc > 0, acc / np.maximum(wacc, 1e-12), 0.0)
        if np.issubdtype(np.dtype(dtype), np.integer):
            info = np.iinfo(dtype)
            out = np.clip(np.rint(out), info.min, info.max)
        return out.astype(dtype)

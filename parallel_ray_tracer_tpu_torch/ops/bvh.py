"""Copy of parallel_ray_tracer_tpu/ops/bvh.py (numpy only).

Host-side BVH builder: 7 split heuristics, flat SoA output.

Re-implements the reference builder's semantics (cpu/src/bvh.c:78-388,
duplicated at gpu/src/bvh.cu:97-286) with NumPy:
  - preallocated 2*T node array, children always adjacent (child, child+1)
  - top-down recursive split; leaf when depth == max_depth or
    count <= leaf_threshold (cpu/src/bvh.c:84)
  - node is {aabb, count, a} where a = first-triangle offset for leaves
    (count > 0) or left-child index for inner nodes (cpu/include/bvh.h:14-23)
  - the shared tri_idx permutation array is partitioned in place so every
    node owns a contiguous range (cpu/src/bvh.c:244-259)

Heuristics (cpu/src/bvh.c:115-242):
  0 midpoint of axis 0             1 midpoint of largest axis
  2 midpoint of random axis        3 random position on random axis
  4 median on largest axis         5 median on best-(count*diag^2) axis
  6 binned SAH sweep (sah_bins bins per axis, or per-centroid brute force
    when sah_bins == -1)

Deliberate divergences from the reference (SURVEY.md "quirks"):
  - random axis is % 3, not the out-of-bounds % 4 (cpu/src/bvh.c:225,229)
  - heuristic 3's rejection loop is capped (the reference can spin forever
    when all centroids coincide); on exhaustion we fall back to a leaf
  - NumPy RandomState(seed) replaces C rand(); same determinism guarantee
    (fixed seed -> fixed tree), different sequence
  - "area" keeps the reference's squared-diagonal formula (cpu/src/bvh.c:43-46)
    for parity; a true surface-area mode is available via `true_sah=True`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class BVH:
    """Flat SoA BVH. Arrays sized n_nodes (trimmed)."""

    min_x: np.ndarray
    min_y: np.ndarray
    min_z: np.ndarray
    max_x: np.ndarray
    max_y: np.ndarray
    max_z: np.ndarray
    count: np.ndarray     # i32; > 0 => leaf with `count` triangles
    a: np.ndarray         # i32; leaf: first index into tri_perm; inner: left child
    tri_perm: np.ndarray  # (T,) i32 permutation; leaves own contiguous ranges
    stats: Dict[str, float]

    @property
    def n_nodes(self) -> int:
        return int(self.min_x.shape[0])

    def max_leaf_size(self) -> int:
        leaf = self.count > 0
        return int(self.count[leaf].max()) if leaf.any() else 0

    def depth(self) -> int:
        """Tree depth by walk (root = depth 0)."""
        depths = {0: 0}
        best = 0
        stack = [0]
        while stack:
            i = stack.pop()
            d = depths[i]
            best = max(best, d)
            if self.count[i] == 0 and self.a[i] != 0:
                c = int(self.a[i])
                depths[c] = depths[c + 1] = d + 1
                stack.extend((c, c + 1))
        return best

    def metrics_banner(self) -> str:
        """The reference's BVH_METRICS printout (cpu/src/bvh.c:381-387)."""
        s = self.stats
        return (
            f"min number of triangle: {int(s['min_leaf'])}\n"
            f"max number of triangle: {int(s['max_leaf'])}\n"
            f"avg number of triangle: {s['avg_leaf']:.2f}\n"
            f"number of leaf: {int(s['leaf_count'])}\n"
            f"bvh size (bytes): {int(s['bytes'])}"
        )


def triangle_bounds(tv: np.ndarray):
    """tv: (T, 3, 3) vertices -> (T,3) min, (T,3) max, (T,3) centroid."""
    bb_min = tv.min(axis=1)
    bb_max = tv.max(axis=1)
    centroid = tv.mean(axis=1)
    return bb_min, bb_max, centroid


def _area(lo: np.ndarray, hi: np.ndarray, true_sah: bool) -> float:
    """Reference 'area' = squared diagonal (cpu/src/bvh.c:43-46), or real
    surface area when true_sah."""
    size = hi - lo
    if true_sah:
        return float(
            2.0 * (size[0] * size[1] + size[1] * size[2] + size[2] * size[0])
        )
    return float(size @ size)


_H3_MAX_TRIES = 64


def build_bvh(
    tri_verts: np.ndarray,
    heuristic: int = 3,
    max_depth: int = 32,
    leaf_threshold: int = 2,
    sah_bins: int = 32,
    seed: int = 1,
    true_sah: bool = False,
) -> BVH:
    """Build from (T, 3, 3) triangle vertices."""
    T = tri_verts.shape[0]
    if T == 0:
        raise ValueError("no triangles, cannot build bvh")
    bb_min, bb_max, cent = triangle_bounds(tri_verts.astype(np.float32))
    rng = np.random.RandomState(None if seed == 0 else seed)

    n_cap = 2 * T
    node_min = np.full((n_cap, 3), 1e10, np.float32)
    node_max = np.full((n_cap, 3), -1e10, np.float32)
    count = np.zeros(n_cap, np.int32)
    a = np.zeros(n_cap, np.int32)
    perm = np.arange(T, dtype=np.int32)

    node_min[0] = bb_min.min(axis=0)
    node_max[0] = bb_max.max(axis=0)
    count[0] = T
    a[0] = 0

    n_nodes = 1
    leaf_sizes = []

    def grown_bounds(idx: np.ndarray):
        return (
            bb_min[idx].min(axis=0).astype(np.float32),
            bb_max[idx].max(axis=0).astype(np.float32),
        )

    # Iterative DFS matching the recursive order (left before right).
    stack = [(0, 0)]
    while stack:
        node, depth = stack.pop()
        first, n = int(a[node]), int(count[node])

        if n_nodes >= n_cap or depth == max_depth or n <= leaf_threshold:
            leaf_sizes.append(n)
            continue

        idx = perm[first : first + n]
        c = cent[idx]

        split_axis = 0
        split_pos = 0.0
        median_split = False
        make_leaf = False

        if heuristic in (0, 1, 2, 3):
            center = (node_min[node] + node_max[node]) * 0.5
            size = node_max[node] - node_min[node]
            if heuristic == 0:
                split_axis, split_pos = 0, float(center[0])
            elif heuristic == 1:
                split_axis = _largest_axis(size)
                split_pos = float(center[split_axis])
            elif heuristic == 2:
                split_axis = int(rng.randint(3))
                split_pos = float(center[split_axis])
            else:  # 3: random pos on random axis; both sides must be non-empty
                ok = False
                for _ in range(_H3_MAX_TRIES):
                    split_axis = int(rng.randint(3))
                    split_pos = float(center[split_axis]) + (
                        float(rng.random_sample()) - 0.5
                    ) * float(size[split_axis])
                    in_a = c[:, split_axis] < split_pos
                    if in_a.any() and not in_a.all():
                        ok = True
                        break
                if not ok:
                    make_leaf = True
        elif heuristic == 4:
            size = node_max[node] - node_min[node]
            split_axis = _largest_axis(size)
            median_split = True
        elif heuristic == 5:
            best_score = np.inf
            half = n // 2
            for axis in range(3):
                order = np.argsort(c[:, axis], kind="stable")
                lo_i, hi_i = idx[order[:half]], idx[order[half:]]
                score = half * _area(*grown_bounds(lo_i), true_sah) + (
                    n - half
                ) * _area(*grown_bounds(hi_i), true_sah)
                if score < best_score:
                    best_score = score
                    split_axis = axis
            median_split = True
        elif heuristic == 6:
            best_score = np.inf
            found = False
            for axis in range(3):
                ca = c[:, axis]
                if sah_bins == -1:
                    candidates = ca
                else:
                    lo = node_min[node][axis]
                    sz = node_max[node][axis] - lo
                    candidates = lo + sz * (
                        np.arange(sah_bins, dtype=np.float32) / sah_bins
                    )
                # Vectorized sweep: running AABBs via sort + cumulative min/max.
                order = np.argsort(ca, kind="stable")
                smin = bb_min[idx[order]]
                smax = bb_max[idx[order]]
                sc = ca[order]
                pre_min = np.minimum.accumulate(smin, axis=0)
                pre_max = np.maximum.accumulate(smax, axis=0)
                suf_min = np.minimum.accumulate(smin[::-1], axis=0)[::-1]
                suf_max = np.maximum.accumulate(smax[::-1], axis=0)[::-1]
                # For split s: left = {c < s} = sc[:k] with k = searchsorted.
                k = np.searchsorted(sc, candidates, side="left")
                valid = (k > 0) & (k < n)
                if not valid.any():
                    continue
                kv = k[valid]
                dl = pre_max[kv - 1] - pre_min[kv - 1]
                dr = suf_max[kv] - suf_min[kv]
                if true_sah:
                    area_l = 2 * (
                        dl[:, 0] * dl[:, 1] + dl[:, 1] * dl[:, 2] + dl[:, 2] * dl[:, 0]
                    )
                    area_r = 2 * (
                        dr[:, 0] * dr[:, 1] + dr[:, 1] * dr[:, 2] + dr[:, 2] * dr[:, 0]
                    )
                else:
                    area_l = (dl * dl).sum(axis=1)
                    area_r = (dr * dr).sum(axis=1)
                scores = kv * area_l + (n - kv) * area_r
                j = int(np.argmin(scores))
                if scores[j] < best_score:
                    best_score = float(scores[j])
                    split_axis = axis
                    split_pos = float(candidates[valid][j])
                    found = True
            if not found:
                make_leaf = True
        else:
            raise ValueError(f"unknown heuristic {heuristic}")

        if make_leaf:
            leaf_sizes.append(n)
            continue

        if median_split:
            order = np.argsort(c[:, split_axis], kind="stable")
            half = n // 2
            left_sel = np.zeros(n, bool)
            left_sel[order[:half]] = True
        else:
            left_sel = c[:, split_axis] < split_pos

        nl = int(left_sel.sum())
        # Capacity guard for EVERY allocation, not just failed splits: dead
        # node pairs from failed splits (re-split one level deeper,
        # cpu/src/bvh.c:85-86) can exhaust the reference's preallocated 2N
        # budget (cpu/src/bvh.c:370 — a latent overflow there); we degrade
        # to a leaf instead of writing out of bounds.
        if n_nodes + 2 > n_cap:
            leaf_sizes.append(n)
            continue

        child = n_nodes
        n_nodes += 2

        left_idx = idx[left_sel]
        right_idx = idx[~left_sel]
        perm[first : first + nl] = left_idx
        perm[first + nl : first + n] = right_idx

        # An empty child keeps the inverted init AABB (never intersected) and
        # a=0, matching the reference's `parent->child = 0` empty-leaf
        # bookkeeping (cpu/src/bvh.c:85-86) so traversal can treat a==0 &&
        # count==0 as "dead node".
        if nl > 0:
            lo, hi = grown_bounds(left_idx)
            node_min[child], node_max[child] = lo, hi
        count[child] = nl
        a[child] = first if nl > 0 else 0
        if n - nl > 0:
            lo, hi = grown_bounds(right_idx)
            node_min[child + 1], node_max[child + 1] = lo, hi
        count[child + 1] = n - nl
        a[child + 1] = first + nl if n - nl > 0 else 0

        count[node] = 0
        a[node] = child

        # Push right then left so left pops first (reference recursion order).
        stack.append((child + 1, depth + 1))
        stack.append((child, depth + 1))

    leaf_sizes = np.asarray(leaf_sizes, np.int64) if leaf_sizes else np.zeros(1, np.int64)
    stats = {
        "min_leaf": float(leaf_sizes.min()),
        "max_leaf": float(leaf_sizes.max()),
        "avg_leaf": float(leaf_sizes.mean()),
        "leaf_count": float(len(leaf_sizes)),
        # reference bvh_t is 32 bytes (aabb 24 + tr_len 4 + union 4)
        "bytes": float(32 * n_nodes),
        "n_nodes": float(n_nodes),
    }

    return BVH(
        min_x=node_min[:n_nodes, 0].copy(),
        min_y=node_min[:n_nodes, 1].copy(),
        min_z=node_min[:n_nodes, 2].copy(),
        max_x=node_max[:n_nodes, 0].copy(),
        max_y=node_max[:n_nodes, 1].copy(),
        max_z=node_max[:n_nodes, 2].copy(),
        count=count[:n_nodes].copy(),
        a=a[:n_nodes].copy(),
        tri_perm=perm,
        stats=stats,
    )


def _largest_axis(size: np.ndarray) -> int:
    """Reference tie-break order (cpu/src/bvh.c:218-222): axis 0 unless
    y strictly larger than x; z only if strictly larger than both."""
    axis = 0
    if size[1] > size[0]:
        axis = 1
    if size[2] > size[0] and size[2] > size[1]:
        axis = 2
    return axis

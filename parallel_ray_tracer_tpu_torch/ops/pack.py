"""Port of the host half of parallel_ray_tracer_tpu/ops/pallas_trace.py: the
numpy packers that turn a FlatBVH into the tables the kernels read.

Copied from pallas_trace.py (pack_bvh's triangle rows :160-224, pack_bvh4
:267-349, pack_attr :2397, pack_lights :2971, required_stack_depth :61)
without the MXU leaf matrices (`cmat`) and the bf16 box formats, which the
port does not take yet. Same inputs give bit-identical tables.

  - ``cbox`` (Nq+1, 32) f32: quad node rows, child k's [min.xyz, max.xyz] at
    lanes [6k, 6k+6); absent children and the last (NULL) row are NaN boxes.
  - ``cmeta`` (Nq+1, 8) i32: 4 child encodings (enc < 0: leaf group -enc-1,
    enc >= 0: quad row) then 4 validity flags.
  - ``tri`` (G+1, 128) f32: leaf groups of L triangles, 12 floats each
    [v0, e1, e2, n]; pad slots and the last (NULL) row are zero.
  - ``attr`` (G+1, 128) f32: triangle j's [kd, ks, kr] at lanes [9j, 9j+9).
  - ``lamb`` (nl+1, 8) f32: rows (light_pos.xyz, light_kl.rgb, 0, 0), then
    the ambient colour.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bvh_flat import FlatBVH

T_MAX = 3.4028234663852886e38        # FLT_MAX, the miss sentinel
LANES = 128
TRI_STRIDE = 12                      # floats per triangle in a group row
ATTR_STRIDE = 9                      # kd(3), ks(3), kr(3) per triangle
STACK_DEPTH = 96


def required_stack_depth(tree_depth: int, arity: int, npop: int = 2) -> int:
    """The JAX kernels' SMEM stack words (a copy; the 96-word floor is their
    SMEM sizing). The CUDA kernels size their per-thread stack with
    `stack_need` instead."""
    lv = {2: 1, 4: 2, 8: 3}[arity]
    packed_depth = max(1, -(-int(tree_depth) // lv))
    if npop > 2:
        return max(
            STACK_DEPTH, npop * (arity - 1) * (packed_depth + 2) + npop + 2
        )
    return max(STACK_DEPTH, (arity - 1) * packed_depth + 2)


def stack_need(cmeta: np.ndarray) -> int:
    """Stack entries one ray needs to traverse this BVH4 table.

    A visit pops one entry and pushes at most 4, so the stack grows by at
    most 3 for each quad row on the deepest root-to-leaf path:
    3 * rows + 2, the per-ray form of `required_stack_depth`'s
    (arity - 1) * packed_depth + 2."""
    cmeta = np.asarray(cmeta)
    rows, frontier = 0, np.zeros(1, np.int64)
    while frontier.size:
        rows += 1
        enc = cmeta[frontier, :4]
        valid = cmeta[frontier, 4:8] > 0
        frontier = enc[valid & (enc >= 0)].astype(np.int64)
    return 3 * rows + 2


@dataclasses.dataclass
class PackedBVH4:
    """Host-side BVH4 tables ready for upload."""

    cbox: np.ndarray    # (Nq+1, 32) f32
    cmeta: np.ndarray   # (Nq+1, 8) i32
    tri: np.ndarray     # (G+1, 128) f32


def pack_tri_rows(flat: FlatBVH, tri_verts: np.ndarray) -> np.ndarray:
    """(G+1, 128) triangle group rows (pallas_trace.pack_bvh :201-218).

    Slot s = g*L + j lives at lanes [12j, 12j+12) of row g; pad slots
    (slot_map == -1) and the trailing NULL row stay zero (n == 0, never
    hit)."""
    L = flat.leaf_size
    if L * TRI_STRIDE > LANES:
        raise ValueError(f"leaf_size {L} needs {L*TRI_STRIDE} lanes > {LANES}")
    tv = np.asarray(tri_verts, np.float32)
    G = flat.n_slots // L
    sm = flat.slot_map
    safe = np.maximum(sm, 0)
    v0 = tv[safe, 0]
    e1 = tv[safe, 1] - v0
    e2 = tv[safe, 2] - v0
    n = np.cross(e1, e2)
    data = np.concatenate([v0, e1, e2, n], axis=1).astype(np.float32)
    data[sm < 0] = 0.0
    tri = np.zeros((G + 1, LANES), np.float32)
    tri[:G, : TRI_STRIDE * L] = data.reshape(G, L * TRI_STRIDE)
    return tri


def pack_bvh4(flat: FlatBVH, tri_verts: np.ndarray) -> PackedBVH4:
    """Pack a binary FlatBVH as a 4-wide node table (pallas_trace.pack_bvh4):
    each quad row holds its four grandchildren boxes (binary levels
    collapsed in pairs)."""
    L = flat.leaf_size
    count, a = flat.count, flat.a
    nmn, nmx = flat.node_min, flat.node_max
    tri = pack_tri_rows(flat, tri_verts)

    def leaf_enc(i):
        return -(int(a[i]) // L) - 1

    entries_of = {}
    if count[0] > 0:
        order = [None]  # synthetic root
        entries_of[None] = [("leaf", 0)]
    else:
        qid = {0: 0}
        order = [0]
        queue = [0]
        while queue:
            i = queue.pop()
            entries = []
            for ch in (int(a[i]), int(a[i]) + 1):
                if count[ch] > 0:
                    entries.append(("leaf", ch))
                else:
                    for gc in (int(a[ch]), int(a[ch]) + 1):
                        if count[gc] > 0:
                            entries.append(("leaf", gc))
                        else:
                            entries.append(("inner", gc))
                            if gc not in qid:
                                qid[gc] = len(qid)
                                order.append(gc)
                                queue.append(gc)
            entries_of[i] = entries

    Nq = len(order)
    qbox = np.full((Nq + 1, 32), np.nan, np.float32)
    qmeta = np.zeros((Nq + 1, 8), np.int32)
    for row, i in enumerate(order):
        for k, (kind, j) in enumerate(entries_of[i]):
            qbox[row, 6 * k : 6 * k + 3] = nmn[j]
            qbox[row, 6 * k + 3 : 6 * k + 6] = nmx[j]
            qmeta[row, 4 + k] = 1       # validity flag
            if kind == "leaf":
                qmeta[row, k] = leaf_enc(j)
            else:
                qmeta[row, k] = qid[j]
    return PackedBVH4(cbox=qbox, cmeta=qmeta, tri=tri)


def pack_attr(flat: FlatBVH, mat_idx, mats_kd, mats_ks, mats_kr) -> np.ndarray:
    """(G+1, 128) attribute rows: triangle j's [kd, ks, kr] at lanes
    [9j, 9j+9); pad slots and the NULL row stay zero."""
    L = flat.leaf_size
    sm = flat.slot_map
    G = flat.n_slots // L
    safe = np.maximum(sm, 0)
    mi = np.asarray(mat_idx, np.int32)[safe]
    kd = np.asarray(mats_kd, np.float32)[mi]
    ks = np.asarray(mats_ks, np.float32)[mi]
    kr = np.asarray(mats_kr, np.float32)[mi]
    data = np.concatenate([kd, ks, kr], axis=1)          # (S, 9)
    data[sm < 0] = 0.0
    attr = np.zeros((G + 1, LANES), np.float32)
    attr[:G, : ATTR_STRIDE * L] = data.reshape(G, L * ATTR_STRIDE)
    return attr


def pack_lights(lights_pos, lights_kl, ambient) -> np.ndarray:
    """(num_lights + 1, 8) f32 light/ambient table."""
    pos = np.asarray(lights_pos, np.float32).reshape(-1, 3)
    kl = np.asarray(lights_kl, np.float32).reshape(-1, 3)
    nl = pos.shape[0]
    out = np.zeros((nl + 1, 8), np.float32)
    out[:nl, 0:3] = pos
    out[:nl, 3:6] = kl
    out[nl, 0:3] = np.asarray(ambient, np.float32)
    return out

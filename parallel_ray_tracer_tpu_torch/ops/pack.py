"""Port of the host half of parallel_ray_tracer_tpu/ops/pallas_trace.py: the
numpy packers that turn a FlatBVH into the tables the kernels read.

Copied from pallas_trace.py (pack_bvh :160-224, _build_cmat :227-263,
pack_bvh4 :267-349, pack_bvh8 :352-417, pack_box_bf16_pairs :438-484,
cbox_to_bf16 :487-505, pack_cmi4 :1356, pack_attr :2397, pack_spheres
:2950, pack_lights :2971, required_stack_depth :61, _pad_stream_rows
:3023). Same inputs give bit-identical tables. `stream_decision` is the JAX
prepare's choice of leaf-row streaming (pipeline.py:350-368),
`mxu_decision` its choice of the MXU leaf (pipeline.py:407-433), and
`split_cmat` its upload of the C-matrix table (pipeline.py:442-446).

  - ``cbox`` f32 node rows, child k's [min.xyz, max.xyz] at lanes [6k, 6k+6):
    (Ni, 16) binary, (Nq+1, 32) BVH4, (No+1, 64) BVH8. In the BVH4 and BVH8
    tables absent children and the last (NULL) row are NaN boxes. The
    binary table has no NULL row, and lanes 12-15 are zero.
  - bf16 node rows (``bf16=True``), rounded conservatively (min planes
    down, max planes up, so every box encloses its f32 box and culling
    stays exact):
      - BVH4 / BVH8: (min|max) pairs in f32 lanes (``compressed=True``):
        child k's coordinate c is lane 3k + c, its high 16 bits the bf16
        min and its low 16 bits the bf16 max; the row keeps its f32 width
        and lanes past 3 * arity are zero.
      - binary: the (Ni, 16) table as raw bf16 bits, returned as uint16
        (JAX's ml_dtypes bfloat16 array has the same bits).
  - ``cmeta`` i32: child encodings (enc < 0: leaf group -enc-1, enc >= 0:
    node row), then validity flags: (Ni, 8) binary with 2 encodings and no
    flags (cmeta[:, 2:] is zero: both children always exist), (Nq+1, 8)
    BVH4 with 4 + 4, (No+1, 16) BVH8 with 8 + 8.
  - ``tri`` (G+1, 128) f32: leaf groups of L triangles, 12 floats each
    [v0, e1, e2, n]; pad slots and the last (NULL) row are zero.
  - ``attr`` (G+1, 128) f32: triangle j's [kd, ks, kr] at lanes [9j, 9j+9).
  - ``cmat`` ((G+1)*4L, 16) f32: the MXU leaf's C-matrices (build_cmat),
    row 4L*g + L*q + j holding quantity q (det, t_num, u_num, v_num) of
    triangle j of group g as a row against the ray's features
    R = [d, o x d, o, 1, 0 x 6]; pad slots and the NULL group are zero.
    The kernels read it split into bf16 halves: ((G+1)*4L, 32) rows
    [hi(16) | lo(16)] (split_cmat), or four groups per 128-lane row
    (pack_cmi4). bf16 tables are numpy uint16 bits, the bits of JAX's
    ml_dtypes bfloat16 arrays.
  - ``lamb`` (nl+1, 8) f32: rows (light_pos.xyz, light_kl.rgb, 0, 0), then
    the ambient colour, packed in torch ops (a tensor, in the autograd graph
    of tensor inputs: models/device_scene.build_device_scene).
  - ``sph`` (S, 16) f32: rows (centre.xyz, r, kd.rgb, ks.rgb, kr.rgb, 0, 0,
    0), the material looked up at pack time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bvh_flat import FlatBVH

T_MAX = 3.4028234663852886e38        # FLT_MAX, the miss sentinel
LANES = 128
TRI_STRIDE = 12                      # floats per triangle in a group row
ATTR_STRIDE = 9                      # kd(3), ks(3), kr(3) per triangle
STACK_DEPTH = 96
# Node arity by cbox row width (pallas_trace.py:3068), and cmeta row width
# by arity.
ARITY_OF_WIDTH = {16: 2, 32: 4, 64: 8}
META_WIDTH = {2: 8, 4: 8, 8: 16}

# Leaf-row streaming, copied from pallas_trace.py:1909-1916 (the streamed
# kernels' ring: slots, pending leaves prefetched per step, leaf groups per
# block). The CUDA kernels keep only STREAM_BLK (RT_STREAM_BLK in
# csrc/trace.cuh), the padding of streamed tables: they prefetch nothing.
STREAM_RING = 2
STREAM_KPRE = 2
STREAM_BLK = 4
# JAX's auto-stream threshold on its row model (pallas_trace.py:96, measured
# on the TPU's VMEM): the port streams where JAX streams, so both packages
# take the same path. It is not a limit of the CUDA card.
RESIDENT_ROWS_CEILING_BYTES = 126 * 1024 * 1024
# JAX's MXU-leaf budgets (pipeline.py:27-37), measured for the TPU's VMEM:
# the padded C-matrix table (rows x 128 lanes x 2 bytes) plus the scene
# rows must fit MXU_VMEM_BUDGET for its prepare to take the MXU leaf; the
# second is its ceiling for the pack_cmi4 layout, which its prepare never
# selects. The port keeps both so that the two packages pick the same leaf
# test; neither is a limit of the CUDA card.
MXU_VMEM_BUDGET = 88 * 1024 * 1024
MXU_VMEM_BUDGET4 = 112 * 1024 * 1024
CMAT_K = 16                          # features per ray in the MXU leaf


def pad_stream_rows(a: np.ndarray) -> np.ndarray:
    """Pad a (G, 128) row table with zero rows to a multiple of STREAM_BLK
    rows (pallas_trace._pad_stream_rows :3023), so a block DMA of the JAX
    kernels never reaches past the table; the streamed CUDA kernels take the
    same tables. Padding rows are never addressed by a leaf."""
    extra = (-a.shape[0]) % STREAM_BLK
    return np.pad(a, ((0, extra), (0, 0))) if extra else a


def stream_decision(n_cbox: int, n_cmeta: int, n_tri: int, mode: str) -> bool:
    """Whether leaf rows stream, by the JAX prepare's rule
    (pipeline.py:350-368): "on" always, "off" never, "auto" when the row
    model 512 * (cbox rows + cmeta rows + 2 * tri rows), counted before
    padding, passes RESIDENT_ROWS_CEILING_BYTES."""
    resident = 512 * (int(n_cbox) + int(n_cmeta) + 2 * int(n_tri))
    return mode == "on" or (mode == "auto" and resident > RESIDENT_ROWS_CEILING_BYTES)


def mxu_decision(cfg, n_rows_cmat: int, scene_bytes: int, stream: bool,
                 leaf_size: int = 8) -> bool:
    """Whether the leaf test is the MXU leaf, by the JAX prepare's rule
    (pipeline.py:407-433): cfg.mxu_leaf, the dual-pop schedule, a node
    arity of 4 or 8, leaves of 4 or 8 triangles, leaf rows not streamed,
    and the padded C-matrix table (n_rows_cmat x 128 lanes x 2 bytes) plus
    the scene rows (cbox, cmeta, tri and attr bytes) within
    MXU_VMEM_BUDGET. The budget is the TPU's, kept so that both packages
    take the same leaf test; it is no limit of the CUDA card."""
    ok = (bool(cfg.mxu_leaf) and bool(cfg.dual_pop) and cfg.bvh_width >= 4
          and leaf_size in (4, 8) and not stream)
    return ok and int(n_rows_cmat) * 128 * 2 + int(scene_bytes) <= MXU_VMEM_BUDGET


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


def stack_need(cmeta: np.ndarray, arity: int) -> int:
    """Stack entries one ray needs to traverse this arity-`arity` table.

    A visit pops one entry and pushes at most `arity`, so the stack grows by
    at most arity - 1 for each node row on the deepest root-to-leaf path:
    (arity - 1) * rows + 2, the per-ray form of `required_stack_depth`'s
    (arity - 1) * packed_depth + 2. The binary table has no validity flags:
    both children of a row exist."""
    cmeta = np.asarray(cmeta)
    if cmeta.ndim != 2 or cmeta.shape[1] != META_WIDTH.get(arity):
        raise ValueError(f"cmeta {cmeta.shape} is no arity-{arity} table")
    rows, frontier = 0, np.zeros(1, np.int64)
    while frontier.size:
        rows += 1
        enc = cmeta[frontier, :arity]
        valid = (np.ones(enc.shape, bool) if arity == 2
                 else cmeta[frontier, arity:2 * arity] > 0)
        frontier = enc[valid & (enc >= 0)].astype(np.int64)
    return (arity - 1) * rows + 2


@dataclasses.dataclass
class PackedBVH:
    """Host-side node and triangle tables ready for upload."""

    cbox: np.ndarray    # (Ni, 16) / (Nq+1, 32) / (No+1, 64) f32, or bf16 (above)
    cmeta: np.ndarray   # (Ni, 8) / (Nq+1, 8) / (No+1, 16) i32
    tri: np.ndarray     # (G+1, 128) f32
    compressed: bool = False   # cbox holds bf16 (min|max) pairs (f32 view)
    cmat: "np.ndarray | None" = None   # ((G+1)*4L, 16) f32 MXU leaf C-matrices


def pack_leaf_rows(flat: FlatBVH, tri_verts: np.ndarray):
    """(tri, cmat): the (G+1, 128) triangle group rows and the MXU leaf's
    C-matrices of the same slots (build_cmat), as pallas_trace.pack_bvh
    :201-223 makes both.

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
    return tri, build_cmat(v0, e1, e2, n, sm, G, L)


def build_cmat(v0, e1, e2, n, sm, G: int, L: int) -> np.ndarray:
    """((G+1)*4L, 16) leaf C-matrices for the MXU leaf
    (pallas_trace._build_cmat :227-263).

    Möller-Trumbore's four quantities of a (ray, triangle) pair are linear
    in the ray's features R = [d(3), M = o x d(3), o(3), 1, 0 x 6]:

        det   = (-n) . d
        t_num = n . o - (v0 . n)
        u_num = e2 . M - (e2 x v0) . d
        v_num = (e1 x v0) . d - e1 . M

    so one (4L, 16) matrix per leaf group gives all of its tests as one
    product with R. Row 4L*g + L*q + j holds quantity q of triangle j;
    pad slots and the trailing NULL group are zero (det == 0: no hit).
    v0 . n is summed in f64, as in JAX."""
    c1 = np.cross(e1, v0)
    c2 = np.cross(e2, v0)
    S = v0.shape[0]
    C = np.zeros((4, S, CMAT_K), np.float32)
    C[0, :, 0:3] = -n
    C[1, :, 6:9] = n
    C[1, :, 9] = -np.sum(n.astype(np.float64) * v0, axis=1).astype(np.float32)
    C[2, :, 3:6] = e2
    C[2, :, 0:3] = -c2
    C[3, :, 3:6] = -e1
    C[3, :, 0:3] = c1
    C[:, sm < 0] = 0.0
    out = np.zeros(((G + 1) * 4 * L, CMAT_K), np.float32)
    out[: G * 4 * L] = np.ascontiguousarray(
        C.reshape(4, G, L, CMAT_K).transpose(1, 0, 2, 3)
    ).reshape(G * 4 * L, CMAT_K)
    return out


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits (uint16), rounded to nearest even, as JAX's and
    ml_dtypes' conversion rounds; a NaN stays a (quiet) NaN."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(x), np.uint16(0x7FC0), r)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    """bf16 bits (uint16) -> their f32 values, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def _split(cmat: np.ndarray):
    """(hi, lo) bf16 bits of an f32 table: hi = bf16(x), lo = bf16(x - hi)."""
    cmat = np.ascontiguousarray(cmat, np.float32)
    hi = bf16_bits(cmat)
    return hi, bf16_bits(cmat - bf16_value(hi))


def split_cmat(cmat: np.ndarray) -> np.ndarray:
    """The C-matrix table as the kernels read it: (rows, 32) bf16 bits, row
    [hi(16) | lo(16)] (the JAX prepare's upload, pipeline.py:442-446)."""
    hi, lo = _split(cmat)
    return np.concatenate([hi, lo], axis=1)


def pack_cmi4(cmat: np.ndarray, L: int = 8) -> np.ndarray:
    """The C-matrix table four groups per 128-lane row
    (pallas_trace.pack_cmi4 :1356): group 4b+j's [hi(16) | lo(16)] at lanes
    [32j, 32j+32) of block b's 4L rows; groups past the last are zero.
    Returns (ceil(groups/4)*4L, 128) bf16 bits."""
    GR = 4 * L
    cmat = np.ascontiguousarray(cmat, np.float32)
    rows = cmat.shape[0]
    if rows % GR:
        raise ValueError(f"cmat has {rows} rows, not a whole number of {GR}-row groups")
    G = rows // GR
    Gp = -(-G // 4) * 4
    hi, lo = _split(cmat)

    def blocks(a):
        a = a.reshape(G, GR, CMAT_K)
        if Gp != G:
            a = np.concatenate([a, np.zeros((Gp - G, GR, CMAT_K), a.dtype)], axis=0)
        return a.reshape(Gp // 4, 4, GR, CMAT_K).transpose(0, 2, 1, 3)

    out = np.zeros((Gp // 4, GR, 4, 2 * CMAT_K), np.uint16)
    out[:, :, :, :CMAT_K] = blocks(hi)
    out[:, :, :, CMAT_K:] = blocks(lo)
    return out.reshape(Gp // 4 * GR, 128)


def pack_bvh(flat: FlatBVH, tri_verts: np.ndarray, bf16: bool = False) -> PackedBVH:
    """Pack a binary FlatBVH as the binary node table (pallas_trace.pack_bvh):
    one row per inner node with its two children's boxes, inner nodes
    renumbered in flat order. bf16=True rounds the boxes to bf16 bits
    (cbox_to_bf16); the table stays uncompressed, as in JAX."""
    L = flat.leaf_size
    count, a = flat.count, flat.a
    inner_old = np.nonzero(count == 0)[0]
    if inner_old.size == 0:
        # The root itself is a leaf: one inner row with BOTH children
        # pointing at it. (An inverted box is no never-hit sentinel under
        # the ordered slab test, so the second child carries the real box
        # and the same encoding; testing the leaf twice is idempotent.)
        cbox = np.zeros((1, 16), np.float32)
        cbox[0, 0:3] = flat.node_min[0]
        cbox[0, 3:6] = flat.node_max[0]
        cbox[0, 6:9] = flat.node_min[0]
        cbox[0, 9:12] = flat.node_max[0]
        cmeta = np.zeros((1, 8), np.int32)
        cmeta[0, 0] = -(a[0] // L) - 1
        cmeta[0, 1] = cmeta[0, 0]
    else:
        remap = np.full(flat.n_nodes, -1, np.int64)
        remap[inner_old] = np.arange(inner_old.size)
        assert remap[0] == 0, "root must be the first inner node"
        Ni = inner_old.size
        cbox = np.zeros((Ni, 16), np.float32)
        cmeta = np.zeros((Ni, 8), np.int32)
        cl = a[inner_old]                 # left child of each inner (right = cl+1)
        cbox[:, 0:3] = flat.node_min[cl]
        cbox[:, 3:6] = flat.node_max[cl]
        cbox[:, 6:9] = flat.node_min[cl + 1]
        cbox[:, 9:12] = flat.node_max[cl + 1]
        for k in (0, 1):
            ch = cl + k
            is_leaf = count[ch] > 0
            cmeta[:, k] = np.where(is_leaf, -(a[ch] // L) - 1, remap[ch])
            assert (is_leaf | (remap[ch] >= 0)).all()
    if bf16:
        cbox = cbox_to_bf16(cbox)
    tri, cmat = pack_leaf_rows(flat, tri_verts)
    return PackedBVH(cbox=cbox, cmeta=cmeta, tri=tri, cmat=cmat)


def pack_bvh4(flat: FlatBVH, tri_verts: np.ndarray, bf16: bool = False) -> PackedBVH:
    """Pack a binary FlatBVH as a 4-wide node table (pallas_trace.pack_bvh4):
    each quad row holds its four grandchildren boxes (binary levels
    collapsed in pairs). bf16=True packs them as bf16 pairs
    (pack_box_bf16_pairs, compressed=True)."""
    L = flat.leaf_size
    count, a = flat.count, flat.a
    nmn, nmx = flat.node_min, flat.node_max
    tri, cmat = pack_leaf_rows(flat, tri_verts)

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
    if bf16:
        qbox = pack_box_bf16_pairs(qbox, 4)
    return PackedBVH(cbox=qbox, cmeta=qmeta, tri=tri, compressed=bf16, cmat=cmat)


def pack_bvh8(flat: FlatBVH, tri_verts: np.ndarray, bf16: bool = False) -> PackedBVH:
    """Pack a binary FlatBVH as an 8-wide node table (pallas_trace.pack_bvh8):
    three binary levels collapse into one row of up to 8 descendants.
    bf16=True packs them as bf16 pairs (compressed=True)."""
    L = flat.leaf_size
    count, a = flat.count, flat.a
    nmn, nmx = flat.node_min, flat.node_max
    tri, cmat = pack_leaf_rows(flat, tri_verts)

    def leaf_enc(i):
        return -(int(a[i]) // L) - 1

    def expand(i, depth):
        """Descendants of binary-inner i after collapsing `depth` levels."""
        out = []
        for ch in (int(a[i]), int(a[i]) + 1):
            if count[ch] > 0 or depth == 1:
                out.append(("leaf" if count[ch] > 0 else "inner", ch))
            else:
                out.extend(expand(ch, depth - 1))
        return out

    entries_of = {}
    if count[0] > 0:
        order = [None]
        entries_of[None] = [("leaf", 0)]
    else:
        oid = {0: 0}
        order = [0]
        queue = [0]
        while queue:
            i = queue.pop()
            entries = expand(i, 3)
            for kind, j in entries:
                if kind == "inner" and j not in oid:
                    oid[j] = len(oid)
                    order.append(j)
                    queue.append(j)
            entries_of[i] = entries

    No = len(order)
    obox = np.full((No + 1, 64), np.nan, np.float32)
    ometa = np.zeros((No + 1, 16), np.int32)
    for row, i in enumerate(order):
        for k, (kind, j) in enumerate(entries_of[i]):
            obox[row, 6 * k : 6 * k + 3] = nmn[j]
            obox[row, 6 * k + 3 : 6 * k + 6] = nmx[j]
            ometa[row, 8 + k] = 1
            ometa[row, k] = leaf_enc(j) if kind == "leaf" else oid[j]
    if bf16:
        obox = pack_box_bf16_pairs(obox, 8)
    return PackedBVH(cbox=obox, cmeta=ometa, tri=tri, compressed=bf16, cmat=cmat)


def _round_bits(box: np.ndarray):
    """(bits rounded toward zero, the same plus one bf16 ulp in magnitude,
    the rounded-toward-zero value) of f32 boxes: the candidates of
    conservative bf16 rounding."""
    box = np.ascontiguousarray(box, np.float32)
    trunc = box.view(np.uint32) & np.uint32(0xFFFF0000)
    return trunc, trunc + np.uint32(0x00010000), trunc.view(np.float32)


def pack_box_bf16_pairs(box: np.ndarray, arity: int) -> np.ndarray:
    """bf16-compress wide box rows into f32-viewed (min, max) pairs
    (pallas_trace.pack_box_bf16_pairs, the hbvh_t analog of the reference
    CUDA renderer): child k's coordinate c becomes the f32 lane 3k + c whose
    high 16 bits are the bf16 min rounded down and low 16 bits the bf16 max
    rounded up. The row width is kept; lanes past 3 * arity stay zero. NaN
    children (absent slots, the NULL row) stay NaN."""
    box = np.ascontiguousarray(box, np.float32)
    trunc, bump, f = _round_bits(box)
    out = np.zeros_like(box, np.uint32)
    for k in range(arity):
        for c in range(3):
            lo, hi = 6 * k + c, 6 * k + 3 + c
            mn, mx = box[:, lo], box[:, hi]
            mn_b = np.where(f[:, lo] > mn, bump[:, lo], trunc[:, lo])
            mx_b = np.where(f[:, hi] < mx, bump[:, hi], trunc[:, hi])
            assert ((mn_b & np.uint32(0xFFFF)) == 0).all()
            assert ((mx_b & np.uint32(0xFFFF)) == 0).all()
            # the widened bounds enclose the f32 box; NaN children are exempt
            # (a canonical f32 NaN truncates to a bf16 NaN)
            dead = np.isnan(mn) | np.isnan(mx)
            assert (dead | (mn_b.view(np.float32) <= mn)).all()
            assert (dead | (mx_b.view(np.float32) >= mx)).all()
            assert np.isnan(mn_b.view(np.float32)[dead]).all()
            out[:, 3 * k + c] = mn_b | (mx_b >> np.uint32(16))
    return out.view(np.float32)


def unpack_box_bf16_pairs(cbox: np.ndarray, arity: int):
    """(min, max) f32 arrays of shape (N, arity, 3) from a bf16-pair table,
    decoded as the kernels decode it: min = bits & 0xFFFF0000, max =
    bits << 16 (pallas_trace._load_node_row)."""
    bits = np.ascontiguousarray(cbox, np.float32).view(np.uint32)[:, :3 * arity]
    mn = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    mx = (bits << np.uint32(16)).view(np.float32)
    return mn.reshape(-1, arity, 3), mx.reshape(-1, arity, 3)


def cbox_to_bf16(cbox: np.ndarray) -> np.ndarray:
    """Conservative bf16 rounding of the binary table's box rows
    (pallas_trace.cbox_to_bf16): min planes down, max planes up. Returns
    the bf16 bits as uint16, the high half of the rounded f32, which is
    what JAX's conversion to ml_dtypes.bfloat16 gives for those values."""
    cbox = np.ascontiguousarray(cbox, np.float32)
    trunc, bump, f = _round_bits(cbox)
    out = trunc.copy()
    for c in (0, 1, 2, 6, 7, 8):          # min planes: round down
        out[:, c] = np.where(f[:, c] > cbox[:, c], bump[:, c], trunc[:, c])
    for c in (3, 4, 5, 9, 10, 11):        # max planes: round up
        out[:, c] = np.where(f[:, c] < cbox[:, c], bump[:, c], trunc[:, c])
    return (out >> np.uint32(16)).astype(np.uint16)


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


def pack_lights(lights_pos, lights_kl, ambient) -> torch.Tensor:
    """(num_lights + 1, 8) f32 light/ambient table, built with torch ops on
    the device of the first input that is a tensor (the CPU when none is),
    so that the table stays in the inputs' autograd graph; other inputs go
    through numpy f32 first."""
    ref = next((a for a in (lights_pos, lights_kl, ambient) if isinstance(a, torch.Tensor)),
               None)
    device = ref.device if ref is not None else "cpu"

    def rows3(a):
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a, np.float32)
        return torch.as_tensor(a, dtype=torch.float32, device=device).reshape(-1, 3)

    pos, kl, amb = rows3(lights_pos), rows3(lights_kl), rows3(ambient)
    nl = pos.shape[0]
    top = torch.cat([pos, kl, pos.new_zeros((nl, 2))], dim=1)
    return torch.cat([top, torch.cat([amb, amb.new_zeros((1, 5))], dim=1)], dim=0)


def pack_spheres(centers, radii, mats, mats_kd, mats_ks, mats_kr):
    """(S, 16) f32 sphere table for the frame kernel, or None when S == 0.

    Per row: (cx, cy, cz, r, kd.rgb, ks.rgb, kr.rgb, 0, 0, 0), the material
    coefficients resolved at pack time (sph_mat -> material tables), so the
    kernel needs no gathers."""
    r = np.asarray(radii, np.float32).reshape(-1)
    if r.shape[0] == 0:
        return None
    m = np.asarray(mats, np.int64).reshape(-1)
    out = np.zeros((r.shape[0], 16), np.float32)
    out[:, 0:3] = np.asarray(centers, np.float32).reshape(-1, 3)
    out[:, 3] = r
    for k, table in enumerate((mats_kd, mats_ks, mats_kr)):
        out[:, 4 + 3 * k:7 + 3 * k] = np.asarray(table, np.float32).reshape(-1, 3)[m]
    return out

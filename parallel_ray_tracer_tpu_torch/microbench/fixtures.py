"""Numpy copies of the microbench scripts' fixtures, from the same seeds.

Copied from scripts/microbench_mxu_leaf.py (`split_bf16` :88, `build_cmat`
:201, `build_rmat` :219, `rand_fixture` :229, the fixtures of
`accuracy_check` :241), scripts/microbench_overlap.py (`_rays` :56,
`_boxes` :65, `_cmat` :79, `_rmats` :86), scripts/microbench_bf16.py
(`_box_rows` :51, `_rand` :62), scripts/microbench_inner.py and
scripts/microbench_glue.py (`_rays` :47 / :78 and `_boxes` :56 / :87: the
overlap script's, same seeds and construction; inner's `meta_flat` :459,
the Lf table `cmi`, `rmat` :420-429; glue's `meta_s` :662),
scripts/microbench_cond.py (the (8, 128) tile of `_bench` :62),
scripts/microbench_tiled.py (`_rays` :72, `_boxes` :58: the overlap
script's again) and scripts/microbench_mxu_inner.py (`_tables` :55, its
`_rays` :102 the overlap script's). Same seeds give the same numbers:
f32 arrays bit for bit, and bf16 arrays as their uint16 bits (rounded to
nearest even, as JAX rounds).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from ..ops.pack import bf16_bits, bf16_value

# microbench_mxu_leaf.py: leaf groups resident in the table, triangles per
# group, the hit test's epsilon.
G = 512
L = 8
EPS = 1e-3
# microbench_overlap.py: node rows and leaf groups of its tables; the
# packet's (sublanes, lanes).
N_NODES = 4096
N_GROUPS = 512
PACKET = (8, 128)
# microbench_bf16.py: node rows of the slab probe.
BF16_NODES = 4096
# microbench_inner.py's Lf bodies: leaf groups of the C table.
LF_GROUPS = 512
# microbench_mxu_inner.py: node rows of its tables (small so the script's
# lane-padded W tables fit VMEM).
MXU_INNER_NODES = 512


def split_bf16(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo) bf16 bits of an f32 array: hi = bf16(x), lo = bf16(x - hi)."""
    x = np.ascontiguousarray(x, np.float32)
    hi = bf16_bits(x)
    return hi, bf16_bits(x - bf16_value(hi))


def build_cmat(v0, e1, e2) -> np.ndarray:
    """(4T, 16) C rows per triangle j: det (row j), t_num (8 + j), u_num
    (16 + j), v_num (24 + j) against R = [d, o x d, o, 1, 0 x 6]; v0 . n
    summed in f32, as the script sums it."""
    n = np.cross(e1, e2)
    c2 = np.cross(e2, v0)
    c1 = np.cross(e1, v0)
    T = v0.shape[0]
    C = np.zeros((4, T, 16), np.float32)
    C[0, :, 0:3] = -n
    C[1, :, 6:9] = n
    C[1, :, 9] = -np.sum(n * v0, axis=1)
    C[2, :, 3:6] = e2
    C[2, :, 0:3] = -c2
    C[3, :, 3:6] = -e1
    C[3, :, 0:3] = c1
    return np.concatenate([C[q] for q in range(4)], axis=0)


def build_rmat(o: np.ndarray, d: np.ndarray) -> np.ndarray:
    """(16, n) feature rows R = [d, o x d, o, 1, 0 x 6] of (n, 3) rays."""
    M = np.cross(o, d)
    R = np.zeros((16, o.shape[0]), np.float32)
    R[0:3] = d.T
    R[3:6] = M.T
    R[6:9] = o.T
    R[9] = 1.0
    return R


class RandFixture(NamedTuple):
    planes: List[np.ndarray]   # ox, oy, oz, dx, dy, dz: (8, 128) f32 each
    tri: np.ndarray            # (G, 128) f32
    rmat: np.ndarray           # (16, 1024) f32
    cmat: np.ndarray           # (G * 32, 16) f32


def rand_fixture(seed: int = 0) -> RandFixture:
    """The timing fixture of microbench_mxu_leaf.py: uniform(-1, 1) ray
    planes, tri rows, R and C tables, drawn in the script's order."""
    rng = np.random.RandomState(seed)
    planes = [rng.uniform(-1, 1, PACKET).astype(np.float32) for _ in range(6)]
    tri = rng.uniform(-1, 1, (G, 128)).astype(np.float32)
    rmat = rng.uniform(-1, 1, (16, 1024)).astype(np.float32)
    cmat = rng.uniform(-1, 1, (G * 32, 16)).astype(np.float32)
    return RandFixture(planes, tri, rmat, cmat)


class AccuracyFixture(NamedTuple):
    v0: np.ndarray   # (8, 3) f32: one leaf group of 8 triangles
    e1: np.ndarray
    e2: np.ndarray
    o: np.ndarray    # (1024, 3) f32 rays
    d: np.ndarray    # (1024, 3) f32, unit length


def accuracy_fixture(dense: bool = True) -> AccuracyFixture:
    """The fixtures of accuracy_check: dense aims every ray at a random
    triangle of the group (hundreds of real hits); otherwise random
    directions from one origin."""
    rng = np.random.RandomState(1)
    T = L
    if dense:
        v0 = rng.uniform(-30, 30, (T, 3)).astype(np.float32)
        e1 = rng.uniform(-10, 10, (T, 3)).astype(np.float32)
        e2 = rng.uniform(-10, 10, (T, 3)).astype(np.float32)
        o = np.tile(np.array([[0.0, 0.0, -80.0]], np.float32), (1024, 1))
        ti = rng.randint(0, T, 1024)
        a = rng.uniform(0, 1, (1024, 1)).astype(np.float32)
        b = (rng.uniform(0, 1, (1024, 1)) * (1 - a)).astype(np.float32)
        target = v0[ti] + a * e1[ti] + b * e2[ti]
        d = (target - o).astype(np.float32)
    else:
        v0 = rng.uniform(-50, 50, (T, 3)).astype(np.float32)
        e1 = rng.uniform(-8, 8, (T, 3)).astype(np.float32)
        e2 = rng.uniform(-8, 8, (T, 3)).astype(np.float32)
        o = np.tile(rng.uniform(-60, -40, (1, 3)), (1024, 1)).astype(np.float32)
        d = rng.uniform(-1, 1, (1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)
    return AccuracyFixture(v0, e1, e2, o, d)


def tri_row(v0, e1, e2) -> np.ndarray:
    """(1, 128) packed row [v0, e1, e2, n] of the group, as accuracy_check
    packs it for _mt_scalar_tri."""
    n = np.cross(e1, e2)
    row = np.zeros((1, 128), np.float32)
    row[0, : 12 * v0.shape[0]] = np.concatenate([v0, e1, e2, n], 1).reshape(-1)
    return row


def overlap_rays() -> List[np.ndarray]:
    """microbench_overlap.py `_rays`: ox, oy, oz, dx, dy, dz as (8, 128) f32
    planes of standard normals."""
    rng = np.random.default_rng(0)
    o = [rng.normal(size=PACKET).astype(np.float32) for _ in range(3)]
    d = [rng.normal(size=PACKET).astype(np.float32) for _ in range(3)]
    return o + d


def overlap_boxes() -> Tuple[np.ndarray, np.ndarray]:
    """`_boxes`: (N, 32) f32 node rows of 4 child boxes [min, max] at
    [6k, 6k + 6) and (N, 8) i32 rows of 4 encodings in [-64, 64) and 4
    validity flags of 1 (the BVH4 layout of ops/pack.py)."""
    rng = np.random.default_rng(1)
    mn = rng.uniform(-4, 3, size=(N_NODES, 4, 3)).astype(np.float32)
    mx = mn + rng.uniform(0.1, 1.0, size=(N_NODES, 4, 3)).astype(np.float32)
    qbox = np.zeros((N_NODES, 32), np.float32)
    for k in range(4):
        qbox[:, 6 * k : 6 * k + 3] = mn[:, k]
        qbox[:, 6 * k + 3 : 6 * k + 6] = mx[:, k]
    meta = np.zeros((N_NODES, 8), np.int32)
    meta[:, :4] = rng.integers(-64, 64, size=(N_NODES, 4))
    meta[:, 4:] = 1
    return qbox, meta


def overlap_cmat() -> np.ndarray:
    """`_cmat`: (N_GROUPS * 32, 32) bf16 bits, rows [hi(16) | lo(16)] of a
    normal (N_GROUPS * 32, 16) f32 table."""
    rng = np.random.default_rng(2)
    c = rng.normal(size=(N_GROUPS * 32, 16)).astype(np.float32)
    hi, lo = split_bf16(c)
    return np.concatenate([hi, lo], axis=1)


def overlap_rmats(rays: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """`_rmats`: the (16, 1024) feature rows of the packet's rays, split into
    bf16 halves (bits)."""
    ox, oy, oz, dx, dy, dz = rays
    feats = [dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx,
             ox, oy, oz]
    R = np.concatenate(
        [np.stack([f.reshape(-1) for f in feats], axis=0),
         np.ones((1, ox.size), np.float32), np.zeros((6, ox.size), np.float32)], axis=0)
    return split_bf16(R)


def bf16_rand(shape, bf16: bool = False) -> np.ndarray:
    """microbench_bf16.py `_rand`: normal(size=shape) + 2 from
    default_rng(0) (a fresh generator each call, so every call with one
    shape gives the same values), as f32, or as bf16 bits (rounded to
    nearest even from f32, as jnp.asarray(..., bfloat16) gives them)."""
    x = (np.random.default_rng(0).normal(size=shape) + 2.0).astype(np.float32)
    return bf16_bits(x) if bf16 else x


def bf16_box_rows() -> np.ndarray:
    """`_box_rows`: (4096, 16) f32 node rows of two random child boxes,
    [min, max] of child k at [6k, 6k + 6) (default_rng(1))."""
    rng = np.random.default_rng(1)
    mn = rng.uniform(-4, 3, size=(BF16_NODES, 2, 3)).astype(np.float32)
    mx = mn + rng.uniform(0.1, 1.0, size=(BF16_NODES, 2, 3)).astype(np.float32)
    rows = np.zeros((BF16_NODES, 16), np.float32)
    for k in range(2):
        rows[:, 6 * k : 6 * k + 3] = mn[:, k]
        rows[:, 6 * k + 3 : 6 * k + 6] = mx[:, k]
    return rows


def inner_meta_flat() -> np.ndarray:
    """microbench_inner.py's `meta_flat`: the (N, 8) meta rows of
    overlap_boxes flattened, (N * 8,) i32 (bodies E and I)."""
    return np.ascontiguousarray(overlap_boxes()[1].reshape(-1))


def glue_meta_s() -> np.ndarray:
    """microbench_glue.py's `meta_s`: the 4 encodings of each meta row,
    (N * 4,) i32 (full_xs and xb)."""
    return np.ascontiguousarray(overlap_boxes()[1][:, :4].reshape(-1).astype(np.int32))


def lf_tables() -> Tuple[np.ndarray, np.ndarray]:
    """The Lf bodies' tables (default_rng(7)): cmi, (LF_GROUPS * 32, 32) bf16
    bits of a normal table ([Ch | Cl]: two independent halves, not a split),
    then rmat, (16, 1024) f32 normal feature rows."""
    rng = np.random.default_rng(7)
    cmi = bf16_bits(rng.normal(size=(LF_GROUPS * 32, 32)).astype(np.float32))
    rmat = rng.normal(size=(16, PACKET[0] * PACKET[1])).astype(np.float32)
    return cmi, rmat


def cond_tile() -> np.ndarray:
    """microbench_cond.py's (8, 128) f32 tile of standard normals
    (default_rng(0))."""
    return np.random.default_rng(0).normal(size=PACKET).astype(np.float32)


# The checks' grown boxes: with the script's boxes (0.1-1 wide in a box of
# 7) a packet misses some child in nearly every iteration, so its sum of
# child minima is infinite and e only counts; 2 more on each side makes most
# warp packets hit all 32 children (finite sums, negative where the origins
# sit inside the boxes), so e branches.
GROW = 2.0


def grown_boxes(qbox: np.ndarray, by: float = GROW) -> np.ndarray:
    """BVH4 node rows (N, 32) with each child's box widened by `by` on each
    side."""
    out = np.array(qbox, np.float32)
    b = out[:, :24].reshape(-1, 4, 6)
    b[..., :3] -= np.float32(by)
    b[..., 3:] += np.float32(by)
    out[:, :24] = b.reshape(-1, 24)
    return out


class MxuInnerTables(NamedTuple):
    qbox: np.ndarray    # (512, 32) f32 BVH4 rows, child k's [min, max] at [6k, 6k + 6)
    meta4: np.ndarray   # (512, 8) i32: 4 encodings in [-64, 64), 4 flags of 1
    w8: np.ndarray      # (512 * 48, 32) bf16 bits: W rows of the BVH8 nodes, [h | l]
    meta8: np.ndarray   # (512, 16) i32: 8 encodings, 8 flags of 1
    w4: np.ndarray      # (512 * 24, 32) bf16 bits: W rows of other BVH4 nodes, [h | l]


def mxu_inner_w(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    """`w_table`'s rows of (N, A, 3) boxes: row n (6A) + q A + k holds
    quantity q of child k against the features [inv (3), oi (3), 0 x 10]: a
    lo row (q = 2c) `lo` at feature c and -1 at 3 + c, a hi row (q = 2c +
    1) `hi` there; split into bf16 halves [h | l] (bits, rounded to nearest
    even, as the script's kernel rounds l)."""
    n, a = mn.shape[:2]
    w = np.zeros((n, 6, a, 16), np.float32)
    for c in range(3):
        w[:, 2 * c, :, c] = mn[:, :, c]
        w[:, 2 * c + 1, :, c] = mx[:, :, c]
        w[:, 2 * c : 2 * c + 2, :, 3 + c] = -1.0
    h, l = split_bf16(w.reshape(n * 6 * a, 16))
    return np.concatenate([h, l], axis=1)


def mxu_inner_tables(grow: float = 0.0) -> MxuInnerTables:
    """microbench_mxu_inner.py's `_tables`: one default_rng(1) drawn in its
    order: the BVH4 boxes and meta4 encodings, w_table(8)'s boxes,
    w_table(4)'s boxes, then the meta8 encodings. `grow` > 0 widens every
    box by that much on each side (the checks' second fixture, where the
    packets hit every child; see grown_boxes)."""
    rng = np.random.default_rng(1)
    n = MXU_INNER_NODES
    g = np.float32(grow)

    def boxes(a):
        mn = rng.uniform(-4, 3, size=(n, a, 3)).astype(np.float32)
        mx = mn + rng.uniform(0.1, 1.0, size=(n, a, 3)).astype(np.float32)
        return mn - g, mx + g

    mn4, mx4 = boxes(4)
    qbox = np.zeros((n, 32), np.float32)
    for k in range(4):
        qbox[:, 6 * k : 6 * k + 3] = mn4[:, k]
        qbox[:, 6 * k + 3 : 6 * k + 6] = mx4[:, k]
    meta4 = np.zeros((n, 8), np.int32)
    meta4[:, :4] = rng.integers(-64, 64, size=(n, 4))
    meta4[:, 4:] = 1
    w8 = mxu_inner_w(*boxes(8))
    w4 = mxu_inner_w(*boxes(4))
    meta8 = np.zeros((n, 16), np.int32)
    meta8[:, :8] = rng.integers(-64, 64, size=(n, 8))
    meta8[:, 8:] = 1
    return MxuInnerTables(qbox, meta4, w8, meta8, w4)

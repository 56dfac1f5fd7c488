"""Plain PyTorch versions of the traversal kernels: brute force over every
slot of the packed triangle rows.

The BVH only accelerates the search, so testing every triangle slot gives
the same function as the kernels in csrc/trace.cuh, with the same outputs
and sentinels:

  - miss: t = T_MAX, idx = -1, norm_dir = False, attributes 0;
  - idx is the slot g*L + j of the packed `tri` rows;
  - norm_dir is det < 0 of the winning triangle;
  - n is the raw (unnormalised) normal from the row, kd/ks/kr come from
    the `attr` row;
  - blocked is t < T_MAX and t*t < max_dist2 for some slot.

Ties between slots go to the lowest slot (a kernel's tie goes to the
first leaf it visits). Rays are processed against chunks of slots so the
(rays x slots) temporaries stay bounded. A dead ray (direction 0, as the
renderers mask finished rays) misses every slot here as in the kernels
(rt_dead), so it takes the miss outputs without being tested. The ray
planes may have any shape; outputs take the same shape.

The `*_mxu_plain` versions are those of the MXU leaf (pallas_trace.py
:1002-1466): every ray against every slot's rows of the C-matrix table
(ops/pack.build_cmat), as the products of JAX's bf16x3 split,
Ch.Rh + Ch.Rl + Cl.Rh, each an f32 matmul of bf16-valued halves (a product
of two bf16 values is exact in f32, as JAX's dot with
preferred_element_type=f32 gives it), then JAX's hit test on the divided
quantities (_mxu_rows) with the first minimal slot winning, or its
division-free any-hit test (_mxu_occl_merge). The table is the (rows, 32)
[hi | lo] layout of ops/pack.split_cmat or the four-group (rows, 128)
layout of ops/pack.pack_cmi4, as a torch.bfloat16 tensor.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .intersect import EPSILON, T_MAX, mt_rows
from .pack import ATTR_STRIDE, CMAT_K, TRI_STRIDE
from .vecmath import Vec3

# Elements of one (rays x slots) temporary per chunk.
_CHUNK_ELEMS = {"cuda": 1 << 26, "cpu": 1 << 22}


class Hit(NamedTuple):
    t: torch.Tensor          # f32, T_MAX on miss
    idx: torch.Tensor        # i32 slot, -1 on miss
    norm_dir: torch.Tensor   # bool: det < 0 (selects the -n normal)


class HitFull(NamedTuple):
    """Hit plus the winning triangle's raw normal and material."""

    t: torch.Tensor
    idx: torch.Tensor
    norm_dir: torch.Tensor
    n: Vec3
    kd: Vec3
    ks: Vec3
    kr: Vec3


def _live_slots(tri: torch.Tensor, leaf_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot ids, (S, 12) rows) of the slots that can hit (n != 0)."""
    rows = tri[:, : TRI_STRIDE * leaf_size].reshape(-1, TRI_STRIDE)
    ids = torch.nonzero((rows[:, 9:12] != 0).any(dim=1)).flatten()
    return ids, rows[ids]


def _chunks(n_rays: int, n_slots: int, device: torch.device):
    step = max(1, _CHUNK_ELEMS.get(device.type, 1 << 22) // max(n_rays, 1))
    for s0 in range(0, n_slots, step):
        yield s0, min(n_slots, s0 + step)


def _flat(v: Vec3) -> Vec3:
    return Vec3(*(p.reshape(-1, 1) for p in v))


def _live(d: Vec3) -> torch.Tensor:
    """Indices of the rays with a direction (not dead) among flat planes."""
    return torch.nonzero(((d.x != 0) | (d.y != 0) | (d.z != 0)).reshape(-1)).flatten()


def _take(v: Vec3, rows: torch.Tensor) -> Vec3:
    return Vec3(*(p[rows] for p in v))


def _scatter(v: torch.Tensor, live: torch.Tensor, shape, miss) -> torch.Tensor:
    """The live rays' values v in planes of `shape`, `miss` elsewhere."""
    out = torch.full((int(np.prod(shape)),), miss, dtype=v.dtype, device=v.device)
    out[live] = v
    return out.reshape(shape)


def closest_plain(tri: torch.Tensor, o: Vec3, d: Vec3, leaf_size: int) -> Hit:
    """Nearest hit per ray over every triangle slot."""
    shape = o.x.shape
    of, df = _flat(o), _flat(d)
    live = _live(df)
    of, df = _take(of, live), _take(df, live)
    n = live.numel()
    ids, rows = _live_slots(tri, leaf_size)
    t = torch.full((n,), T_MAX, dtype=torch.float32, device=tri.device)
    idx = torch.full((n,), -1, dtype=torch.int32, device=tri.device)
    nd = torch.zeros((n,), dtype=torch.bool, device=tri.device)
    for s0, s1 in _chunks(n, rows.shape[0], tri.device):
        tc, ndc = mt_rows(of, df, rows[s0:s1])
        cmin, carg = tc.min(dim=1)            # first minimal slot of the chunk
        better = cmin < t                     # strict: earlier chunks win ties
        t = torch.where(better, cmin, t)
        idx = torch.where(better, ids[s0:s1][carg].to(torch.int32), idx)
        nd = torch.where(better, ndc.gather(1, carg[:, None])[:, 0], nd)
    return Hit(t=_scatter(t, live, shape, T_MAX), idx=_scatter(idx, live, shape, -1),
               norm_dir=_scatter(nd, live, shape, False))


def closest_full_plain(tri: torch.Tensor, attr: torch.Tensor, o: Vec3, d: Vec3,
                       leaf_size: int) -> HitFull:
    """closest_plain plus the winning slot's raw normal and kd/ks/kr."""
    return _with_attrs(closest_plain(tri, o, d, leaf_size), tri, attr, leaf_size)


def _with_attrs(h: Hit, tri: torch.Tensor, attr: torch.Tensor, leaf_size: int) -> HitFull:
    """The winning slot's raw normal (tri) and kd/ks/kr (attr) beside h;
    zeros on a miss."""
    L = leaf_size
    tri_rows = tri[:, : TRI_STRIDE * L].reshape(-1, TRI_STRIDE)
    attr_rows = attr[:, : ATTR_STRIDE * L].reshape(-1, ATTR_STRIDE)
    hit = h.idx >= 0
    safe = h.idx.clamp(min=0).long()
    n = torch.where(hit[..., None], tri_rows[safe, 9:12], 0.0)
    a = torch.where(hit[..., None], attr_rows[safe], 0.0)

    def vec(p, k):
        return Vec3(p[..., k], p[..., k + 1], p[..., k + 2])

    return HitFull(
        t=h.t, idx=h.idx, norm_dir=h.norm_dir,
        n=vec(n, 0), kd=vec(a, 0), ks=vec(a, 3), kr=vec(a, 6),
    )


def occluded_plain(tri: torch.Tensor, o: Vec3, d: Vec3, max_dist2: torch.Tensor,
                   leaf_size: int) -> torch.Tensor:
    """Any hit with t*t < max_dist2 per ray, over every triangle slot."""
    shape = o.x.shape
    of, df = _flat(o), _flat(d)
    live = _live(df)
    of, df = _take(of, live), _take(df, live)
    m2 = max_dist2.reshape(-1, 1)[live]
    n = live.numel()
    _, rows = _live_slots(tri, leaf_size)
    blocked = torch.zeros((n,), dtype=torch.bool, device=tri.device)
    for s0, s1 in _chunks(n, rows.shape[0], tri.device):
        tc, _ = mt_rows(of, df, rows[s0:s1])
        hit = (tc < T_MAX) & (tc * tc < m2)
        blocked = blocked | hit.any(dim=1)
    return _scatter(blocked, live, shape, False)


# ---- the MXU leaf -----------------------------------------------------------

@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matmuls in full f32 on the card: the MXU plain versions set
    torch.backends.cuda.matmul.allow_tf32 = False for themselves (TF32
    would round the bf16 halves' sums to 10 bits) and restore it after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _slot_cmat(cmat: torch.Tensor, n_groups: int, leaf_size: int):
    """(slot ids, hi, lo) of the live slots: hi and lo (S, 4, 16) f32 hold
    the bf16 halves of quantity q's C row of slot g*L + j. A cmi4 table
    (rows, 128) is first laid out as (rows, 32) [hi | lo] rows."""
    L, GR = leaf_size, 4 * leaf_size
    if cmat.shape[1] == 4 * 2 * CMAT_K:          # four groups per row
        cmat = (cmat.reshape(-1, GR, 4, 2 * CMAT_K).permute(0, 2, 1, 3)
                .reshape(-1, 2 * CMAT_K))
    c = cmat[: n_groups * GR].float().reshape(n_groups, 4, L, 2 * CMAT_K)
    c = c.permute(0, 2, 1, 3).reshape(n_groups * L, 4, 2 * CMAT_K)
    ids = torch.nonzero((c != 0).flatten(1).any(dim=1)).flatten()
    c = c[ids]
    return ids, c[..., :CMAT_K].contiguous(), c[..., CMAT_K:].contiguous()


def _ray_halves(o: Vec3, d: Vec3):
    """(Rh, Rl): the (n, 16) feature rows R = [d, o x d, o, 1, 0 x 6] of
    flat rays split into bf16 halves, as f32 values (_rmat_load,
    _split_bf16)."""
    mx = o.y * d.z - o.z * d.y
    my = o.z * d.x - o.x * d.z
    mz = o.x * d.y - o.y * d.x
    one = torch.ones_like(d.x)
    zero = torch.zeros_like(d.x)
    r = torch.stack([d.x, d.y, d.z, mx, my, mz, o.x, o.y, o.z, one] + [zero] * 6, dim=1)
    rh = r.to(torch.bfloat16).float()
    rl = (r - rh).to(torch.bfloat16).float()
    return rh, rl


def _mxu_quants(rh, rl, hi, lo):
    """(n, S, 4) quantities Ch.Rh + Ch.Rl + Cl.Rh of the rays against the
    slots' C rows (hi, lo: (S, 4, 16)), summed in JAX's order."""
    h = hi.reshape(-1, CMAT_K).T
    q = (rh @ h + rl @ h) + rh @ lo.reshape(-1, CMAT_K).T
    return q.reshape(rh.shape[0], hi.shape[0], 4)     # n may be 0: no live ray


def _mxu_rays(o: Vec3, d: Vec3, cmat, tri, leaf_size):
    """The flat rays' live indices (direction not 0) and their (Rh, Rl), and
    the live slots' (ids, hi, lo)."""
    of, df = Vec3(*(p.reshape(-1) for p in o)), Vec3(*(p.reshape(-1) for p in d))
    live = _live(df)
    return (live, _ray_halves(_take(of, live), _take(df, live)),
            *_slot_cmat(cmat, tri.shape[0], leaf_size))


def closest_mxu_plain(cmat: torch.Tensor, tri: torch.Tensor, o: Vec3, d: Vec3,
                      leaf_size: int) -> Hit:
    """Nearest hit per ray by the MXU leaf's test over every slot: t =
    t_num / det with u, v likewise and the hit test of _mxu_rows; the first
    minimal slot wins; norm_dir is det < 0 of the winner."""
    shape = o.x.shape
    with _full_f32_matmul():
        live, (rh, rl), ids, hi, lo = _mxu_rays(o, d, cmat, tri, leaf_size)
        n = rh.shape[0]
        t = torch.full((n,), T_MAX, dtype=torch.float32, device=tri.device)
        idx = torch.full((n,), -1, dtype=torch.int32, device=tri.device)
        nd = torch.zeros((n,), dtype=torch.bool, device=tri.device)
        for s0, s1 in _chunks(4 * n, ids.shape[0], tri.device):
            q = _mxu_quants(rh, rl, hi[s0:s1], lo[s0:s1])
            det = q[..., 0]
            invdet = 1.0 / det
            tj, u, v = q[..., 1] * invdet, q[..., 2] * invdet, q[..., 3] * invdet
            hit = ((det.abs() >= EPSILON) & (tj > EPSILON) & (u >= 0.0) & (v >= 0.0)
                   & ((u + v) <= 1.0))
            tc = torch.where(hit, tj, torch.full_like(tj, T_MAX))
            cmin, carg = tc.min(dim=1)
            better = cmin < t
            t = torch.where(better, cmin, t)
            idx = torch.where(better, ids[s0:s1][carg].to(torch.int32), idx)
            nd = torch.where(better, (det < 0.0).gather(1, carg[:, None])[:, 0], nd)
    return Hit(t=_scatter(t, live, shape, T_MAX), idx=_scatter(idx, live, shape, -1),
               norm_dir=_scatter(nd, live, shape, False))


def closest_full_mxu_plain(cmat: torch.Tensor, tri: torch.Tensor, attr: torch.Tensor,
                           o: Vec3, d: Vec3, leaf_size: int) -> HitFull:
    """closest_mxu_plain plus the winning slot's raw normal and kd/ks/kr
    (_mxu_attr_select)."""
    return _with_attrs(closest_mxu_plain(cmat, tri, o, d, leaf_size), tri, attr, leaf_size)


def occluded_mxu_plain(cmat: torch.Tensor, tri: torch.Tensor, o: Vec3, d: Vec3,
                       max_dist2: torch.Tensor, leaf_size: int) -> torch.Tensor:
    """Any hit per ray by _mxu_occl_merge's division-free test over every
    slot: with d2 = det^2, d2 >= EPS^2, t_num*det > EPS*d2, u_num*det >= 0,
    v_num*det >= 0, their sum <= d2, and t_num^2 < max_dist2 * d2."""
    shape = o.x.shape
    eps = float(np.float32(EPSILON))
    eps2 = float(np.float32(EPSILON) * np.float32(EPSILON))
    with _full_f32_matmul():
        live, (rh, rl), ids, hi, lo = _mxu_rays(o, d, cmat, tri, leaf_size)
        m2 = max_dist2.reshape(-1, 1)[live]
        n = rh.shape[0]
        blocked = torch.zeros((n,), dtype=torch.bool, device=tri.device)
        for s0, s1 in _chunks(4 * n, ids.shape[0], tri.device):
            q = _mxu_quants(rh, rl, hi[s0:s1], lo[s0:s1])
            det, tn = q[..., 0], q[..., 1]
            d2 = det * det
            pu, pv = q[..., 2] * det, q[..., 3] * det
            hit = ((d2 >= eps2) & (tn * det > eps * d2) & (pu >= 0.0) & (pv >= 0.0)
                   & (pu + pv <= d2) & (tn * tn < m2 * d2))
            blocked = blocked | hit.any(dim=1)
    return _scatter(blocked, live, shape, False)

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
(rays x slots) temporaries stay bounded. The ray planes may have any shape;
outputs take the same shape.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .intersect import T_MAX, mt_rows
from .pack import ATTR_STRIDE, TRI_STRIDE
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


def closest_plain(tri: torch.Tensor, o: Vec3, d: Vec3, leaf_size: int) -> Hit:
    """Nearest hit per ray over every triangle slot."""
    shape = o.x.shape
    of, df = _flat(o), _flat(d)
    n = of.x.shape[0]
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
    return Hit(t=t.reshape(shape), idx=idx.reshape(shape), norm_dir=nd.reshape(shape))


def closest_full_plain(tri: torch.Tensor, attr: torch.Tensor, o: Vec3, d: Vec3,
                       leaf_size: int) -> HitFull:
    """closest_plain plus the winning slot's raw normal and kd/ks/kr."""
    h = closest_plain(tri, o, d, leaf_size)
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
    m2 = max_dist2.reshape(-1, 1)
    n = of.x.shape[0]
    _, rows = _live_slots(tri, leaf_size)
    blocked = torch.zeros((n,), dtype=torch.bool, device=tri.device)
    for s0, s1 in _chunks(n, rows.shape[0], tri.device):
        tc, _ = mt_rows(of, df, rows[s0:s1])
        hit = (tc < T_MAX) & (tc * tc < m2)
        blocked = blocked | hit.any(dim=1)
    return blocked.reshape(shape)

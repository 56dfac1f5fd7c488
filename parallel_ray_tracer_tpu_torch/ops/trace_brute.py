"""Port of parallel_ray_tracer_tpu/ops/trace_brute.py: every ray against every
triangle, the USE_BVH=0 oracle (cpu/src/raytracer.c:112-130 closest hit,
:85-97 occlusion).

Torch ops over chunks of the DeviceScene's triangle planes, on the scene's
device (the card unless the caller asks for the CPU), carrying the running
(t, index, norm_dir) minimum. JAX has no Pallas kernel here, and neither
does the port. A chunk holds at most `chunk` triangles and at most
_CHUNK_ELEMS (rays x triangles) elements, so the temporaries stay bounded
at any frame size.

Tie-breaking matches the reference: the first minimum inside a chunk and a
strict improvement across chunks give the first index of the minimum.
"""

from __future__ import annotations

import torch

from .intersect import T_MAX, moller_trumbore
from .spheres import wrap_tracer
from .trace_plain import _CHUNK_ELEMS, Hit
from .vecmath import Vec3


def _chunks(ds, n_rays: int, chunk: int):
    """(first, end) triangle ranges of at most `chunk` triangles and at most
    _CHUNK_ELEMS (rays x triangles) elements each."""
    T = ds.num_triangles
    step = max(1, min(chunk, _CHUNK_ELEMS.get(ds.device.type, 1 << 22) // max(n_rays, 1)))
    for t0 in range(0, T, step):
        yield t0, min(T, t0 + step)


def _tris(ds, t0: int, t1: int):
    def sl(v: Vec3) -> Vec3:
        return Vec3(*(p[None, t0:t1] for p in v))

    return sl(ds.v0), sl(ds.v1), sl(ds.v2)


def _flat(v: Vec3) -> Vec3:
    return Vec3(*(p.reshape(-1, 1) for p in v))


def closest_hit(ds, o: Vec3, d: Vec3, chunk: int = 512) -> Hit:
    """First hit over all triangles; the ray planes may have any shape."""
    shape = o.x.shape
    of, df = _flat(o), _flat(d)
    R = of.x.shape[0]
    t = torch.full((R,), T_MAX, dtype=torch.float32, device=of.x.device)
    idx = torch.full((R,), -1, dtype=torch.int32, device=of.x.device)
    nd = torch.zeros((R,), dtype=torch.bool, device=of.x.device)
    for t0, t1 in _chunks(ds, R, chunk):
        h = moller_trumbore(of, df, *_tris(ds, t0, t1))      # (R, chunk)
        t_c, am = h.t.min(dim=1)                              # first min in chunk
        better = t_c < t
        t = torch.where(better, t_c, t)
        idx = torch.where(better, (am + t0).to(torch.int32), idx)
        nd = torch.where(better, h.norm_dir.gather(1, am[:, None])[:, 0], nd)
    idx = torch.where(t < T_MAX, idx, -1)
    return Hit(t=t.reshape(shape), idx=idx.reshape(shape), norm_dir=nd.reshape(shape))


def occluded(ds, o: Vec3, d: Vec3, max_dist2: torch.Tensor, chunk: int = 512):
    """Any hit: True where some triangle lies at t with t*t < max_dist2
    along the unit direction d (cpu/src/raytracer.c:85-97)."""
    shape = o.x.shape
    of, df = _flat(o), _flat(d)
    m2 = max_dist2.reshape(-1, 1)
    R = of.x.shape[0]
    blocked = torch.zeros((R,), dtype=torch.bool, device=of.x.device)
    for t0, t1 in _chunks(ds, R, chunk):
        h = moller_trumbore(of, df, *_tris(ds, t0, t1))
        blocked = blocked | ((h.t < T_MAX) & (h.t * h.t < m2)).any(dim=1)
    return blocked.reshape(shape)


def make_tracer(ds, chunk: int = 512):
    """The (closest_hit, occluded) pair for the bounce loop, with the
    scene's spheres (ops/spheres.wrap_tracer)."""
    return wrap_tracer(
        ds,
        lambda o, d: closest_hit(ds, o, d, chunk=chunk),
        lambda o, d, m2: occluded(ds, o, d, m2, chunk=chunk),
    )

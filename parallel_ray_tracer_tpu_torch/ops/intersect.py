"""Port of parallel_ray_tracer_tpu/ops/intersect.py: the constants, the
triangle tests, the slab test and the ray-sphere test.

`mt_rows` is Möller–Trumbore on the packed triangle row layout
[v0, e1, e2, n] (n = e1 x e2), written in the same operation order as the
JAX kernels' `_mt_scalar_tri` (ops/pallas_trace.py:563-594) and the CUDA
kernels' `rt_mt` (csrc/trace.cuh), so that all three round alike.
`moller_trumbore` is the same test on vertex planes (intersect.py:36-66),
which the brute-force tracer uses; `moller_trumbore_t` the differentiable
(t, u, v) of a known hit (intersect.py:67-90), which ops/diff.py recomputes
on the winning triangle; `aabb_intersect` the slab test of the packet
traversal (intersect.py:114-130, ops/trace_bvh.py); and `ray_sphere` the
sphere test
(intersect.py:140-162), in the operation order of the CUDA frame kernel's
`rt_sphere_t`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .pack import T_MAX  # noqa: F401  (re-exported: the miss sentinel)
from .vecmath import Vec3

EPSILON = 1e-3
INV_DIR_MAX = 1e30          # finite stand-in for 1/0 (see clip_inv_dir)


def clip_inv_dir(d: Vec3) -> Vec3:
    """Reciprocal direction with infinities clamped to +/-INV_DIR_MAX, so the
    slab test never meets 0 * inf (ops/intersect.py:94-111 of the JAX
    package)."""
    return Vec3(
        (1.0 / d.x).clamp(-INV_DIR_MAX, INV_DIR_MAX),
        (1.0 / d.y).clamp(-INV_DIR_MAX, INV_DIR_MAX),
        (1.0 / d.z).clamp(-INV_DIR_MAX, INV_DIR_MAX),
    )


def mt_rows(o: Vec3, d: Vec3, rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays against packed triangle rows -> (t, det < 0).

    `rows` is (..., 12) as [v0.xyz, e1.xyz, e2.xyz, n.xyz]; the ray planes
    broadcast against rows[..., k]. Miss -> T_MAX. A zero row (padding) or a
    zero direction (a dead ray) has det == 0 and never hits.
    """
    v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
    e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
    e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
    nx, ny, nz = rows[..., 9], rows[..., 10], rows[..., 11]

    det = -(d.x * nx + d.y * ny + d.z * nz)
    invdet = 1.0 / det
    aox = o.x - v0x
    aoy = o.y - v0y
    aoz = o.z - v0z
    daox = aoy * d.z - aoz * d.y
    daoy = aoz * d.x - aox * d.z
    daoz = aox * d.y - aoy * d.x
    u = (e2x * daox + e2y * daoy + e2z * daoz) * invdet
    v = -(e1x * daox + e1y * daoy + e1z * daoz) * invdet
    t = (aox * nx + aoy * ny + aoz * nz) * invdet
    hit = (
        (det.abs() >= EPSILON)
        & (t > EPSILON)
        & (u >= 0.0)
        & (v >= 0.0)
        & ((u + v) <= 1.0)
    )
    return torch.where(hit, t, torch.full_like(t, T_MAX)), det < 0.0


class TriHit(NamedTuple):
    t: torch.Tensor          # distance in units of |dir|; T_MAX on miss
    norm_dir: torch.Tensor   # bool: det < 0 (selects the -n normal)
    u: torch.Tensor          # barycentric u (valid only when t < T_MAX)
    v: torch.Tensor          # barycentric v


def moller_trumbore(o: Vec3, d: Vec3, v0: Vec3, v1: Vec3, v2: Vec3) -> TriHit:
    """Möller–Trumbore on vertex planes (cpu/src/raytracer.c:35-59): rays
    and triangles broadcast against each other. The denominator is guarded
    as in JAX; the miss test gates the result, so the guard changes nothing
    that is returned as a hit."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = e1.cross(e2)
    det = -(d.dot(n))
    ok = det.abs() >= EPSILON
    invdet = 1.0 / torch.where(ok, det, torch.ones_like(det))
    ao = o - v0
    dao = ao.cross(d)
    u = e2.dot(dao) * invdet
    v = -(e1.dot(dao)) * invdet
    t = ao.dot(n) * invdet
    hit = ok & (t > EPSILON) & (u >= 0.0) & (v >= 0.0) & ((u + v) <= 1.0)
    return TriHit(t=torch.where(hit, t, torch.full_like(t, T_MAX)),
                  norm_dir=det < 0.0, u=u, v=v)


def moller_trumbore_t(o: Vec3, d: Vec3, v0: Vec3, v1: Vec3, v2: Vec3):
    """Differentiable (t, u, v) of the known-hit triangle, with no hit test:
    traversal has chosen the triangle, this recomputes the distance so that
    gradients reach the vertices. Real hits have |det| >= EPSILON, so the
    guarded denominator is inert for them; it keeps masked and miss lanes
    (garbage rays) finite, so their zero cotangents stay zero instead of
    0 * inf = NaN."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = e1.cross(e2)
    det = -(d.dot(n))
    det_safe = torch.where(det.abs() >= 1e-12, det, torch.ones_like(det))
    invdet = 1.0 / det_safe
    ao = o - v0
    dao = ao.cross(d)
    u = e2.dot(dao) * invdet
    v = -(e1.dot(dao)) * invdet
    t = ao.dot(n) * invdet
    return t, u, v


def aabb_intersect(bb_min: Vec3, bb_max: Vec3, o: Vec3, inv_d: Vec3) -> torch.Tensor:
    """Slab test returning the entry distance tmin, or T_MAX on a miss
    (cpu/src/bvh.c:48-59), in JAX's operation order. `inv_d` must come from
    clip_inv_dir (no NaNs). The box and ray planes broadcast."""
    tx1 = (bb_min.x - o.x) * inv_d.x
    tx2 = (bb_max.x - o.x) * inv_d.x
    tmin = torch.minimum(tx1, tx2)
    tmax = torch.maximum(tx1, tx2)
    ty1 = (bb_min.y - o.y) * inv_d.y
    ty2 = (bb_max.y - o.y) * inv_d.y
    tmin = torch.maximum(tmin, torch.minimum(ty1, ty2))
    tmax = torch.minimum(tmax, torch.maximum(ty1, ty2))
    tz1 = (bb_min.z - o.z) * inv_d.z
    tz2 = (bb_max.z - o.z) * inv_d.z
    tmin = torch.maximum(tmin, torch.minimum(tz1, tz2))
    tmax = torch.minimum(tmax, torch.maximum(tz1, tz2))
    hit = (tmax >= tmin) & (tmax > 0.0)
    return torch.where(hit, tmin, T_MAX)


class SphereHit(NamedTuple):
    t: torch.Tensor
    inside: torch.Tensor     # bool: origin inside the sphere (normal flips)


def ray_sphere(o: Vec3, d: Vec3, center: Vec3, radius) -> SphereHit:
    """Solve |o + t*d - c|^2 = r^2: the nearest t > EPSILON in units of |d|,
    T_MAX on miss. The sqrt and the denominator are guarded as in JAX
    (max(disc, 1e-30), a_safe = 1 where a <= 1e-20), so a dead ray (d = 0)
    misses."""
    oc = o - center
    a = d.dot(d)
    half_b = oc.dot(d)
    c = oc.dot(oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = torch.sqrt(disc.clamp(min=1e-30))
    a_safe = torch.where(a > 1e-20, a, torch.ones_like(a))
    t0 = (-half_b - sq) / a_safe
    t1 = (-half_b + sq) / a_safe
    t = torch.where(t0 > EPSILON, t0, t1)
    hit = (disc >= 0.0) & (t > EPSILON) & (a > 1e-20)
    return SphereHit(t=torch.where(hit, t, torch.full_like(t, T_MAX)),
                     inside=c < 0.0)

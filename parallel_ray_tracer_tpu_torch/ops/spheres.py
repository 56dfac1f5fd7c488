"""Port of parallel_ray_tracer_tpu/ops/spheres.py: spheres in the pass-based
and brute-force trace paths.

Scenes carry few spheres and no structure over them, so the spheres are
tested as one dense (rays x S) pass after the triangle tracer. Hit indices
extend the triangle index space: idx in [0, T) is a triangle slot, idx in
[T, T + S) is sphere idx - T, with T = ds.num_triangles (the slot count of
the flattened BVH, len(slot_map)); `norm_dir` carries the sphere's inside
flag. The fused frame kernel does the same pass inside the kernel
(csrc/trace.cuh, frame_kernel's SPH instances).
"""

from __future__ import annotations

import torch

from .intersect import T_MAX, ray_sphere
from .trace_plain import Hit
from .vecmath import Vec3, take


def _expand(v: Vec3) -> Vec3:
    return Vec3(v.x[..., None], v.y[..., None], v.z[..., None])


def nearest_sphere(center: Vec3, radius: torch.Tensor, o: Vec3, d: Vec3):
    """Nearest of the spheres (center, radius: (S,) planes) per ray:
    (t, sphere index, inside), shaped as the ray planes. The first of equal
    spheres wins."""
    h = ray_sphere(_expand(o), _expand(d), center, radius)   # (..., S)
    t, am = h.t.min(dim=-1)
    inside = h.inside.gather(-1, am[..., None])[..., 0]
    return t, am.to(torch.int32), inside


def sphere_closest(ds, o: Vec3, d: Vec3):
    """Nearest sphere of the scene per ray: (t, sphere index, inside)."""
    return nearest_sphere(ds.sph_c, ds.sph_r, o, d)


def wrap_tracer(ds, closest_fn, occluded_fn):
    """Extend a triangle-only (closest, occluded) pair with the sphere tests.

    The closest tracer then returns a plain Hit, whatever the wrapped one
    returns: shading gathers the attributes (ops/shade.surface_attrs). With
    no spheres it returns the originals."""
    S = ds.num_spheres
    if S == 0:
        return closest_fn, occluded_fn
    T = ds.num_triangles

    def closest(o: Vec3, d: Vec3) -> Hit:
        h = closest_fn(o, d)
        ts, si, inside = sphere_closest(ds, o, d)
        better = ts < h.t
        return Hit(
            t=torch.where(better, ts, h.t),
            idx=torch.where(better, T + si, h.idx),
            norm_dir=torch.where(better, inside, h.norm_dir),
        )

    def occluded(o: Vec3, d: Vec3, max_dist2: torch.Tensor) -> torch.Tensor:
        base = occluded_fn(o, d, max_dist2)
        ts, _, _ = sphere_closest(ds, o, d)
        return base | ((ts < T_MAX) & (ts * ts < max_dist2))

    return closest, occluded


def surface_frame(ds, hit: Hit, p: Vec3, tri_normal: Vec3, tri_mat):
    """(unflipped normal, material index) at the hit points: the triangle
    gathers with the sphere's (p - c) / r and material substituted where
    idx >= T."""
    S = ds.num_spheres
    if S == 0:
        return tri_normal, tri_mat
    T = ds.num_triangles
    is_sph = hit.idx >= T
    sidx = (hit.idx - T).clamp(0, S - 1).long()
    c = Vec3(ds.sph_c.x[sidx], ds.sph_c.y[sidx], ds.sph_c.z[sidx])
    r = ds.sph_r[sidx].clamp(min=1e-30)
    n = ((p - c) / r).where(is_sph, tri_normal)
    mat = torch.where(is_sph, ds.sph_mat[sidx], tri_mat)
    return n, mat


def override_attrs(ds, hit, p: Vec3, n: Vec3, kd: Vec3, ks: Vec3, kr: Vec3):
    """Substitute the sphere's normal (p - c) / r and its material's
    kd / ks / kr on the lanes that hit a sphere (idx >= T).

    JAX loops over the spheres with masked selects, since per-lane gathers
    are slow on the TPU; on the card one gather per plane replaces the S
    passes over the frame, with the same arithmetic per lane (vecmath.take,
    whose backward scatter-adds with atomics)."""
    S = ds.num_spheres
    if S == 0:
        return n, kd, ks, kr
    T = ds.num_triangles
    is_sph = hit.idx >= T
    sidx = (hit.idx - T).clamp(0, S - 1).long()
    r = take(ds.sph_r.clamp(min=1e-30), sidx)
    ns = Vec3((p.x - take(ds.sph_c.x, sidx)) / r, (p.y - take(ds.sph_c.y, sidx)) / r,
              (p.z - take(ds.sph_c.z, sidx)) / r)
    mi = ds.sph_mat.long()[sidx]

    def pick(table: Vec3, cur: Vec3) -> Vec3:
        return Vec3(*(torch.where(is_sph, take(t, mi), c) for t, c in zip(table, cur)))

    return ns.where(is_sph, n), pick(ds.kd, kd), pick(ds.ks, ks), pick(ds.kr, kr)

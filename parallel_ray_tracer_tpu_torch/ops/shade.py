"""Port of parallel_ray_tracer_tpu/ops/shade.py: shading and the masked
bounce loop as torch ops.

This is the pass-based renderer: each bounce calls a closest-hit tracer and,
per light, an any-hit tracer, with the glue in between as tensor ops. Run
over the plain traversals of ops/trace_plain.py it is also the plain version
of the fused frame kernel (csrc/trace.cuh `frame_kernel`). The brute-force
renderer runs it over ops/trace_brute.py.

Semantics, as in the reference GPU renderer (gpu/src/raytracer.cu:61-116):
  - Blinn-Phong without exponent, kd*max(0,n.l) + ks*max(0,n.h), with the
    unnormalised view -d in the half vector;
  - kd*ambient on hit, ambient on miss; 1/r^2 falloff; backface test
    dot(L-P, n) < 0; shadows by any-hit, traced from the light toward the
    hit point with the window (dist - EPSILON)^2 (reverse_shadows=True, which
    every render path here passes; see the JAX package's shade_hit
    docstring for why the window maps exactly), or from the hit point
    toward the light with the window dist^2 (reverse_shadows=False);
    occluded_from_closest finds them by the closest-hit traversal
    (USE_BVH_FAST_LIGHT=0);
  - reflection r = normalize(d + n*2|d.n|), multiplier *= kr, and the
    |multiplier|^2 < EPSILON^2 exit taken before the kr update.
A tracer returns either attribute-bearing hits (HitFull: the winning
triangle's raw normal and material, resolved in the kernel) or plain hits,
whose attributes shading gathers from the scene planes; spheres override
both (surface_attrs).
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from .intersect import EPSILON
from .spheres import override_attrs
from .trace_plain import Hit, HitFull
from .vecmath import Vec3, take

ClosestFn = Callable[[Vec3, Vec3], Union[Hit, HitFull]]
OccludedFn = Callable[[Vec3, Vec3, torch.Tensor], torch.Tensor]

_FAR_ORIGIN = 1e30


def mask_dead_rays(o: Vec3, d: Vec3, alive: torch.Tensor) -> Tuple[Vec3, Vec3]:
    """Dead lanes get direction 0 and an origin far outside every box: no
    box or triangle test can act on them (shade.py:40-56 of the JAX
    package)."""
    o = Vec3(*(torch.broadcast_to(p, alive.shape) for p in o))
    far = Vec3(*(torch.full_like(p, _FAR_ORIGIN) for p in o))
    zero = Vec3(d.x * 0, d.y * 0, d.z * 0)
    return o.where(alive, far), d.where(alive, zero)


def occluded_from_closest(closest_fn: ClosestFn) -> OccludedFn:
    """Shadow visibility by the closest-hit traversal instead of the any-hit
    one (USE_BVH_FAST_LIGHT=0; JAX shade.py:59-69): blocked where the
    closest hit lies nearer than the light, t^2 < max_dist2 (t in units of
    the unit shadow direction, cpu/src/raytracer.c:72-84)."""

    def occluded(o: Vec3, d: Vec3, max_dist2: torch.Tensor) -> torch.Tensor:
        h = closest_fn(o, d)
        return (h.idx >= 0) & (h.t * h.t < max_dist2)

    return occluded


def _gather_vec(v: Vec3, idx: torch.Tensor) -> Vec3:
    return Vec3(take(v.x, idx), take(v.y, idx), take(v.z, idx))


def surface_attrs(ds, hit, p: Vec3):
    """(unit unflipped normal, kd, ks, kr) at the hit points p.

    A HitFull carries the winning triangle's raw normal and material: only
    the normalisation is left. A plain Hit gathers n0 and the material of
    slot clip(idx, 0, T-1) from the scene planes. Either way the lanes
    that hit a sphere take its attributes (ops/spheres.override_attrs)."""
    if isinstance(hit, HitFull):
        inv = 1.0 / torch.sqrt(hit.n.mag2().clamp(min=1e-30))
        n = Vec3(hit.n.x * inv, hit.n.y * inv, hit.n.z * inv)
        return override_attrs(ds, hit, p, n, hit.kd, hit.ks, hit.kr)
    safe = hit.idx.clamp(0, ds.num_triangles - 1).long()
    mi = ds.mat_idx[safe].long()
    return override_attrs(ds, hit, p, _gather_vec(ds.n0, safe),
                          _gather_vec(ds.kd, mi), _gather_vec(ds.ks, mi),
                          _gather_vec(ds.kr, mi))


def shade_hit(ds, occluded_fn: OccludedFn, o: Vec3, d: Vec3, hit,
              active=None, reverse_shadows: bool = False) -> Vec3:
    """Direct lighting at the hit points (no reflection term): the
    reference's per-bounce kd*amb + sum over lights, with shadow rays from
    the light (reverse_shadows) or from the hit point (JAX shade_hit :111,
    its branches at :172). Miss lanes hold garbage; callers mask."""
    is_hit = hit.idx >= 0
    t_safe = torch.where(is_hit, hit.t, 1.0)
    if active is None:
        active = is_hit

    p = o + d * t_safe
    n, kd, ks, _ = surface_attrs(ds, hit, p)
    n = (-n).where(hit.norm_dir, n)

    col = kd * ds.ambient
    view = -d  # unnormalised, as in the reference (cpu/src/raytracer.c:148)

    for i in range(ds.num_lights):
        lp = Vec3(*(torch.broadcast_to(c[i], p.x.shape) for c in ds.lights_pos))
        kl = Vec3(*(c[i] for c in ds.lights_kl))
        lvec = lp - p
        mag2 = lvec.mag2()
        mag = torch.sqrt(mag2.clamp(min=1e-30))
        l = lvec / mag
        n_dot_l = n.dot(l)
        hv = l + view
        h = hv / torch.sqrt(hv.mag2().clamp(min=1e-30))
        coeff = n.dot(h).clamp(min=0.0)
        col_ray = kd * n_dot_l.clamp(min=0.0) + ks * coeff
        backface = lvec.dot(n) < 0.0
        need = active & ~backface
        if reverse_shadows:
            ro_m, rd_m = mask_dead_rays(lp, -l, need)
            occ = occluded_fn(ro_m, rd_m, (mag - EPSILON).clamp(min=0.0) ** 2)
        else:
            p_m, l_m = mask_dead_rays(p, l, need)
            occ = occluded_fn(p_m, l_m, mag2)
        vis = (~backface).to(torch.float32) * (1.0 - occ.to(torch.float32))
        contrib = kl * col_ray / mag2.clamp(min=1e-30)
        col = col + contrib * vis

    return col


def trace_rays(ds, closest_fn, occluded_fn, o: Vec3, d: Vec3, bounces: int,
               reverse_shadows: bool = False) -> Vec3:
    """Full masked bounce loop; returns the unclamped colour per ray.

    closest_fn / occluded_fn may each be a per-bounce sequence: entry b
    traces bounce b, and the last entry covers the remaining bounces (JAX
    shade.py:192-219; the pass-based path narrows the primary bounce's pop
    width this way). reverse_shadows: see shade_hit."""
    cfs = list(closest_fn) if isinstance(closest_fn, (list, tuple)) else [closest_fn]
    ofs = list(occluded_fn) if isinstance(occluded_fn, (list, tuple)) else [occluded_fn]
    zero = Vec3(o.x * 0, o.y * 0, o.z * 0)
    final = zero
    mult = Vec3(o.x * 0 + 1, o.y * 0 + 1, o.z * 0 + 1)
    alive = torch.ones(o.x.shape, dtype=torch.bool, device=o.x.device)

    for b in range(bounces):
        o_m, d_m = mask_dead_rays(o, d, alive)
        hit = cfs[min(b, len(cfs) - 1)](o_m, d_m)
        is_hit = hit.idx >= 0

        # Miss: add multiplier * ambient, lane dies (raytracer.cu:71-74).
        miss_now = alive & ~is_hit
        amb = Vec3(*(torch.broadcast_to(c, o.x.shape) for c in ds.ambient))
        final = final + (mult * amb).where(miss_now, zero)
        alive = alive & is_hit

        col = shade_hit(ds, ofs[min(b, len(ofs) - 1)], o, d, hit, active=alive,
                        reverse_shadows=reverse_shadows)
        final = final + (mult * col).where(alive, zero)

        # Early exit check happens BEFORE the kr update (raytracer.cu:103-106).
        alive = alive & (mult.mag2() >= EPSILON * EPSILON)

        t_safe = torch.where(is_hit, hit.t, 1.0)
        p = o + d * t_safe
        n, _, _, kr = surface_attrs(ds, hit, p)
        mult = mult * kr

        # Reflection ray (raytracer.cu:109-114).
        n = (-n).where(hit.norm_dir, n)
        refl = d + n * (2.0 * d.dot(n).abs())
        rmag = torch.sqrt(refl.mag2().clamp(min=1e-30))
        d = refl / rmag
        o = p

    return final

"""Port of parallel_ray_tracer_tpu/ops/diff.py: differentiable rendering,
gradients through the BVH tracer.

Pixel colours carry gradients with respect to the vertex positions (and the
normals derived from them), the materials, the lights and the spheres. The
decomposition is JAX's:

  closest_hit(o, d)  =  argmin topology   o  analytic intersection
                        (no gradient)         (differentiable)

Traversal only selects which primitive each ray hits; for a fixed topology
the hit distance is the smooth Möller–Trumbore t(v0, v1, v2, o, d) (or the
sphere's quadratic root). So the tracer (the CUDA closest-hit and any-hit
kernels through ops/cuda_trace.make_tracer, their plain versions on the
CPU, or the brute force) runs under torch.no_grad() on detached rays, and
the cotangent of t flows through an analytic recompute on the winning
primitive. Hit topology changes only on a measure-zero set (silhouettes),
where the true derivative has a Dirac edge term this formulation drops.

Attribute-bearing hits (HitFull, the kernels' closest_full) keep their
kernel-resolved materials as the primal; the materials get their gradient
through `_TableResolved`, whose backward scatter-adds the cotangent into
the material table (index_add_, JAX's .at[].add) without a forward gather.
The backward is torch ops, as JAX's is jnp: no kernel of its own.

Shadow visibility is a step function; make_soft_occluded gives JAX's
edge-aware relaxation (a sigmoid of the blocker's barycentric margin and
of its depth along the segment), so blockers receive gradients too.

JAX's stop_gradient is .detach() here. The guards that keep masked lanes'
zero cotangents from turning into 0 * inf = NaN are JAX's: the guarded
denominator of moller_trumbore_t, the finite stand-ins of the soft
visibility and its clipped sigmoid inputs, and where(valid, t, T_MAX).
"""

from __future__ import annotations

import torch

from .intersect import T_MAX, moller_trumbore_t, ray_sphere
from .shade import _gather_vec, trace_rays
from .trace_plain import Hit, HitFull
from .vecmath import Vec3, scatter_add_f64, take


def _detach(v: Vec3) -> Vec3:
    return Vec3(*(p.detach() for p in v))


def _stop_hit(hit) -> Hit:
    return Hit(t=hit.t.detach(), idx=hit.idx.detach(), norm_dir=hit.norm_dir.detach())


def _trace_detached(closest_fn, o: Vec3, d: Vec3):
    """The tracer on detached rays, outside the autograd graph."""
    with torch.no_grad():
        return closest_fn(_detach(o), _detach(d))


def _tri_vertices(ds, idx: torch.Tensor):
    """(v0, v1, v2) of the triangle slots clip(idx, 0, T-1), as gathers
    from the scene planes (their backward scatter-adds into the planes)."""
    safe = idx.clamp(0, ds.num_triangles - 1).long()
    return _gather_vec(ds.v0, safe), _gather_vec(ds.v1, safe), _gather_vec(ds.v2, safe)


def _recompute_tuv(ds, o: Vec3, d: Vec3, hit, tri=None):
    """Differentiable (t, u, v) on the fixed winning primitives (diff.py:50-82).

    Triangle slots recompute Möller–Trumbore; sphere slots (idx >= T, the
    index space of ops/spheres.py) the quadratic root, so sphere centres and
    radii receive gradients too. Sphere lanes carry u = v = 1/3, a large
    interior margin, so the soft-shadow edge term is inert there. The
    recomputed t is the primal (where valid, else T_MAX), so the forward
    and the backward see one value. `tri`: the winners' (v0, v1, v2) when
    the caller has gathered them already."""
    t, u, v = moller_trumbore_t(o, d, *(tri or _tri_vertices(ds, hit.idx)))
    S, T = ds.num_spheres, ds.num_triangles
    if S:
        is_sph = hit.idx >= T
        sidx = (hit.idx - T).clamp(0, S - 1).long()
        hs = ray_sphere(o, d, _gather_vec(ds.sph_c, sidx), take(ds.sph_r, sidx))
        t = torch.where(is_sph, hs.t, t)
        u = torch.where(is_sph, 1.0 / 3.0, u)
        v = torch.where(is_sph, 1.0 / 3.0, v)
    return torch.where(hit.idx >= 0, t, T_MAX), u, v


def _recompute_t(ds, o: Vec3, d: Vec3, hit, tri=None) -> torch.Tensor:
    return _recompute_tuv(ds, o, d, hit, tri)[0]


class _TableResolved(torch.autograd.Function):
    """Value: the kernel-resolved per-lane attributes (the primal). Gradient
    with respect to `table`: the gather's transpose, a scatter-add of the
    cotangent at idx (lanes with idx < 0 add nothing), without the forward
    ever executing the gather (diff.py:88-110). No gradient reaches the
    primal or idx."""

    @staticmethod
    def forward(ctx, table, idx, primal):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return primal.clone()

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        safe = idx.clamp(0, ctx.rows - 1).long().reshape(-1)
        src = torch.where(idx >= 0, g, torch.zeros_like(g)).reshape(-1)
        return scatter_add_f64(ctx.rows, safe, src), None, None


def _resolve_vec(table: Vec3, idx: torch.Tensor, primal: Vec3) -> Vec3:
    """The primal, in the graph of each table plane that needs a gradient."""
    return Vec3(*(_TableResolved.apply(t, idx, p) if t.requires_grad else p
                  for t, p in zip(table, primal)))


def make_diff_closest(ds, closest_fn):
    """A differentiable closest hit around a tracer (diff.py:121-191).

    The tracer runs under no_grad on detached rays; every one of its
    outputs is frozen. For a plain Hit the t is the analytic recompute
    (gradients to the scene planes, and through build_device_scene to the
    vertex buffer and the spheres). A HitFull keeps the kernel-resolved
    attributes on the fast path: the t is recomputed, the raw normal is
    recomputed from the same vertex gathers (sphere lanes keep the
    kernel's normal; one set of gathers serves both, as XLA's CSE merges
    JAX's), and the materials get their gradients through
    _TableResolved, at the material index of the lane (mat_idx of the
    triangle slot, sph_mat of the sphere, -1 on a miss)."""

    def closest(o: Vec3, d: Vec3):
        hit = _trace_detached(closest_fn, o, d)
        if not isinstance(hit, HitFull):
            hit = _stop_hit(hit)
            return Hit(t=_recompute_t(ds, o, d, hit), idx=hit.idx, norm_dir=hit.norm_dir)

        hit = HitFull(*(_detach(f) if isinstance(f, Vec3) else f.detach() for f in hit))
        v0, v1, v2 = tri = _tri_vertices(ds, hit.idx)
        t = _recompute_t(ds, o, d, hit, tri)
        T = ds.num_triangles
        is_tri = (hit.idx >= 0) & (hit.idx < T)
        n = (v1 - v0).cross(v2 - v0).where(is_tri, hit.n)
        safe = hit.idx.clamp(0, T - 1).long()
        mi = torch.where(is_tri, ds.mat_idx[safe], -1)
        S = ds.num_spheres
        if S:
            sidx = (hit.idx - T).clamp(0, S - 1).long()
            mi = torch.where(hit.idx >= T, ds.sph_mat[sidx], mi)
        return HitFull(t=t, idx=hit.idx, norm_dir=hit.norm_dir, n=n,
                       kd=_resolve_vec(ds.kd, mi, hit.kd),
                       ks=_resolve_vec(ds.ks, mi, hit.ks),
                       kr=_resolve_vec(ds.kr, mi, hit.kr))

    return closest


def make_soft_occluded(ds, closest_fn, beta: float = 25.0):
    """Edge-aware soft shadow visibility, a float in [0, 1] (diff.py:194-232).

    A blocked shadow ray's occlusion fades with its barycentric margin
    min(u, v, 1-u-v) on the blocking triangle (0 at the blocker's edge), and
    with the blocker's depth toward the light end of the segment; beta ->
    inf recovers the hard test for interior hits. Rays that miss carry no
    gradient (one-sided)."""

    def occluded(o: Vec3, d: Vec3, max_dist2: torch.Tensor) -> torch.Tensor:
        hit = _stop_hit(_trace_detached(closest_fn, o, d))
        t, u, v = _recompute_tuv(ds, o, d, hit)
        dist = torch.sqrt(max_dist2.clamp(min=1e-30))
        has_hit = hit.idx >= 0
        # Finite stand-ins on miss lanes keep every sigmoid input bounded
        # (T_MAX would overflow the logit; its sigmoid gradient is NaN).
        t_safe = torch.where(has_hit, t, 4.0 * dist)
        u_safe = torch.where(has_hit, u, -1.0)
        v_safe = torch.where(has_hit, v, -1.0)
        edge_margin = torch.minimum(torch.minimum(u_safe, v_safe), 1.0 - u_safe - v_safe)
        edge = torch.sigmoid((2.0 * beta * edge_margin).clamp(-30.0, 30.0))
        depth = torch.sigmoid((beta * (1.0 - t_safe / dist)).clamp(-30.0, 30.0))
        return torch.where(has_hit, edge * depth, 0.0)

    return occluded


def make_hard_occluded_diff(occluded_fn):
    """Hard (reference) visibility on the differentiable path: the any-hit
    tracer on detached inputs, a step function with no gradient."""

    def occluded(o: Vec3, d: Vec3, max_dist2: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return occluded_fn(_detach(o), _detach(d), max_dist2.detach())

    return occluded


def trace_rays_diff(ds, closest_fn, occluded_fn, o: Vec3, d: Vec3, bounces: int,
                    soft_shadows: bool = False, beta: float = 25.0,
                    reverse_shadows: bool = False) -> Vec3:
    """The differentiable bounce loop (diff.py:248-281): ops/shade.trace_rays
    with make_diff_closest and the chosen visibility. closest_fn and
    occluded_fn may be per-bounce sequences. reverse_shadows (light -> hit
    point) applies to the hard visibility only, where occlusion of a segment
    is symmetric; the soft model's depth factor is not, so soft_shadows
    always traces hit -> light."""
    cfs = list(closest_fn) if isinstance(closest_fn, (list, tuple)) else [closest_fn]
    ofs = list(occluded_fn) if isinstance(occluded_fn, (list, tuple)) else [occluded_fn]
    diff_closest = [make_diff_closest(ds, c) for c in cfs]
    if soft_shadows:
        occ = [make_soft_occluded(ds, c, beta=beta) for c in cfs]
        reverse_shadows = False
    else:
        occ = [make_hard_occluded_diff(f) for f in ofs]
    return trace_rays(ds, diff_closest, occ, o, d, bounces, reverse_shadows=reverse_shadows)

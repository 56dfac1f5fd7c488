"""Differentiable rendering in the port (ops/diff.py) against finite
differences and against the JAX package's gradients.

The port's counterparts of tests/test_diff.py, with its scenes (tiny_scene
at 32x32), its loss and its tolerances: the forward against trace_rays
(atol 1e-5); the kd, light and interior vertex gradients against central
finite differences (rtol 2e-2, 2e-2, 5e-3); soft against hard shadows; the
occluder gradient present only with soft shadows, and finite; the diff path
through the port's make_tracer against brute force (atol and rtol 2e-3),
on the CPU through the kernels' plain versions with `attr`, at width 4 with
f32 and bf16 boxes, with the C-matrix table (the plain MXU versions), and
at width 2; kd by finite difference with the attr rows repacked; through
the packet traversal (ops/trace_bvh.make_tracer) against brute force
(tests/test_diff.py:284-310: the loss within 1e-3, the vertex gradients
within atol and rtol 1e-3). Also
tests/test_spheres.py's sphere-radius gradient (finite, nonzero, and
dt/dr = -1 on the ray through the centre).

Against JAX: the same scene, rays, parameters and target through JAX's
diff.trace_rays_diff and the port's, over JAX's brute-force tracer and the
port's; the loss within 1e-5 relative and the gradients with respect to
the vertices, materials, lights and spheres within rtol 1e-3, atol 1e-4.
One case goes through JAX's Pallas make_tracer in interpret mode (with
attr) against the port's make_tracer, cached at module scope.

Also: build_device_scene keeps tensor inputs in the graph and gives the
numpy inputs' planes bit for bit; the port's trace_rays with its default
arguments, and with a two-element per-bounce list, against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_brute import SPHERE_SCENE
from parallel_ray_tracer_tpu.models.camera import default_camera as j_default_camera
from parallel_ray_tracer_tpu.models.camera import ray_basis as j_ray_basis
from parallel_ray_tracer_tpu.models.device_scene import build_device_scene as j_build
from parallel_ray_tracer_tpu.ops import diff as j_diff
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops import shade as j_shade
from parallel_ray_tracer_tpu.ops import trace_brute as j_brute
from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled as j_rays_tiled
from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as JVec3
from parallel_ray_tracer_tpu_torch import pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig
from parallel_ray_tracer_tpu_torch.models.camera import default_camera, ray_basis
from parallel_ray_tracer_tpu_torch.models.device_scene import build_device_scene
from parallel_ray_tracer_tpu_torch.ops import cuda_trace, diff, shade, trace_brute, trace_bvh
from parallel_ray_tracer_tpu_torch.ops.bvh import build_bvh
from parallel_ray_tracer_tpu_torch.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu_torch.ops.intersect import ray_sphere
from parallel_ray_tracer_tpu_torch.ops.pack import pack_attr
from parallel_ray_tracer_tpu_torch.ops.render import generate_rays_tiled
from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

SIZE = 32
ARRAY_KEYS = ("faces", "mat_idx", "mats_kd", "mats_ks", "mats_kr", "lights_pos", "lights_kl")


def _arrays(scene) -> dict:
    return {k: getattr(scene, k) for k in ARRAY_KEYS}


def _rays():
    o, d = generate_rays_tiled(ray_basis(default_camera(), SIZE, SIZE), SIZE, SIZE, SIZE, SIZE,
                               device="cpu")
    return o, d


def _j_rays():
    basis = tuple(jnp.asarray(a) for a in j_ray_basis(j_default_camera(), SIZE, SIZE))
    return j_rays_tiled(basis, SIZE, SIZE, SIZE, SIZE)


def _t(a):
    """A JAX array or numpy array as a CPU tensor, value for value."""
    return torch.tensor(np.asarray(a))


def _tvec(v) -> Vec3:
    return Vec3(*(_t(p) for p in v))


def _render(verts, arrs, o, d, bounces=2, soft=False, **over):
    kw = dict(arrs)
    kw.update(over)
    ds = build_device_scene(verts, **kw, device="cpu")
    closest_fn, occluded_fn = trace_brute.make_tracer(ds)
    col = diff.trace_rays_diff(ds, closest_fn, occluded_fn, o, d, bounces, soft_shadows=soft)
    return col.stack(-1)


def _grad(f, x):
    x = torch.as_tensor(np.asarray(x, np.float32)).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x)
    return g


def _fd(f, x0, idx, h):
    e = np.zeros_like(np.asarray(x0, np.float32))
    e[idx] = h
    with torch.no_grad():
        return (float(f(torch.as_tensor(x0 + e))) - float(f(torch.as_tensor(x0 - e)))) / (2 * h)


# ---- tests/test_diff.py, TestDiffClosest and TestSoftShadows ------------------


def test_forward_matches_tracer(tiny_scene):
    arrs, o, d = _arrays(tiny_scene), *_rays()
    img = _render(torch.as_tensor(tiny_scene.verts), arrs, o, d)
    ds = build_device_scene(tiny_scene.verts, **arrs, device="cpu")
    col = shade.trace_rays(ds, *trace_brute.make_tracer(ds), o, d, 2)
    np.testing.assert_allclose(img.detach().numpy(), col.stack(-1).numpy(), atol=1e-5)


def test_material_gradient_matches_fd(tiny_scene):
    arrs, o, d = _arrays(tiny_scene), *_rays()
    verts = torch.as_tensor(tiny_scene.verts)

    def loss(kd):
        return _render(verts, arrs, o, d, mats_kd=kd).sum()

    kd0 = np.asarray(tiny_scene.mats_kd, np.float32)
    g = _grad(loss, kd0)
    for i, c in [(0, 0), (1, 1), (2, 2)]:
        assert np.isfinite(float(g[i, c]))
        np.testing.assert_allclose(float(g[i, c]), _fd(loss, kd0, (i, c), 1e-3), rtol=2e-2)


def test_light_gradient_matches_fd(tiny_scene):
    arrs, o, d = _arrays(tiny_scene), *_rays()
    verts = torch.as_tensor(tiny_scene.verts)

    def loss(kl):
        return _render(verts, arrs, o, d, lights_kl=kl).sum()

    kl0 = np.asarray(tiny_scene.lights_kl, np.float32)
    g = _grad(loss, kl0)
    np.testing.assert_allclose(float(g[0, 0]), _fd(loss, kl0, (0, 0), 1e-2), rtol=2e-2)


def test_vertex_gradient_matches_fd_interior(tiny_scene):
    """Floor vertices' z against FD on pixels away from silhouettes and
    shadow edges (tests/test_diff.py:101-134)."""
    arrs, o, d = _arrays(tiny_scene), *_rays()
    verts0 = np.asarray(tiny_scene.verts, np.float32)
    ds0 = build_device_scene(verts0, **arrs, device="cpu")
    idx_img = trace_brute.make_tracer(ds0)[0](o, d).idx.numpy().reshape(SIZE, SIZE)
    same = np.ones((SIZE, SIZE), bool)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (2, 0)):
        same &= idx_img == np.roll(idx_img, (dy, dx), (0, 1))
    mask = torch.as_tensor((same & (idx_img == 0)).reshape(-1), dtype=torch.float32)

    def loss(verts):
        return (_render(verts, arrs, o, d, bounces=1).sum(-1) * mask).sum()

    g = _grad(loss, verts0)
    for vi, c in [(0, 2), (1, 2), (2, 2)]:
        fd = _fd(loss, verts0, (vi, c), 2e-3)
        assert abs(fd) > 1.0, f"FD direction ({vi},{c}) uninformative"
        np.testing.assert_allclose(float(g[vi, c]), fd, rtol=5e-3)


def test_soft_matches_hard_away_from_edges(tiny_scene):
    arrs, o, d = _arrays(tiny_scene), *_rays()
    verts = torch.as_tensor(tiny_scene.verts)
    hard = _render(verts, arrs, o, d).numpy()
    soft = _render(verts, arrs, o, d, soft=True).numpy()
    assert np.isclose(hard, soft, atol=5e-2).mean() > 0.9


def test_occluder_gradient_nonzero_only_when_soft(tiny_scene):
    arrs, o, d = _arrays(tiny_scene), *_rays()
    verts0 = np.asarray(tiny_scene.verts, np.float32)
    g_soft = _grad(lambda v: _render(v, arrs, o, d, bounces=1, soft=True).sum(), verts0)
    g_hard = _grad(lambda v: _render(v, arrs, o, d, bounces=1, soft=False).sum(), verts0)
    assert torch.isfinite(g_soft).all() and torch.isfinite(g_hard).all()
    assert float((g_soft[4:7] - g_hard[4:7]).abs().sum()) > 0.0


# ---- through the port's make_tracer (TestDiffWithPallasTracer) -----------------

TRACER_CASES = {"w4": {}, "w4_bf16": dict(bf16_bvh=True), "w4_cmat": dict(mxu_leaf=True),
                "w2": dict(bvh_width=2)}


def _prepare(scene, **kw):
    cfg = dict(width=SIZE, height=SIZE, bvh_heuristic=6, use_native=False, mxu_leaf=False)
    cfg.update(kw)
    return pipeline.prepare(RenderConfig(**cfg), scene=scene, device="cpu")


def _loss_tracer(pipe, arrs, o, d, tables=None, bounces=2):
    T = tables or pipe.tables

    def loss(verts, **over):
        kw = dict(arrs)
        kw.update(over)
        ds = build_device_scene(verts, **kw, slot_map=pipe.flat.slot_map, device="cpu")
        closest_fn, occluded_fn = cuda_trace.make_tracer(
            T.packed_dev, T.leaf_size, ds=ds, stack_depth=T.stack_depth,
            compressed=T.compressed, dual=True)
        col = diff.trace_rays_diff(ds, closest_fn, occluded_fn, o, d, bounces)
        # summed in f64: in f32 the sum's rounding (about 0.05 at h = 1e-3)
        # is 9% of the occluder material's 0.6, which only a few pixels see
        return col.stack(-1).double().sum()

    return loss


@pytest.mark.parametrize("case", list(TRACER_CASES))
def test_tracer_gradients_match_brute(tiny_scene, case):
    pipe = _prepare(tiny_scene, **TRACER_CASES[case])
    assert (pipe.tables.cmat is not None) == (case == "w4_cmat")
    arrs, o, d = _arrays(tiny_scene), *_rays()
    verts0 = np.asarray(tiny_scene.verts, np.float32)
    loss_p = _loss_tracer(pipe, arrs, o, d)

    def loss_b(verts):
        return _render(verts, arrs, o, d).sum()

    with torch.no_grad():
        lp, lb = float(loss_p(torch.as_tensor(verts0))), float(loss_b(torch.as_tensor(verts0)))
    assert abs(lp - lb) < 1e-2 * max(1.0, abs(lb))
    np.testing.assert_allclose(_grad(loss_p, verts0).numpy(), _grad(loss_b, verts0).numpy(),
                               atol=2e-3, rtol=2e-3)


def test_bvh_gradients_match_brute(tiny_scene):
    """The differentiable wrapper gives the brute-force gradients whichever
    tracer supplies the topology: here the packet traversal, one packet of
    1,024 rays (tests/test_diff.py:284-310)."""
    arrs, (o, d) = _arrays(tiny_scene), _rays()
    tv = tiny_scene.triangle_vertices()
    flat = flatten_bvh(build_bvh(tv, heuristic=6, leaf_threshold=8), tv, leaf_size=8)
    dbvh, L, depth = trace_bvh.device_bvh_from_flat(flat, device="cpu")
    verts0 = np.asarray(tiny_scene.verts, np.float32)

    def loss_bvh(verts):
        ds = build_device_scene(verts, **arrs, slot_map=flat.slot_map, device="cpu")
        closest_fn, occluded_fn = trace_bvh.make_tracer(dbvh, ds, L, depth, packet=1024)
        return diff.trace_rays_diff(ds, closest_fn, occluded_fn, o, d, 2).stack(-1).sum()

    def loss_brute(verts):
        return _render(verts, arrs, o, d).sum()

    with torch.no_grad():
        lb, lr = (float(f(torch.as_tensor(verts0))) for f in (loss_bvh, loss_brute))
    assert abs(lb - lr) < 1e-3
    g_bvh, g_brute = _grad(loss_bvh, verts0).numpy(), _grad(loss_brute, verts0).numpy()
    assert np.abs(g_brute).max() > 1.0     # non-vacuous
    np.testing.assert_allclose(g_bvh, g_brute, atol=1e-3, rtol=1e-3)


def test_tracer_material_gradient_matches_fd(tiny_scene):
    """The scatter-backed resolve's gradient against FD whose evaluation
    repacks the attr rows from the perturbed table (tests/test_diff.py:
    239-283)."""
    pipe = _prepare(tiny_scene)
    arrs, o, d = _arrays(tiny_scene), *_rays()
    verts = torch.as_tensor(tiny_scene.verts)
    kd0 = np.asarray(tiny_scene.mats_kd, np.float32)
    loss0 = _loss_tracer(pipe, arrs, o, d)

    def loss_with_kd(kd):
        attr = pack_attr(pipe.flat, tiny_scene.mat_idx, kd.numpy(), tiny_scene.mats_ks,
                         tiny_scene.mats_kr)
        tables = pipe.tables._replace(attr=torch.as_tensor(attr))
        return _loss_tracer(pipe, arrs, o, d, tables)(verts, mats_kd=kd)

    gkd = _grad(lambda kd: loss0(verts, mats_kd=kd), kd0)
    for i, c in [(0, 0), (1, 1), (2, 2)]:
        fd = _fd(loss_with_kd, kd0, (i, c), 1e-3)
        assert abs(fd) > 0.3, "uninformative FD direction"
        np.testing.assert_allclose(float(gkd[i, c]), fd, rtol=2e-2)


# ---- tests/test_spheres.py::test_sphere_gradients ------------------------------


def test_sphere_gradients():
    sc = SPHERE_SCENE
    o, d = _rays()
    arrs = {k: sc[k] for k in ARRAY_KEYS}

    def loss(radius):
        ds = build_device_scene(sc["verts"], **arrs, spheres_center=sc["spheres_center"],
                                spheres_radius=radius, spheres_mat=sc["spheres_mat"],
                                device="cpu")
        col = diff.trace_rays_diff(ds, *trace_brute.make_tracer(ds), o, d, 1)
        return (col.x + col.y + col.z).sum()

    g = _grad(loss, sc["spheres_radius"])
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0.0

    def t_of_r(r):
        def s(x):
            return torch.tensor(x, dtype=torch.float32)
        return ray_sphere(Vec3(s(0), s(-5), s(1)), Vec3(s(0), s(1), s(0)),
                          Vec3(s(0), s(0), s(1)), r).t

    r = torch.tensor(0.5, requires_grad=True)
    t = t_of_r(r)
    assert abs(t.item() - 4.5) < 1e-5
    (dt_dr,) = torch.autograd.grad(t, r)
    assert abs(float(dt_dr) + 1.0) < 1e-5


# ---- against the JAX package's gradients ---------------------------------------

# Parameters differentiated in both packages, by build_device_scene keyword.
PARAMS = ("verts", "mats_kd", "mats_ks", "lights_pos", "lights_kl")
SPHERE_PARAMS = ("spheres_radius",)


def _scene_params(scene_name, tiny_scene):
    """(params, fixed): the differentiated arrays and the rest."""
    src = SPHERE_SCENE if scene_name == "spheres" else {
        k: getattr(tiny_scene, k) for k in ("verts",) + ARRAY_KEYS}
    names = PARAMS + (SPHERE_PARAMS if scene_name == "spheres" else ())
    params = {k: np.asarray(src[k], np.float32) for k in names}
    fixed = {k: src[k] for k in ARRAY_KEYS if k not in names}
    if scene_name == "spheres":
        fixed.update(spheres_center=src["spheres_center"], spheres_mat=src["spheres_mat"])
    return params, fixed


def _target(seed=7):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (SIZE * SIZE, 3)).astype(np.float32)


def _j_loss(params, fixed, o, d, target, tracer, soft, bounces=2):
    def loss(p):
        ds = j_build(**p, **fixed)
        cf, of = tracer(ds)
        col = j_diff.trace_rays_diff(ds, cf, of, o, d, bounces, soft_shadows=soft)
        img = jnp.stack([col.x, col.y, col.z], axis=-1).clip(0.0, 1.0)
        return jnp.sum((img - target) ** 2) / target.size

    p = {k: jnp.asarray(v) for k, v in params.items()}
    val, g = jax.jit(jax.value_and_grad(loss))(p)
    return float(val), {k: np.asarray(v) for k, v in g.items()}


def _t_loss(params, fixed, o, d, target, tracer, soft, bounces=2):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    ds = build_device_scene(**p, **fixed, device="cpu")
    cf, of = tracer(ds)
    col = diff.trace_rays_diff(ds, cf, of, o, d, bounces, soft_shadows=soft)
    loss = ((col.stack(-1).clamp(0.0, 1.0) - torch.as_tensor(target)) ** 2).sum() / target.size
    g = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), {k: v.numpy() for k, v in zip(p, g)}


def _assert_grads(jl, jg, tl, tg):
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    for k in jg:
        assert np.isfinite(tg[k]).all(), k
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-3, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("scene_name,soft,bounces", [
    ("tiny", False, 2), ("tiny", True, 2), ("spheres", False, 1)])
def test_gradients_match_jax_brute(tiny_scene, scene_name, soft, bounces):
    """The sphere case takes one bounce, as tests/test_spheres.py does: from
    the second bounce on, JAX's sphere gradients are NaN (see
    test_sphere_gradients_finite_past_the_first_bounce)."""
    params, fixed = _scene_params(scene_name, tiny_scene)
    jo, jd = _j_rays()
    target = _target()
    jl, jg = _j_loss(params, fixed, jo, jd, target, j_brute.make_tracer, soft, bounces)
    tl, tg = _t_loss(params, fixed, _tvec(jo), _tvec(jd), target, trace_brute.make_tracer, soft,
                     bounces)
    assert jl > 0.01  # non-vacuous
    _assert_grads(jl, jg, tl, tg)


def test_sphere_gradients_finite_past_the_first_bounce():
    """At two bounces the port's sphere gradients stay finite and keep
    JAX's values where JAX's are finite. JAX's are NaN for the sphere that
    clip(idx - T, 0, S - 1) gives the non-sphere lanes (sphere 0): a lane
    dead after the first bounce has origin 1e30 and direction 0, so the
    recompute's |o - c|^2 overflows to inf and its disc is 0 * inf = NaN;
    the cotangent 0 reaches it through jnp.maximum(disc, 1e-30), whose
    derivative at NaN is NaN. torch.clamp passes no gradient where its
    input is NaN, so the dead lanes add nothing, as they should."""
    params, fixed = _scene_params("spheres", None)
    jo, jd = _j_rays()
    target = _target()
    params["spheres_center"] = np.asarray(fixed.pop("spheres_center"), np.float32)
    jl, jg = _j_loss(params, fixed, jo, jd, target, j_brute.make_tracer, False, 2)
    tl, tg = _t_loss(params, fixed, _tvec(jo), _tvec(jd), target, trace_brute.make_tracer, False,
                     2)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    for k in ("spheres_center", "spheres_radius"):
        assert np.isfinite(tg[k]).all(), k
        assert np.isnan(jg[k][0]).all() and np.isfinite(jg[k][1:]).all(), k
        np.testing.assert_allclose(tg[k][1:], jg[k][1:], rtol=1e-3, atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def jax_pallas_case(tiny_scene):
    """JAX's gradients through its Pallas make_tracer (interpret mode, with
    attr) on tiny_scene, one bounce (one interpret compile of each kernel),
    once per module: (pipe, params, fixed, rays, loss, grads)."""
    pipe = _prepare(tiny_scene)
    T = pipe.tables
    packed = tuple(jnp.asarray(t.numpy()) for t in T.packed_dev)
    params, fixed = _scene_params("tiny", tiny_scene)
    fixed["slot_map"] = pipe.flat.slot_map
    jo, jd = _j_rays()

    def tracer(ds):
        return j_pt.make_tracer(packed, T.leaf_size, interpret=True, ds=ds, dual=True,
                                stack_depth=j_pt.required_stack_depth(pipe.flat.depth, 4))

    jl, jg = _j_loss(params, fixed, jo, jd, _target(), tracer, False, bounces=1)
    return pipe, params, fixed, (jo, jd), jl, jg


def test_gradients_match_jax_pallas(jax_pallas_case):
    pipe, params, fixed, (jo, jd), jl, jg = jax_pallas_case
    T = pipe.tables

    def tracer(ds):
        return cuda_trace.make_tracer(T.packed_dev, T.leaf_size, ds=ds, dual=True,
                                      stack_depth=T.stack_depth)

    tl, tg = _t_loss(params, fixed, _tvec(jo), _tvec(jd), _target(), tracer, False, bounces=1)
    assert jl > 0.01
    _assert_grads(jl, jg, tl, tg)


# ---- build_device_scene ---------------------------------------------------------


def test_device_scene_tensor_inputs_keep_graph(tiny_scene):
    """Tensor inputs give the numpy inputs' planes bit for bit, and stay in
    the autograd graph (n0, the material, light and sphere planes)."""
    sc = SPHERE_SCENE
    keys = ("verts", "mats_kd", "mats_ks", "mats_kr", "lights_pos", "lights_kl",
            "spheres_center", "spheres_radius")
    rest = {k: sc[k] for k in ("faces", "mat_idx", "spheres_mat")}
    ds_np = build_device_scene(**{k: sc[k] for k in keys}, **rest, device="cpu")
    p = {k: torch.tensor(np.asarray(sc[k], np.float32), requires_grad=True) for k in keys}
    ds_t = build_device_scene(**p, **rest, device="cpu")
    for name, a, b in zip(ds_np._fields, ds_np, ds_t):
        for x, y in zip(*((a, b) if isinstance(a, Vec3) else ((a,), (b,)))):
            assert x.dtype == y.dtype and torch.equal(x, y.detach()), name
    total = (sum(c.sum() for c in ds_t.n0) + sum(c.sum() for c in ds_t.kd)
             + ds_t.lamb.sum() + sum(c.sum() for c in ds_t.sph_c) + ds_t.sph_r.sum()
             + ds_t.ks.x.sum() + ds_t.kr.y.sum())
    grads = torch.autograd.grad(total, list(p.values()), allow_unused=True)
    for k, g in zip(p, grads):
        assert g is not None and torch.isfinite(g).all(), k
    # numpy inputs: the planes as they were built before tensors were
    # taken, the light table through numpy
    assert not ds_np.lamb.requires_grad
    np.testing.assert_array_equal(
        ds_np.lamb.numpy(), np.asarray(j_pt.pack_lights(j_build(**{k: sc[k] for k in keys},
                                                                 **rest))))


# ---- the trace_rays repair -------------------------------------------------------


def _tiny_pair(tiny_scene):
    arrs = _arrays(tiny_scene)
    jds = j_build(jnp.asarray(tiny_scene.verts), **arrs)
    tds = build_device_scene(tiny_scene.verts, **arrs, device="cpu")
    return jds, tds


def test_trace_rays_defaults_match_jax(tiny_scene):
    """Default arguments: shadow rays from the hit point (reverse_shadows=
    False), as JAX's trace_rays."""
    jds, tds = _tiny_pair(tiny_scene)
    jo, jd = _j_rays()
    ref = j_shade.trace_rays(jds, *j_brute.make_tracer(jds), jo, jd, 2)
    col = shade.trace_rays(tds, *trace_brute.make_tracer(tds), _tvec(jo), _tvec(jd), 2)
    fwd = shade.trace_rays(tds, *trace_brute.make_tracer(tds), _tvec(jo), _tvec(jd), 2,
                           reverse_shadows=False)
    assert all(torch.equal(a, b) for a, b in zip(col, fwd))
    np.testing.assert_allclose(col.stack(-1).numpy(),
                               np.stack([np.asarray(c) for c in ref], -1), atol=1e-5)


def test_trace_rays_per_bounce_list_matches_jax(tiny_scene):
    """A two-element per-bounce list: entry 0 traces bounce 0, entry 1 the
    remaining bounces, in both packages."""
    jds, tds = _tiny_pair(tiny_scene)
    jo, jd = _j_rays()
    calls = []

    def counted(fn, tag):
        def wrapped(*a):
            calls.append(tag)
            return fn(*a)
        return wrapped

    jc, joc = j_brute.make_tracer(jds)
    tc, toc = trace_brute.make_tracer(tds)
    # the second entry's visibility is the closest-hit one, so the list
    # changes the schedule and not only the bookkeeping
    j_lists = ([jc, jc], [joc, j_shade.occluded_from_closest(jc)])
    t_lists = ([counted(tc, "c0"), counted(tc, "c1")],
               [counted(toc, "o0"), counted(shade.occluded_from_closest(tc), "o1")])
    ref = j_shade.trace_rays(jds, *j_lists, jo, jd, 3, reverse_shadows=True)
    col = shade.trace_rays(tds, *t_lists, _tvec(jo), _tvec(jd), 3, reverse_shadows=True)
    assert calls == ["c0", "o0", "c1", "o1", "c1", "o1"]
    np.testing.assert_allclose(col.stack(-1).numpy(),
                               np.stack([np.asarray(c) for c in ref], -1), atol=1e-5)

"""Spheres in the port against the JAX package.

- ray_sphere on 4,096 rays: origins inside spheres, zero directions, grazing
  rays and misses (t within atol 1e-5, inside flags equal).
- The DeviceScene: every plane of device_scene_from_host(scene, slot_map=...)
  and of convert.device_scene_from_numpy(JAX's DeviceScene) against JAX's
  on car_boxed's first 2,000 triangles and on the blocker cloud with
  spheres. Built from the host, the planes equal those of JAX's assembly
  run op by op (jax.disable_jit); the jitted assembly lets XLA contract
  the normal's arithmetic, so against it n0 is held within atol 1e-6.
- pack_spheres, override_attrs and surface_frame against JAX's, exactly.
- The pass-based sphere hits through wrap_tracer on one 1,024-ray packet,
  idx included (a sphere's idx is T + s with T = len(slot_map)).
- Frames on the blocker cloud with spheres, 32x32, bounces 1 and 3: the
  port's render("auto" = "fused") and render("pallas") on the CPU against
  JAX's render("fused", interpret=True), and against each other; the
  spheres change the image; bf16 boxes and streamed leaf rows (1 bounce)
  against the same JAX frame.

Bounds: hits as tests/test_torch_trace.py (miss masks equal, t within atol
1e-4 / rtol 1e-5, idx agreement >= 0.999); frames as tests/test_fused.py
(more than 99% of pixels within 1e-3, median below 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from test_torch_frame import _assert_close
from test_torch_trace import _assert_hits
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.device_scene import device_scene_from_host as j_dsfh
from parallel_ray_tracer_tpu.models.scene import load_scene_npz
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops import trace_brute as j_brute
from parallel_ray_tracer_tpu.ops.bvh import build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu.ops.intersect import ray_sphere as j_ray_sphere
from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as JVec3
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.convert import device_scene_from_numpy, packed_from_numpy
from parallel_ray_tracer_tpu_torch.models.device_scene import device_scene_from_host
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.ops.intersect import T_MAX, ray_sphere
from parallel_ray_tracer_tpu_torch.ops.pack import pack_spheres
from parallel_ray_tracer_tpu_torch.ops.spheres import wrap_tracer
from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3 as TVec3
from parallel_ray_tracer_tpu_torch.models.scene import load_scene_npz as t_load_npz

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REF = dict(use_native=False, mxu_leaf=False)
FRAME = dict(width=32, height=32, bvh_heuristic=6, tile_rows=32, tile_cols=32, **REF)


def _j(planes):
    return JVec3(*(jnp.asarray(p) for p in planes))


def _t(planes):
    return TVec3(*(torch.as_tensor(np.ascontiguousarray(p)) for p in planes))


# ---- ray_sphere ------------------------------------------------------------


def test_ray_sphere_as_jax():
    """4,096 rays against 4,096 spheres, a quarter each: origins inside,
    zero directions, grazing rays (impact parameter 0.999 r) and random rays
    (mostly misses). Both sides evaluate op by op (JAX eagerly)."""
    rng = np.random.RandomState(0)
    n = 4096
    c = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    r = rng.uniform(0.2, 1.5, n).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    q = n // 4
    o[:q] = c[:q] + d[:q] * (0.5 * r[:q, None])              # inside
    d[q:2 * q] = 0.0                                          # dead lanes
    side = np.cross(d[2 * q:3 * q], rng.normal(size=(q, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    o[2 * q:3 * q] = (c[2 * q:3 * q] + side * (0.999 * r[2 * q:3 * q, None])
                      - d[2 * q:3 * q] * 5.0)                 # grazing
    d[3 * q:] *= rng.uniform(0.5, 2.0, (q, 1)).astype(np.float32)  # |d| != 1

    jh = j_ray_sphere(_j(o.T), _j(d.T), _j(c.T), jnp.asarray(r))
    th = ray_sphere(_t(o.T), _t(d.T), _t(c.T), torch.as_tensor(r))
    jt, tt = np.asarray(jh.t), th.t.numpy()
    assert np.array_equal(jt >= T_MAX, tt >= T_MAX)
    hit = tt < T_MAX
    assert hit[:q].all() and not hit[q:2 * q].any() and hit[2 * q:3 * q].all()
    np.testing.assert_allclose(tt[hit], jt[hit], atol=1e-5, rtol=0)
    assert np.array_equal(np.asarray(jh.inside), th.inside.numpy())
    assert th.inside[:q].all()


# ---- the DeviceScene ---------------------------------------------------------


def _car_2k(load):
    sc = load("assets/car_boxed.npz")
    return dataclasses.replace(sc, faces=sc.faces[:2000], mat_idx=sc.mat_idx[:2000])


@pytest.fixture(scope="module", params=["car_boxed_2k", "blocker_spheres"])
def scenes(request):
    """(JAX scene, port scene, slot_map): the same arrays loaded by each
    package, and the flattened BVH's slot layout."""
    if request.param == "car_boxed_2k":
        jsc, tsc = _car_2k(load_scene_npz), _car_2k(t_load_npz)
    else:
        jsc = tsc = blocker_cloud_scene(with_spheres=True)
    tv = jsc.triangle_vertices()
    flat = flatten_bvh(build_bvh(tv, heuristic=6, leaf_threshold=8), tv, leaf_size=8)
    return jsc, tsc, flat.slot_map


def _planes(ds):
    """Field name -> list of numpy planes."""
    out = {}
    for name in ("v0", "v1", "v2", "n0", "mat_idx", "kd", "ks", "kr",
                 "lights_pos", "lights_kl", "ambient", "sph_c", "sph_r", "sph_mat"):
        v = getattr(ds, name)
        out[name] = [np.asarray(p) for p in v] if isinstance(v, tuple) else [np.asarray(v)]
    return out


@pytest.mark.parametrize("how", ["from_host", "from_numpy"])
def test_device_scene_as_jax(scenes, how):
    jsc, tsc, slot_map = scenes
    jds = j_dsfh(jsc, slot_map=slot_map)
    if how == "from_host":
        tds = device_scene_from_host(tsc, slot_map=slot_map, device="cpu")
        with jax.disable_jit():   # JAX's arithmetic, op by op
            want = _planes(j_dsfh(jsc, slot_map=slot_map))
        # the jitted assembly: XLA contracts the normal's arithmetic
        for a, b in zip(_planes(jds)["n0"], _planes(tds)["n0"]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    else:
        tds = device_scene_from_numpy(jds, device="cpu")
        want = _planes(jds)
    got = _planes(tds)
    for name, planes in want.items():
        for a, b in zip(planes, got[name]):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tds.num_triangles == len(slot_map) == jds.num_triangles
    assert tds.num_spheres == jsc.num_spheres and tds.num_lights == jds.num_lights
    np.testing.assert_array_equal(tds.lamb.numpy(), np.asarray(j_pt.pack_lights(jds)))


def test_pack_spheres_as_jax():
    sc = blocker_cloud_scene(with_spheres=True)
    want = np.asarray(j_pt.pack_spheres(j_dsfh(sc)))
    got = pack_spheres(sc.spheres_center, sc.spheres_radius, sc.spheres_mat,
                       sc.mats_kd, sc.mats_ks, sc.mats_kr)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert pack_spheres(np.zeros((0, 3)), np.zeros(0), np.zeros(0), sc.mats_kd,
                        sc.mats_ks, sc.mats_kr) is None


def test_override_attrs_as_jax():
    """override_attrs (one gather per plane here, one masked pass per sphere
    in JAX) and surface_frame give JAX's values to the bit, on 4,096 lanes
    of triangle hits, sphere hits and misses."""
    from parallel_ray_tracer_tpu.ops import spheres as j_spheres
    from parallel_ray_tracer_tpu.ops.trace_brute import Hit as JHit
    from parallel_ray_tracer_tpu_torch.ops import spheres as t_spheres
    from parallel_ray_tracer_tpu_torch.ops.trace_plain import Hit as THit

    sc = blocker_cloud_scene(with_spheres=True)
    jds = j_dsfh(sc)
    tds = device_scene_from_numpy(jds, device="cpu")
    rng = np.random.RandomState(4)
    n, T, S = 4096, tds.num_triangles, tds.num_spheres
    idx = rng.randint(-1, T + S, n).astype(np.int32)
    planes = [rng.normal(size=(3, n)).astype(np.float32) for _ in range(5)]
    mat = rng.randint(0, 3, n).astype(np.int32)
    jout = j_spheres.override_attrs(jds, JHit(t=None, idx=jnp.asarray(idx), norm_dir=None),
                                    *(_j(p) for p in planes))
    tout = t_spheres.override_attrs(tds, THit(t=None, idx=torch.as_tensor(idx), norm_dir=None),
                                    *(_t(p) for p in planes))
    for a, b in zip(jout, tout):
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), y.numpy())
    jn, jm = j_spheres.surface_frame(jds, JHit(t=None, idx=jnp.asarray(idx), norm_dir=None),
                                     _j(planes[0]), _j(planes[1]), jnp.asarray(mat))
    tn, tm = t_spheres.surface_frame(tds, THit(t=None, idx=torch.as_tensor(idx), norm_dir=None),
                                     _t(planes[0]), _t(planes[1]), torch.as_tensor(mat))
    assert all(np.array_equal(np.asarray(x), y.numpy()) for x, y in zip(jn, tn))
    assert np.array_equal(np.asarray(jm), tm.numpy())


# ---- the pass-based sphere hits ----------------------------------------------


def test_wrap_tracer_hits_as_jax():
    """One 1,024-ray packet (the 32x32 frame's primary rays) through the
    port's wrap_tracer around its closest-hit and any-hit entry points,
    against JAX's wrap_tracer around its brute-force tracer on the same
    slot-ordered scene. idx agrees on every sphere hit: T + s in both."""
    sc = blocker_cloud_scene(with_spheres=True)
    tp = t_pipeline.prepare(TConfig(**FRAME), scene=sc, device="cpu")
    jds = j_dsfh(sc, slot_map=tp.flat.slot_map)
    T = tp.tables
    o, d = t_pipeline.render_ops._tiled_planes(tp.camera(), 32, 32, 32, 32, "cpu")

    def closest(o, d):
        return cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, o, d, leaf_size=8)

    def occluded(o, d, m2):
        return cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, o, d, m2, leaf_size=8)

    t_closest, t_occluded = wrap_tracer(tp.ds, closest, occluded)
    j_closest, j_occluded = j_brute.make_tracer(jds)
    th = t_closest(o, d)
    jh = j_closest(_j([p.reshape(-1).numpy() for p in o]),
                   _j([p.reshape(-1).numpy() for p in d]))
    nt = tp.ds.num_triangles
    assert nt == len(tp.flat.slot_map) != T.tri.shape[0] * 8
    on_sphere = th.idx.reshape(-1).numpy() >= nt
    assert 0.05 < on_sphere.mean() < 0.95
    same = _assert_hits(jh.t, jh.idx, th.t.reshape(-1).numpy(), th.idx.reshape(-1).numpy())
    assert same[on_sphere].all()
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.reshape(-1).numpy()[same]).all()

    # shadow rays from the light toward the hit points, through both
    lp = np.asarray(sc.lights_pos[0], np.float32)
    ok = th.idx >= 0
    p = o + d * torch.where(ok, th.t, 1.0)
    lv = TVec3(*(float(c) - q for c, q in zip(lp, p)))
    mag = torch.sqrt(lv.mag2())
    so = TVec3(*(torch.full_like(mag, float(c)) for c in lp))
    sd = TVec3(*(-c / mag for c in lv))
    m2 = (mag - 1e-3).clamp(min=0.0) ** 2
    tb = t_occluded(so, sd, m2).reshape(-1).numpy()
    jb = np.asarray(j_occluded(_j([q.reshape(-1).numpy() for q in so]),
                               _j([q.reshape(-1).numpy() for q in sd]),
                               jnp.asarray(m2.reshape(-1).numpy())))
    assert (tb == jb).mean() >= 0.999 and 0.0 < tb.mean() < 1.0


# ---- frames ------------------------------------------------------------------

_JAX_FRAMES = {}


def _jax_fused(bounces):
    """JAX's fused frame of the blocker cloud with spheres, interpret mode,
    one render per bounce count for the module."""
    if bounces not in _JAX_FRAMES:
        jp = j_pipeline.prepare(JConfig(**FRAME, bounces=bounces),
                                scene=blocker_cloud_scene(with_spheres=True))
        assert jp.resolved_variant("auto") == "fused"
        _JAX_FRAMES[bounces] = np.asarray(jp.render(variant="fused", interpret=True))
    return _JAX_FRAMES[bounces]


@pytest.mark.parametrize("bounces", [1, 3])
def test_sphere_frames_as_jax(bounces):
    ref = _jax_fused(bounces)
    cfg = TConfig(**FRAME, bounces=bounces)
    tp = t_pipeline.prepare(cfg, scene=blocker_cloud_scene(with_spheres=True), device="cpu")
    assert tp.resolved_variant("auto") == "fused" and tp.tables.sph.shape == (3, 16)
    fused = tp.render().numpy()
    passed = tp.render(variant="pallas").numpy()
    _assert_close(ref, fused)
    _assert_close(ref, passed)
    _assert_close(passed, fused)
    # the spheres are in frame: they change the image
    free = t_pipeline.prepare(cfg, scene=blocker_cloud_scene(), device="cpu")
    assert free.tables.sph is None
    assert np.abs(free.render().numpy() - fused).max() > 0.05


@pytest.mark.parametrize("extra, variant", [
    (dict(bf16_bvh=True), "fused"), (dict(stream="on"), "pallas"),
], ids=["bf16", "stream"])
def test_sphere_frames_other_tables(extra, variant):
    """bf16 boxes (fused) and streamed leaf rows ("auto" is then pass-based)
    give the JAX fused frame of the f32 tables, 1 bounce."""
    tp = t_pipeline.prepare(TConfig(**FRAME, bounces=1, **extra),
                            scene=blocker_cloud_scene(with_spheres=True), device="cpu")
    assert tp.resolved_variant() == variant
    assert tp.tables.compressed == bool(extra.get("bf16_bvh")) and tp.stream == (variant == "pallas")
    _assert_close(_jax_fused(1), tp.render().numpy())


def test_frame_tiles_checks_sph():
    """The sphere table is checked like every other input; an empty one
    takes the sphere-free path."""
    sc = blocker_cloud_scene(with_spheres=True)
    tp = t_pipeline.prepare(TConfig(**FRAME, bounces=2), scene=sc, device="cpu")
    T = tp.tables
    o, d = t_pipeline.render_ops._tiled_planes(tp.camera(), 32, 32, 32, 32, "cpu")
    kw = dict(bounces=2, leaf_size=8)
    args = (T.cbox, T.cmeta, T.tri, T.attr, T.lamb, o, d)
    with pytest.raises(TypeError):
        cuda_trace.frame_tiles(*args, sph=T.sph.double(), **kw)
    with pytest.raises(ValueError):
        cuda_trace.frame_tiles(*args, sph=T.sph[:, :12].contiguous(), **kw)
    free = cuda_trace.frame_tiles(*args, **kw)
    empty = cuda_trace.frame_tiles(*args, sph=torch.zeros((0, 16)), **kw)
    assert all(torch.equal(a, b) for a, b in zip(free, empty))
    with_sph = cuda_trace.frame_tiles(*args, sph=T.sph, **kw)
    assert not torch.equal(with_sph.x, free.x)
    assert packed_from_numpy(T.cbox.numpy(), T.cmeta.numpy(), T.tri.numpy(),
                             T.attr.numpy(), T.lamb.numpy(), device="cpu",
                             sph=np.zeros((0, 16))).sph is None

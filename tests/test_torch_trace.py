"""The port's traversal entry points against the JAX Pallas kernels.

Both packages trace the very same tables: the JAX package prepares them and
convert.packed_from_numpy carries them across. The JAX kernels run in
interpret mode (closest_tiles / closest_tiles_full / occluded_tiles with
dual=True, FP32 leaf); on the CPU the port runs the kernels' plain
versions (brute force over every triangle slot).

Bounds: miss masks equal; t within atol 1e-4, rtol 1e-5 on hits (as
tests/test_pallas_trace.py); idx agreement >= 0.999, since a tie between
leaves goes to whichever the traversal visits first; attributes equal where
idx is equal; blocked agreement >= 0.999.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.camera import default_camera, ray_basis
from parallel_ray_tracer_tpu.models.scene import synthetic_scene
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops.intersect import clip_inv_dir as j_clip_inv_dir
from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as JVec3
from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.ops.intersect import clip_inv_dir, mt_rows
from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3 as TVec3

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

W, H = 128, 64
LIGHT = np.asarray([4.0, -2.0, 6.0], np.float32)


def _scene(name):
    return blocker_cloud_scene() if name == "blocker" else synthetic_scene(2000)


@pytest.fixture(scope="module", params=["blocker", "synthetic2000"])
def case(request):
    cfg = JConfig(width=W, height=H, bvh_heuristic=6, use_native=False,
                  mxu_leaf=False, tile_rows=8, tile_cols=128)
    jp = j_pipeline.prepare(cfg, scene=_scene(request.param))
    packed = [np.asarray(a) for a in jp.packed_dev[:4]]
    tables = packed_from_numpy(
        *packed, np.asarray(j_pt.pack_lights(jp.ds)), device="cpu",
        leaf_size=jp.leaf_size,
    )
    basis = tuple(jnp.asarray(a) for a in ray_basis(default_camera(), W, H))
    o, d = generate_rays_tiled(basis, W, H, 8, 128)
    rows = o.x.shape[0] // 128
    o = [np.asarray(p).reshape(rows, 128) for p in o]
    d = [np.asarray(p).reshape(rows, 128) for p in d]
    return jp, tables, o, d


def _jvec(planes):
    return JVec3(*(jnp.asarray(p) for p in planes))


def _tvec(planes):
    return TVec3(*(torch.from_numpy(np.array(p, np.float32)) for p in planes))


def _jkw(jp):
    return dict(leaf_size=jp.leaf_size, interpret=True, dual=True,
                stack_depth=jp.pallas_stack_depth)


def _assert_hits(jt, jidx, tt, tidx):
    jt, tt = np.asarray(jt), np.asarray(tt)
    jmiss, tmiss = jt > 1e30, tt > 1e30
    assert (jmiss == tmiss).all()
    assert (~jmiss).mean() > 0.05  # non-vacuous: rays do hit
    np.testing.assert_allclose(tt[~tmiss], jt[~jmiss], atol=1e-4, rtol=1e-5)
    same = np.asarray(jidx) == np.asarray(tidx)
    assert same.mean() >= 0.999, same.mean()
    return same


def test_closest(case):
    jp, T, o, d = case
    cbox, cmeta, tri = jp.packed_dev[:3]
    jh = j_pt.closest_tiles(cbox, cmeta, tri, _jvec(o), _jvec(d), **_jkw(jp))
    th = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, _tvec(o), _tvec(d),
                                  leaf_size=T.leaf_size)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy()[same]).all()


def test_closest_full(case):
    jp, T, o, d = case
    cbox, cmeta, tri, attr = jp.packed_dev[:4]
    jh = j_pt.closest_tiles_full(cbox, cmeta, tri, attr, _jvec(o), _jvec(d),
                                 **_jkw(jp))
    th = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, _tvec(o),
                                       _tvec(d), leaf_size=T.leaf_size)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy()[same]).all()
    for jv, tv in zip((jh.n, jh.kd, jh.ks, jh.kr), (th.n, th.kd, th.ks, th.kr)):
        for a, b in zip(jv, tv):
            assert (np.asarray(a)[same] == b.numpy()[same]).all()


def _reversed_shadow_rays(jp, o, d):
    """Shadow rays to LIGHT from the JAX kernel's primary hits."""
    cbox, cmeta, tri = jp.packed_dev[:3]
    h = j_pt.closest_tiles(cbox, cmeta, tri, _jvec(o), _jvec(d), **_jkw(jp))
    return _shadow_rays_from(np.asarray(h.t), o, d)


def _shadow_rays_from(t, o, d):
    """Shadow segments from LIGHT to the hit points o + d*t, traced from the
    light as the renderer does (origin = light, direction = -l, window
    (|lvec| - EPS)^2); rays that missed are dead (o far, d 0)."""
    hit = t < 1e30
    ts = np.where(hit, t, 1.0).astype(np.float32)
    p = [o[k] + d[k] * ts for k in range(3)]
    lv = [LIGHT[k] - p[k] for k in range(3)]
    mag = np.sqrt(lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2])
    so = [np.where(hit, LIGHT[k], np.float32(1e30)).astype(np.float32) for k in range(3)]
    sd = [np.where(hit, -lv[k] / mag, 0.0).astype(np.float32) for k in range(3)]
    m2 = (np.maximum(mag - 1e-3, 0.0) ** 2).astype(np.float32)
    return so, sd, m2


def test_occluded_reversed_shadows(case):
    jp, T, o, d = case
    so, sd, m2 = _reversed_shadow_rays(jp, o, d)
    cbox, cmeta, tri = jp.packed_dev[:3]
    jb = np.asarray(j_pt.occluded_tiles(cbox, cmeta, tri, _jvec(so), _jvec(sd),
                                        jnp.asarray(m2), **_jkw(jp)))
    tb = cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, _tvec(so), _tvec(sd),
                                   torch.from_numpy(m2), leaf_size=T.leaf_size)
    assert 0.0 < jb.mean() < 1.0  # non-vacuous: some rays are blocked
    assert (jb == tb.numpy()).mean() >= 0.999


def test_closest_on_shadow_rays(case):
    """Closest hit of the reversed shadow rays: a shared light origin, and
    dead lanes that must report the miss sentinels."""
    jp, T, o, d = case
    so, sd, _ = _reversed_shadow_rays(jp, o, d)
    cbox, cmeta, tri = jp.packed_dev[:3]
    jh = j_pt.closest_tiles(cbox, cmeta, tri, _jvec(so), _jvec(sd), **_jkw(jp))
    th = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, _tvec(so), _tvec(sd),
                                  leaf_size=T.leaf_size)
    _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    dead = sd[0] == 0
    assert (th.idx.numpy()[dead] == -1).all()
    assert (th.t.numpy()[dead] > 1e30).all()


def test_triangle_test_and_inverse_direction_match_jax():
    """mt_rows against the JAX kernels' _mt_scalar_tri on packed rows, and
    clip_inv_dir against the JAX one, including zero direction components:
    bit-identical."""
    rng = np.random.RandomState(3)
    rows = rng.normal(size=(8, 12)).astype(np.float32)
    rows[:, 9:12] = np.cross(rows[:, 3:6], rows[:, 6:9])
    rows[0] = 0.0                                       # padding slot
    o = [rng.normal(size=(8, 128)).astype(np.float32) * 3 for _ in range(3)]
    d = [rng.normal(size=(8, 128)).astype(np.float32) for _ in range(3)]
    d[0][0, :5] = 0.0
    d[1][0, :3] = -0.0
    row_j = jnp.asarray(rows.reshape(1, -1))
    to, td = _tvec(o), _tvec(d)
    for j in range(8):
        jt, jneg = j_pt._mt_scalar_tri(_jvec(o), _jvec(d), row_j, j)
        tt, tneg = mt_rows(to, td, torch.from_numpy(rows[j]))
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        np.testing.assert_array_equal(np.asarray(jneg), tneg.numpy())
    for a, b in zip(j_clip_inv_dir(_jvec(d)), clip_inv_dir(td)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

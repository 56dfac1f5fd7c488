"""Forward shadow rays and closest-hit shadows in the port against the JAX
package (the pre-split is in tests/test_torch_presplit.py).

- frame_tiles(reverse_shadows=False) against JAX's frame_tiles with the
  same flag (interpret mode) on one packet of the blocker cloud's camera
  rays, and its plain version against the reversed frame.
- shade_hit, forward and reversed, and occluded_from_closest against JAX's
  on the same hits, over both packages' brute-force tracers.
- The pass-based render with reverse_shadows=False and with
  fast_light=False against JAX's render(variant="pallas", interpret=True)
  (JAX render.py:288-295: forward shadow rays whenever fast_light is off);
  "auto" resolves to the pass-based path without fast_light
  (tests/test_variant_resolution.py:41); the forward and reversed frames
  agree as tests/test_kernel_variants.py:380-395 holds them.

Bounds: frames as tests/test_fused.py (more than 99% of pixels within 1e-3,
median below 1e-5); colours of shade_hit within 1e-5; blocked agreement
>= 0.999.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from test_torch_frame import _assert_close
from test_torch_trace import _jvec, _tvec
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.camera import default_camera, ray_basis
from parallel_ray_tracer_tpu.models.device_scene import device_scene_from_host as j_dsfh
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops import shade as j_shade
from parallel_ray_tracer_tpu.ops import trace_brute as j_brute
from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.convert import device_scene_from_numpy, packed_from_numpy
from parallel_ray_tracer_tpu_torch.ops import cuda_trace, shade, trace_brute

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

FRAME = dict(width=32, height=32, bounces=2, bvh_heuristic=6, tile_rows=32, tile_cols=32,
             use_native=False, mxu_leaf=False, pop_width=2, adaptive_pop=False)


# ---- the fused frame with forward shadow rays --------------------------------


@pytest.fixture(scope="module")
def blocker():
    """The blocker cloud's JAX state, its tables carried across, and one
    packet of camera rays."""
    sc = blocker_cloud_scene()
    jp = j_pipeline.prepare(JConfig(**FRAME), scene=sc)
    lamb = np.asarray(j_pt.pack_lights(jp.ds))
    T = packed_from_numpy(*(np.asarray(a) for a in jp.packed_dev[:4]), lamb, device="cpu",
                          leaf_size=jp.leaf_size)
    basis = tuple(jnp.asarray(a) for a in ray_basis(default_camera(), 32, 32))
    o, d = generate_rays_tiled(basis, 32, 32, 32, 32)
    o = [np.asarray(p).reshape(8, 128) for p in o]
    d = [np.asarray(p).reshape(8, 128) for p in d]
    return sc, jp, T, o, d


def _frame(col):
    return np.stack([np.asarray(c) for c in col], -1).reshape(32, 32, 3)


def test_frame_tiles_forward_matches_jax(blocker):
    _, jp, T, o, d = blocker
    cbox, cmeta, tri, attr = jp.packed_dev[:4]
    ref = j_pt.frame_tiles(cbox, cmeta, tri, attr, jnp.asarray(T.lamb.numpy()), _jvec(o),
                           _jvec(d), bounces=2, leaf_size=jp.leaf_size, interpret=True,
                           stack_depth=jp.pallas_stack_depth, reverse_shadows=False)
    kw = dict(bounces=2, leaf_size=T.leaf_size, stack_depth=T.stack_depth)
    fwd = cuda_trace.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, _tvec(o), _tvec(d),
                                 reverse_shadows=False, **kw)
    _assert_close(_frame(ref), _frame(fwd))
    rev = cuda_trace.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, _tvec(o), _tvec(d),
                                 **kw)
    _assert_close(_frame(rev), _frame(fwd))


# ---- shade_hit and occluded_from_closest --------------------------------------


@pytest.fixture(scope="module")
def brute():
    """Both packages' scene planes and brute-force tracers for the blocker
    cloud, the camera rays and the port's primary hits."""
    sc = blocker_cloud_scene()
    jds = j_dsfh(sc)
    tds = device_scene_from_numpy(jds, device="cpu")
    basis = tuple(jnp.asarray(a) for a in ray_basis(default_camera(), 32, 32))
    o, d = generate_rays_tiled(basis, 32, 32, 32, 32)
    o, d = [np.asarray(p) for p in o], [np.asarray(p) for p in d]
    jtr, ttr = j_brute.make_tracer(jds), trace_brute.make_tracer(tds)
    hit = ttr[0](_tvec(o), _tvec(d))
    return jds, tds, jtr, ttr, o, d, hit


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reversed"])
def test_shade_hit_matches_jax(brute, reverse):
    jds, tds, jtr, ttr, o, d, hit = brute
    assert (hit.idx >= 0).float().mean() > 0.5
    jhit = j_brute.Hit(t=jnp.asarray(hit.t.numpy()), idx=jnp.asarray(hit.idx.numpy()),
                       norm_dir=jnp.asarray(hit.norm_dir.numpy()))
    ref = j_shade.shade_hit(jds, jtr[1], _jvec(o), _jvec(d), jhit, reverse_shadows=reverse)
    col = shade.shade_hit(tds, ttr[1], _tvec(o), _tvec(d), hit, reverse_shadows=reverse)
    ok = hit.idx.numpy() >= 0
    for a, b in zip(ref, col):
        np.testing.assert_allclose(b.numpy()[ok], np.asarray(a)[ok], atol=1e-5)


def test_occluded_from_closest_matches_jax(brute):
    jds, tds, jtr, ttr, o, d, hit = brute
    lp = np.asarray(jds.lights_pos.x[0]), np.asarray(jds.lights_pos.y[0]), \
        np.asarray(jds.lights_pos.z[0])
    t = np.where(hit.idx.numpy() >= 0, hit.t.numpy(), 1.0)
    p = [oc + dc * t for oc, dc in zip(o, d)]
    lv = [np.float32(c) - pc for c, pc in zip(lp, p)]
    m2 = (lv[0] ** 2 + lv[1] ** 2 + lv[2] ** 2).astype(np.float32)
    ld = [(c / np.sqrt(m2)).astype(np.float32) for c in lv]
    jb = np.asarray(j_shade.occluded_from_closest(jtr[0])(_jvec(p), _jvec(ld), jnp.asarray(m2)))
    tb = shade.occluded_from_closest(ttr[0])(_tvec(p), _tvec(ld), torch.from_numpy(m2)).numpy()
    assert 0.0 < tb.mean() < 1.0                       # non-vacuous
    assert (jb == tb).mean() >= 0.999
    # the any-hit traversal agrees on these segments
    assert (ttr[1](_tvec(p), _tvec(ld), torch.from_numpy(m2)).numpy() == tb).mean() >= 0.999


# ---- the pass-based render -----------------------------------------------------

KNOBS = {"no_reverse_shadows": dict(reverse_shadows=False),
         "no_fast_light": dict(fast_light=False),
         "no_fast_light_no_reverse": dict(fast_light=False, reverse_shadows=False)}


@pytest.mark.parametrize("case", list(KNOBS))
def test_pass_based_render_matches_jax(case):
    kw = dict(FRAME, **KNOBS[case])
    sc = blocker_cloud_scene()
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    assert tp.resolved_variant() == jp.resolved_variant()
    ref = np.asarray(jp.render(variant="pallas", interpret=True))
    _assert_close(ref, tp.render(variant="pallas").numpy())


def test_auto_is_pass_based_without_fast_light():
    sc = blocker_cloud_scene()
    tp = t_pipeline.prepare(TConfig(fast_light=False, **FRAME), scene=sc, device="cpu")
    assert tp.resolved_variant() == "pallas"
    tp = t_pipeline.prepare(TConfig(reverse_shadows=False, **FRAME), scene=sc, device="cpu")
    assert tp.resolved_variant() == "fused"


def test_forward_frame_matches_reversed():
    """tests/test_kernel_variants.py:380-395 on the port's fused and
    pass-based frames of the blocker cloud (64x48, 2 bounces): shadow-edge
    values may flip, at most 0.2% of them."""
    kw = dict(FRAME, width=64, height=48, tile_rows=16, tile_cols=64)
    imgs = {}
    for rev in (True, False):
        tp = t_pipeline.prepare(TConfig(reverse_shadows=rev, **kw), scene=blocker_cloud_scene(),
                                device="cpu")
        imgs[rev] = (tp.render().numpy(), tp.render(variant="pallas").numpy())
    assert imgs[True][0].std() > 0.01
    for a, b in zip(imgs[True], imgs[False]):
        assert (np.abs(a - b) > 1e-5).mean() <= 2e-3

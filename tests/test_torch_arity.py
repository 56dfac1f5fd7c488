"""The port at node arity 2, 4 and 8 against the JAX package.

- The port's packers (pack_bvh, pack_bvh8) give the JAX tables bit for bit,
  the one-triangle scene whose root is a leaf included, and `stack_need`
  is (arity - 1) * rows + 2 for the deepest row path of each table.
- The traversal entry points against the JAX Pallas kernels in interpret
  mode (FP32 leaf), on tables that convert.packed_from_numpy carries across:
    - width 2: _closest_kernel, _closest_attr_kernel, _occluded_kernel;
    - widths 4 and 8, single pop: _closest4_kernel, _closest_attr_kernel,
      _occluded4_kernel;
    - width 8, dual pop: _closest_dual_kernel (n_attr 0 and 12),
      _occluded_dual_kernel.
  On the CPU the port runs the kernels' plain versions.
- Whole frames: width 2 ("auto" resolves to the pass-based path) against
  JAX render(variant="pallas"), width 8 (fused and pass-based) against JAX
  render(variant="fused"), both in interpret mode.

Bounds as tests/test_torch_trace.py (hits) and tests/test_fused.py (frames).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from test_torch_frame import _assert_close
from test_torch_trace import _assert_hits, _jvec, _shadow_rays_from, _tvec
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.camera import default_camera, ray_basis
from parallel_ray_tracer_tpu.models.scene import synthetic_scene
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops.bvh import build_bvh as j_build
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh as j_flatten
from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.ops import pack as t_pack
from parallel_ray_tracer_tpu_torch.ops.bvh import build_bvh as t_build
from parallel_ray_tracer_tpu_torch.ops.bvh_flat import flatten_bvh as t_flatten

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

L = 8
J_PACK = {2: j_pt.pack_bvh, 4: j_pt.pack_bvh4, 8: j_pt.pack_bvh8}
T_PACK = {2: t_pack.pack_bvh, 4: t_pack.pack_bvh4, 8: t_pack.pack_bvh8}

# ---- packers ---------------------------------------------------------------

PACK_SCENES = {
    "blocker": blocker_cloud_scene,
    "synthetic2000": lambda: synthetic_scene(2000),
    "one_triangle": lambda: synthetic_scene(1),      # the root is a leaf
}


@pytest.fixture(scope="module", params=sorted(PACK_SCENES))
def flats(request):
    tv = PACK_SCENES[request.param]().triangle_vertices()
    kw = dict(heuristic=6, leaf_threshold=L, seed=1, true_sah=True)
    jflat = j_flatten(j_build(tv, **kw), tv, leaf_size=L)
    tflat = t_flatten(t_build(tv, **kw), tv, leaf_size=L)
    return tv, jflat, tflat


@pytest.mark.parametrize("width", [2, 8])
def test_packer_identical(flats, width):
    tv, jflat, tflat = flats
    jp, tp = J_PACK[width](jflat, tv), T_PACK[width](tflat, tv)
    for f in ("cbox", "cmeta", "tri"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b, equal_nan=True), f
    if width == 2:
        assert not tp.cmeta[:, 2:].any()             # no validity flags
        if jflat.count[0] > 0:                        # both children: the leaf
            assert tp.cmeta.shape[0] == 1 and tp.cmeta[0, 0] == tp.cmeta[0, 1] < 0


def _deepest_rows(cmeta, arity):
    """Rows on the deepest root-to-leaf path, by a walk of the table."""
    def children(e):
        enc = cmeta[e, :arity]
        ok = np.ones(arity, bool) if arity == 2 else cmeta[e, arity:2 * arity] > 0
        return [int(c) for c in enc[ok] if c >= 0]

    def depth(e):
        return 1 + max((depth(c) for c in children(e)), default=0)

    return depth(0)


@pytest.mark.parametrize("width", [2, 4, 8])
def test_stack_need(flats, width):
    tv, jflat, _ = flats
    cmeta = J_PACK[width](jflat, tv).cmeta
    assert t_pack.stack_need(cmeta, width) == (width - 1) * _deepest_rows(cmeta, width) + 2


# ---- traversal kernels -----------------------------------------------------

W, H = 64, 32
# (bvh_width, dual): the JAX kernels closest_tiles / closest_tiles_full /
# occluded_tiles reach (PERF.md rows).
TRACE_CASES = {
    "w2": (2, False),          # _closest_kernel, _closest_attr_kernel, _occluded_kernel
    "w4_single": (4, False),   # _closest4_kernel, _closest_attr_kernel, _occluded4_kernel
    "w8_single": (8, False),   # the same three at arity 8
    "w8_dual": (8, True),      # _closest_dual_kernel(0, 12), _occluded_dual_kernel
}


@pytest.fixture(scope="module", params=sorted(TRACE_CASES))
def case(request):
    width, dual = TRACE_CASES[request.param]
    cfg = JConfig(width=W, height=H, bvh_heuristic=6, use_native=False,
                  mxu_leaf=False, tile_rows=8, tile_cols=128, bvh_width=width)
    jp = j_pipeline.prepare(cfg, scene=blocker_cloud_scene())
    T = packed_from_numpy(
        *(np.asarray(a) for a in jp.packed_dev[:4]),
        np.asarray(j_pt.pack_lights(jp.ds)), device="cpu", leaf_size=jp.leaf_size,
    )
    assert T.arity == width
    basis = tuple(jnp.asarray(a) for a in ray_basis(default_camera(), W, H))
    o, d = generate_rays_tiled(basis, W, H, 8, 128)
    rows = o.x.shape[0] // 128
    o = [np.asarray(p).reshape(rows, 128) for p in o]
    d = [np.asarray(p).reshape(rows, 128) for p in d]
    jkw = dict(leaf_size=jp.leaf_size, interpret=True, dual=dual,
               stack_depth=jp.pallas_stack_depth)
    return jp, T, o, d, jkw


def test_closest(case):
    jp, T, o, d, jkw = case
    cbox, cmeta, tri = jp.packed_dev[:3]
    jh = j_pt.closest_tiles(cbox, cmeta, tri, _jvec(o), _jvec(d), **jkw)
    th = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, _tvec(o), _tvec(d),
                                  leaf_size=T.leaf_size)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy()[same]).all()


def test_closest_full(case):
    jp, T, o, d, jkw = case
    cbox, cmeta, tri, attr = jp.packed_dev[:4]
    jh = j_pt.closest_tiles_full(cbox, cmeta, tri, attr, _jvec(o), _jvec(d), **jkw)
    th = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, _tvec(o),
                                       _tvec(d), leaf_size=T.leaf_size)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    for jv, tv in zip((jh.n, jh.kd, jh.ks, jh.kr), (th.n, th.kd, th.ks, th.kr)):
        for a, b in zip(jv, tv):
            assert (np.asarray(a)[same] == b.numpy()[same]).all()


def test_occluded_reversed_shadows(case):
    """Shadow rays from the light to the primary hits (the port's), traced
    from the light as the renderer does."""
    jp, T, o, d, jkw = case
    h = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, _tvec(o), _tvec(d),
                                 leaf_size=T.leaf_size)
    so, sd, m2 = _shadow_rays_from(h.t.numpy(), o, d)
    cbox, cmeta, tri = jp.packed_dev[:3]
    jb = np.asarray(j_pt.occluded_tiles(cbox, cmeta, tri, _jvec(so), _jvec(sd),
                                        jnp.asarray(m2), **jkw))
    tb = cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, _tvec(so), _tvec(sd),
                                   torch.from_numpy(m2), leaf_size=T.leaf_size)
    assert 0.0 < jb.mean() < 1.0  # non-vacuous: some rays are blocked
    assert (jb == tb.numpy()).mean() >= 0.999


# ---- whole frames ----------------------------------------------------------

# pop_width=2 and adaptive_pop=False only narrow the JAX fused kernel's
# schedule (the same frame; its wide-pop form takes ~4x longer to
# interpret). The port ignores both.
FRAME = dict(width=32, height=32, bounces=2, bvh_heuristic=6, tile_rows=32,
             tile_cols=32, use_native=False, mxu_leaf=False, pop_width=2,
             adaptive_pop=False)


@pytest.mark.parametrize("width,auto,j_variant", [
    (2, "pallas", "pallas"),
    (8, "fused", "fused"),
])
def test_frame_matches_jax(width, auto, j_variant):
    sc = blocker_cloud_scene()
    tp = t_pipeline.prepare(TConfig(bvh_width=width, **FRAME), scene=sc, device="cpu")
    assert tp.tables.arity == width
    assert tp.resolved_variant() == auto
    jp = j_pipeline.prepare(JConfig(bvh_width=width, **FRAME), scene=sc)
    ref = np.asarray(jp.render(variant=j_variant, interpret=True))
    _assert_close(ref, tp.render().numpy())
    if auto == "fused":
        _assert_close(ref, tp.render(variant="pallas").numpy())

"""Streamed leaf rows at leaf sizes 4, 2 and 1 in the port against the JAX package.

The streamed wrappers (stream=True; on the CPU their plain versions) at
L = 4, 2 and 1 against JAX's streamed kernels, make_tracer(..., stream=True,
interpret=True) with the attr table (_closest_stream_kernel(n_attr=12),
_occluded_stream_kernel), on tests/test_torch_stream.py's 2,000-triangle
synthetic scene (seed 3) and 1,024 random rays (seed 0), at width 4, the
tree built at leaf threshold L as prepare builds it and padded to whole
blocks. JAX's outputs are made once per leaf size for the module (one
make_tracer and one interpret call of each kernel).

Bounds as tests/test_torch_stream.py: hits as tests/test_torch_trace.py
(miss masks equal, t within atol 1e-4 / rtol 1e-5, idx agreement >= 0.999),
attributes within 1e-6 where idx agrees, blocked equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trace import _assert_hits, _tvec
from parallel_ray_tracer_tpu.models.scene import synthetic_scene
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops.bvh import build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as JVec3
from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.ops import pack as t_pack

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

LEAVES = (4, 2, 1)
MAX_DIST2 = 25.0


@pytest.fixture(scope="module")
def at_leaf():
    """leaf -> (the port's padded tables, rays, JAX's closest_full hit and
    blocked flags), each leaf size built and traced by JAX once."""
    sc = synthetic_scene(2000, seed=3)
    tv = sc.triangle_vertices()
    rng = np.random.RandomState(0)
    o = [rng.uniform(-6, 6, 1024).astype(np.float32) for _ in range(3)]
    dn = rng.normal(size=(3, 1024)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    d = list(dn)
    m2 = np.full(1024, MAX_DIST2, np.float32)
    cache = {}

    def get(leaf):
        if leaf not in cache:
            flat = flatten_bvh(build_bvh(tv, heuristic=6, leaf_threshold=leaf), tv,
                               leaf_size=leaf)
            packed = j_pt.pack_bvh4(flat, tv)
            tri = t_pack.pad_stream_rows(packed.tri)
            attr = t_pack.pad_stream_rows(
                j_pt.pack_attr(flat, sc.mat_idx, sc.mats_kd, sc.mats_ks, sc.mats_kr))
            closest, occluded = j_pt.make_tracer(
                tuple(jnp.asarray(a) for a in (packed.cbox, packed.cmeta, tri, attr)), leaf,
                interpret=True, stack_depth=j_pt.required_stack_depth(flat.depth, 4),
                stream=True)
            jo, jd = (JVec3(*(jnp.asarray(p) for p in v)) for v in (o, d))
            T = packed_from_numpy(packed.cbox, packed.cmeta, tri, attr,
                                  np.zeros((1, 8), np.float32), device="cpu", leaf_size=leaf)
            cache[leaf] = (T, closest(jo, jd), np.asarray(occluded(jo, jd, jnp.asarray(m2))))
        return cache[leaf]

    def planes(v):
        return _tvec([p.reshape(8, 128) for p in v])

    return get, planes(o), planes(d), torch.from_numpy(m2.reshape(8, 128))


@pytest.mark.parametrize("leaf", LEAVES)
def test_closest_full_stream_leaf_matches_jax(at_leaf, leaf):
    get, o, d, _ = at_leaf
    T, jh, _ = get(leaf)
    assert T.leaf_size == leaf and T.tri.shape[0] % t_pack.STREAM_BLK == 0
    th = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, o, d, leaf_size=leaf,
                                       stream=True)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy().ravel(), th.idx.numpy().ravel())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy().ravel()[same]).all()
    for jv, tv in zip((jh.n, jh.kd, jh.ks, jh.kr), (th.n, th.kd, th.ks, th.kr)):
        for a, b in zip(jv, tv):
            np.testing.assert_allclose(b.numpy().ravel()[same], np.asarray(a)[same],
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("leaf", LEAVES)
def test_occluded_stream_leaf_matches_jax(at_leaf, leaf):
    get, o, d, m2 = at_leaf
    T, _, jb = get(leaf)
    tb = cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, o, d, m2, leaf_size=leaf,
                                   stream=True)
    assert 0.0 < jb.mean() < 1.0  # non-vacuous: some rays are blocked
    assert np.array_equal(jb, tb.numpy().ravel())

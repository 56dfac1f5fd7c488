"""The MXU leaf in the port against the JAX package.

- (a) Tables: build_cmat, the packers' cmat, split_cmat and pack_cmi4 give
  JAX's _build_cmat, PackedBVH.cmat, the prepare's [hi | lo] upload
  (tests/test_kernel_variants.py `_interleave_cmat`) and pack_cmi4 bit for
  bit, on the 2,000-triangle synthetic scene (seed 3); bf16 tables compared
  as uint16.
- (b) The wrappers with `cmat` (on the CPU the MXU plain versions) against
  JAX's closest_tiles / closest_tiles_full / occluded_tiles with cmat,
  dual=True, interpret=True, on one packet of 1,024 rays, at width 4 and
  (closest) width 8. The MXU hits differ from the FP32 ones on some ray,
  which shows that the MXU leaf ran.
- (c) The four-group layout (pack_cmi4) gives the (rows, 32) table's hits
  bit for bit.
- (d) prepare takes the MXU leaf exactly where JAX's prepare uploads its
  C-matrix table (len(packed_dev) == 5): the defaults, mxu_leaf=False,
  dual_pop=False, bvh_width=2, stream="on", and both budgets patched low.
- (e) A 32x32, 2-bounce fused frame with the MXU leaf on in both packages
  (the default config, JAX's packet schedule narrowed) against JAX's
  render(variant="fused", interpret=True), and the port's pass-based frame.
- (f) --mxu-leaf and --no-mxu-leaf through the port's command line.

Bounds: hits as tests/test_torch_trace.py (miss masks equal, t within atol
1e-4 / rtol 1e-5, idx agreement >= 0.999), attributes within 1e-6 where idx
agrees, blocked agreement >= 0.999; frames as tests/test_fused.py (more
than 99% of pixels within 1e-3, median below 1e-5). The plain versions sum
the bf16 halves' products in another order than XLA, so t is held to
bounds, not bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from test_torch_frame import _assert_close
from test_torch_trace import _assert_hits, _tvec
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.scene import synthetic_scene
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops.bvh import build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as JVec3
from parallel_ray_tracer_tpu_torch import cli
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.ops import pack as t_pack
from parallel_ray_tracer_tpu_torch.ops import trace_plain
from parallel_ray_tracer_tpu_torch.ops.bvh import build_bvh as t_build
from parallel_ray_tracer_tpu_torch.ops.bvh_flat import flatten_bvh as t_flatten

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

L = 8
J_PACK = {2: j_pt.pack_bvh, 4: j_pt.pack_bvh4, 8: j_pt.pack_bvh8}
T_PACK = {2: t_pack.pack_bvh, 4: t_pack.pack_bvh4, 8: t_pack.pack_bvh8}


def _interleave_cmat(cmat):
    """JAX's prepare upload (pipeline.py:442-446), as
    tests/test_kernel_variants.py mirrors it: one [hi(16) | lo(16)] table."""
    cm = jnp.asarray(cmat)
    cmh = cm.astype(jnp.bfloat16)
    cml = (cm - cmh.astype(jnp.float32)).astype(jnp.bfloat16)
    return jnp.concatenate([cmh, cml], axis=1)


def _bits(a):
    return np.asarray(a).view(np.uint16)


def _bf16(a):
    """numpy bf16 bits (or ml_dtypes bfloat16) -> a torch.bfloat16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(_bits(a)).view(np.int16)).view(torch.bfloat16)


@pytest.fixture(scope="module")
def scene():
    """The synthetic scene of tests/test_kernel_variants.py, flattened by
    both packages' builders, and one packet of 1,024 random rays."""
    sc = synthetic_scene(2000, seed=3)
    tv = sc.triangle_vertices()
    jflat = flatten_bvh(build_bvh(tv, heuristic=6, leaf_threshold=L), tv, leaf_size=L)
    tflat = t_flatten(t_build(tv, heuristic=6, leaf_threshold=L), tv, leaf_size=L)
    rng = np.random.RandomState(0)
    o = [rng.uniform(-6, 6, 1024).astype(np.float32).reshape(8, 128) for _ in range(3)]
    dn = rng.normal(size=(3, 1024)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    d = [x.reshape(8, 128) for x in dn]
    attr = j_pt.pack_attr(jflat, sc.mat_idx, sc.mats_kd, sc.mats_ks, sc.mats_kr)
    return sc, tv, jflat, tflat, attr, o, d


# ---- (a) tables ----------------------------------------------------------------


def test_build_cmat_identical():
    rng = np.random.RandomState(5)
    G, S = 7, 7 * L
    v0, e1, e2 = (rng.normal(size=(S, 3)).astype(np.float32) for _ in range(3))
    n = np.cross(e1, e2)
    sm = np.arange(S)
    sm[rng.rand(S) < 0.2] = -1                       # some pad slots
    a = j_pt._build_cmat(v0, e1, e2, n, sm, G, L)
    b = t_pack.build_cmat(v0, e1, e2, n, sm, G, L)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == ((G + 1) * 4 * L, 16)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("width", [2, 4, 8])
def test_packer_cmat_split_and_cmi4_identical(scene, width):
    _, tv, jflat, tflat, *_ = scene
    jp, tp = J_PACK[width](jflat, tv), T_PACK[width](tflat, tv)
    assert np.array_equal(jp.cmat.view(np.uint32), tp.cmat.view(np.uint32))
    split = t_pack.split_cmat(tp.cmat)
    assert split.dtype == np.uint16 and split.shape == (tp.cmat.shape[0], 32)
    assert np.array_equal(_bits(_interleave_cmat(jp.cmat)), split)
    if width == 4:
        cmi4 = t_pack.pack_cmi4(tp.cmat, L)
        assert cmi4.shape[1] == 128
        assert np.array_equal(_bits(j_pt.pack_cmi4(jp.cmat, L)), cmi4)


# ---- (b) the wrappers against JAX's MXU kernels --------------------------------


_TABLES = {}


def _tables(scene, width):
    """JAX's width-`width` tables with the MXU table, carried across (made
    once per width)."""
    if width in _TABLES:
        return _TABLES[width]
    sc, tv, jflat, _, attr, o, d = scene
    packed = J_PACK[width](jflat, tv)
    cmi = _interleave_cmat(packed.cmat)
    j = tuple(jnp.asarray(a) for a in (packed.cbox, packed.cmeta, packed.tri, attr))
    T = packed_from_numpy(packed.cbox, packed.cmeta, packed.tri, attr,
                          np.zeros((1, 8), np.float32), device="cpu", cmat=np.asarray(cmi))
    jkw = dict(leaf_size=L, interpret=True, dual=True,
               stack_depth=j_pt.required_stack_depth(jflat.depth, width))
    _TABLES[width] = (j, cmi, T, jkw)
    return _TABLES[width]


def _planes(o, d):
    return (JVec3(*(jnp.asarray(p) for p in o)), JVec3(*(jnp.asarray(p) for p in d)),
            _tvec(o), _tvec(d))


@pytest.mark.parametrize("width", [4, 8])
def test_closest_mxu_matches_jax(scene, width):
    *_, o, d = scene
    (cbox, cmeta, tri, _), cmi, T, jkw = _tables(scene, width)
    jo, jd, to, td = _planes(o, d)
    jh = j_pt.closest_tiles(cbox, cmeta, tri, jo, jd, cmat=cmi, **jkw)
    th = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, to, td, L, cmat=T.cmat)
    _assert_hits(jh.t, jh.idx, th.t, th.idx)
    same = np.asarray(jh.idx) == th.idx.numpy()
    assert np.array_equal(np.asarray(jh.norm_dir)[same], th.norm_dir.numpy()[same])
    # the MXU leaf ran: its t differs from the FP32 leaf's on some ray
    fp32 = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, to, td, L)
    assert (fp32.t != th.t).any()


def test_closest_full_and_occluded_mxu_match_jax(scene):
    *_, o, d = scene
    (cbox, cmeta, tri, attr), cmi, T, jkw = _tables(scene, 4)
    jo, jd, to, td = _planes(o, d)
    jh = j_pt.closest_tiles_full(cbox, cmeta, tri, attr, jo, jd, cmat=cmi, **jkw)
    th = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, to, td, L, cmat=T.cmat)
    _assert_hits(jh.t, jh.idx, th.t, th.idx)
    same = np.asarray(jh.idx) == th.idx.numpy()
    for jv, tv_ in zip((*jh.n, *jh.kd, *jh.ks, *jh.kr), (*th.n, *th.kd, *th.ks, *th.kr)):
        np.testing.assert_allclose(tv_.numpy()[same], np.asarray(jv)[same], atol=1e-6)
    m2 = np.full((8, 128), 25.0, np.float32)
    jb = np.asarray(j_pt.occluded_tiles(cbox, cmeta, tri, jo, jd, jnp.asarray(m2),
                                        cmat=cmi, **jkw)).astype(bool)
    tb = cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, to, td, torch.from_numpy(m2), L,
                                   cmat=T.cmat).numpy()
    assert 0.05 < tb.mean() < 0.95                     # non-vacuous
    assert (jb == tb).mean() >= 0.999


def test_mxu_plain_without_live_rays(scene):
    """The plain MXU versions on a batch whose rays are all dead (d = 0):
    every ray misses and none is blocked."""
    _, tv, _, tflat, _, o, d = scene
    packed = t_pack.pack_bvh4(tflat, tv)
    cmat = torch.from_numpy(t_pack.split_cmat(packed.cmat).view(np.int16)).view(torch.bfloat16)
    tri = torch.from_numpy(packed.tri)
    dead = _tvec([np.zeros((8, 128), np.float32)] * 3)
    h = trace_plain.closest_mxu_plain(cmat, tri, _tvec(o), dead, L)
    assert bool((h.idx == -1).all()) and bool((h.t >= 1e30).all())
    assert not trace_plain.occluded_mxu_plain(cmat, tri, _tvec(o), dead,
                                              torch.full((8, 128), 25.0), L).any()


# ---- (c) layouts, and the refusals ---------------------------------------------


def test_cmi4_gives_the_same_hits(scene):
    _, tv, _, tflat, attr, o, d = scene
    packed = t_pack.pack_bvh4(tflat, tv)
    T = packed_from_numpy(packed.cbox, packed.cmeta, packed.tri, attr,
                          np.zeros((1, 8), np.float32), device="cpu",
                          cmat=t_pack.split_cmat(packed.cmat))
    c4 = _bf16(t_pack.pack_cmi4(packed.cmat, L))
    to, td = _tvec(o), _tvec(d)
    a = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, to, td, L, cmat=T.cmat)
    b = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, to, td, L, cmat=c4)
    assert all(torch.equal(x, y) for x, y in zip(
        (a.t, a.idx, a.norm_dir, *a.n, *a.kd, *a.ks, *a.kr),
        (b.t, b.idx, b.norm_dir, *b.n, *b.kd, *b.ks, *b.kr)))
    m2 = torch.full((8, 128), 25.0)
    assert torch.equal(
        cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, to, td, m2, L, cmat=T.cmat),
        cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, to, td, m2, L, cmat=c4))
    # a table of another dtype, width or row count is refused
    for bad in (T.cmat.float(), T.cmat[:, :16].contiguous(), T.cmat[:-32]):
        with pytest.raises(ValueError):
            cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, to, td, L, cmat=bad)


# ---- (d) the decision ----------------------------------------------------------

DECISIONS = {
    "defaults": {},
    "mxu_leaf_off": dict(mxu_leaf=False),
    "single_pop": dict(dual_pop=False),
    "width2": dict(bvh_width=2),
    "stream_on": dict(stream="on"),
    "over_budget": None,
}


@pytest.mark.parametrize("case", sorted(DECISIONS))
def test_mxu_decision_as_jax(case, monkeypatch):
    extra = DECISIONS[case]
    if extra is None:
        monkeypatch.setattr(j_pipeline, "_MXU_VMEM_BUDGET", 1024)
        monkeypatch.setattr(t_pack, "MXU_VMEM_BUDGET", 1024)
        extra = {}
    kw = dict(width=32, height=32, tile_rows=32, tile_cols=32, use_native=False, **extra)
    sc = synthetic_scene(64)
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    assert tp.mxu == (len(jp.packed_dev) == 5)
    assert tp.mxu == (case == "defaults")
    assert (tp.tables.cmat is not None) == tp.mxu
    if tp.mxu:
        assert np.array_equal(tp.tables.cmat.view(torch.int16).numpy().view(np.uint16),
                              _bits(jp.packed_dev[4]))


# ---- (e) the fused frame -------------------------------------------------------


def test_frame_mxu_matches_jax():
    """The default config but for pop_width=2 and adaptive_pop=False, which
    only narrow JAX's packet schedule (the same frame; its wide-pop form
    takes several times longer to interpret) and change nothing in the
    port."""
    kw = dict(width=32, height=32, bounces=2, bvh_heuristic=6, tile_rows=32,
              tile_cols=32, use_native=False, pop_width=2, adaptive_pop=False)
    sc = blocker_cloud_scene()
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    assert tp.mxu and tp.resolved_variant() == "fused"
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    assert len(jp.packed_dev) == 5
    ref = np.asarray(jp.render(variant="fused", interpret=True))
    img = tp.render().numpy()
    _assert_close(ref, img)
    _assert_close(ref, tp.render(variant="pallas").numpy())


# ---- (f) the command line ------------------------------------------------------


@pytest.mark.parametrize("flag,want", [("--mxu-leaf", True), ("--no-mxu-leaf", False)])
def test_cli_mxu_flag(flag, want, tmp_path, capsys):
    argv = ["--device", "cpu", "--synthetic", "64", "--width", "32", "--height", "32",
            "--bounces", "1", "--warmup", "0", flag, "--output", str(tmp_path / "f.bmp")]
    assert cli.main(argv) == 0
    assert f"mxu: {want}" in capsys.readouterr().out
    assert (tmp_path / "f.bmp").stat().st_size > 0

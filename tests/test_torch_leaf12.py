"""Leaf sizes 1 and 2 in the port against the JAX package.

- (a) Tables at L = 1 and 2: pack_bvh (f32 and the raw bf16 binary cbox),
  pack_bvh4 and pack_bvh8 (f32 and bf16 pair rows) give JAX's bit for bit.
- (b) The wrappers at L = 1 and 2 (on the CPU their plain versions) against
  JAX's closest_tiles / closest_tiles_full / occluded_tiles in interpret
  mode on one packet of 1,024 rays, at widths 2 and 4. The L = 1 and 2 hits
  are also the L = 8 tables' hits, triangle for triangle through the slot
  maps.
- (c) frame_tiles at L = 2 against JAX's frame_tiles (the file's one JAX
  interpret-mode frame).
- (d) make_tracer: at L = 2 on tests/test_advice_fixes.py's 160 stacked
  triangles against JAX's make_tracer (t = 1); at L = 1 on a small scene
  with spheres, with attr and a trailing C-matrix table, against JAX's
  make_tracer; at L = 1 and 2 the C-matrix table is ignored, as JAX ignores
  it below L = 4 (the FP32 leaf's outputs, bit for bit); its planes need
  whole 128-lane rows, so the pass-based render of 8x16 tiles still runs.
- (e) prepare(leaf_size=1|2) against JAX's prepare (use_native=False): the
  same tables bit for bit, no MXU leaf; _build compiles no MXU unit at
  L = 1 or 2.

Bounds as tests/test_torch_trace.py (hits: miss masks equal, t within atol
1e-4 / rtol 1e-5, idx agreement >= 0.999, attributes equal where idx
agrees, blocked agreement >= 0.999) and tests/test_fused.py (frames: more
than 99% of pixels within 1e-3, median below 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from test_torch_frame import _assert_close
from test_torch_mxu import _interleave_cmat
from test_torch_trace import _assert_hits, _jvec, _tvec
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.camera import default_camera, ray_basis
from parallel_ray_tracer_tpu.models.scene import synthetic_scene
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops.bvh import build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as JVec3
from parallel_ray_tracer_tpu_torch import _build
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.ops import pack as t_pack
from parallel_ray_tracer_tpu_torch.ops.bvh import build_bvh as t_build
from parallel_ray_tracer_tpu_torch.ops.bvh_flat import flatten_bvh as t_flatten
from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3 as TVec3

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

LEAVES = (1, 2)
J_PACK = {2: j_pt.pack_bvh, 4: j_pt.pack_bvh4, 8: j_pt.pack_bvh8}
T_PACK = {2: t_pack.pack_bvh, 4: t_pack.pack_bvh4, 8: t_pack.pack_bvh8}
M2 = np.full((8, 128), 25.0, np.float32)


@pytest.fixture(scope="module")
def scene():
    """A synthetic scene flattened at L = 1, 2 and 8 (leaf threshold L, as
    prepare builds it) by both packages' builders, and one packet of 1,024
    random rays."""
    sc = synthetic_scene(250, seed=3)
    tv = sc.triangle_vertices()
    flats = {}
    for leaf in (*LEAVES, 8):
        kw = dict(heuristic=6, leaf_threshold=leaf)
        flats[leaf] = (flatten_bvh(build_bvh(tv, **kw), tv, leaf_size=leaf),
                       t_flatten(t_build(tv, **kw), tv, leaf_size=leaf))
    rng = np.random.RandomState(0)
    o = [rng.uniform(-6, 6, 1024).astype(np.float32).reshape(8, 128) for _ in range(3)]
    dn = rng.normal(size=(3, 1024)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    d = [x.reshape(8, 128) for x in dn]
    return sc, tv, flats, o, d


# ---- (a) tables -------------------------------------------------------------


@pytest.mark.parametrize("leaf", LEAVES, ids=lambda v: f"l{v}")
@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_packers_identical(scene, leaf, width, bf16):
    _, tv, flats, *_ = scene
    jflat, tflat = flats[leaf]
    assert np.array_equal(jflat.slot_map, tflat.slot_map)
    jp, tp = J_PACK[width](jflat, tv, bf16=bf16), T_PACK[width](tflat, tv, bf16=bf16)
    assert np.array_equal(jp.cmeta, tp.cmeta) and np.array_equal(jp.tri, tp.tri)
    assert not tp.tri[:, 12 * leaf:].any()              # a row holds L triangles
    view = np.uint16 if width == 2 and bf16 else np.uint32
    assert np.array_equal(jp.cbox.view(view), tp.cbox.view(view))
    assert bool(getattr(jp, "compressed", False)) == bool(tp.compressed)


# ---- (b) the wrappers against JAX's kernels at L = 1 and 2 --------------------

def _tables(scene, leaf, width):
    """JAX's tables of one leaf size and width, carried across, and the JAX
    kernels' keywords."""
    sc, tv, flats, *_ = scene
    jflat = flats[leaf][0]
    packed = J_PACK[width](jflat, tv)
    attr = j_pt.pack_attr(jflat, sc.mat_idx, sc.mats_kd, sc.mats_ks, sc.mats_kr)
    j = tuple(jnp.asarray(a) for a in (packed.cbox, packed.cmeta, packed.tri, attr))
    T = packed_from_numpy(packed.cbox, packed.cmeta, packed.tri, attr,
                          np.zeros((1, 8), np.float32), device="cpu", leaf_size=leaf)
    jkw = dict(leaf_size=leaf, interpret=True, dual=width >= 4,
               stack_depth=j_pt.required_stack_depth(jflat.depth, width))
    return j, T, jkw


@pytest.mark.parametrize("leaf", LEAVES, ids=lambda v: f"l{v}")
@pytest.mark.parametrize("width", [2, 4])
def test_wrappers_match_jax(scene, leaf, width):
    *_, o, d = scene
    (cbox, cmeta, tri, attr), T, jkw = _tables(scene, leaf, width)
    tkw = dict(leaf_size=leaf)
    jo, jd, to, td = _jvec(o), _jvec(d), _tvec(o), _tvec(d)
    jh = j_pt.closest_tiles_full(cbox, cmeta, tri, attr, jo, jd, **jkw)
    th = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, to, td, **tkw)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy()[same]).all()
    for jv, tv_ in zip((*jh.n, *jh.kd, *jh.ks, *jh.kr), (*th.n, *th.kd, *th.ks, *th.kr)):
        np.testing.assert_allclose(tv_.numpy()[same], np.asarray(jv)[same], atol=1e-6)
    jc = j_pt.closest_tiles(cbox, cmeta, tri, jo, jd, **jkw)
    tc = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, to, td, **tkw)
    _assert_hits(jc.t, jc.idx, tc.t.numpy(), tc.idx.numpy())
    jb = np.asarray(j_pt.occluded_tiles(cbox, cmeta, tri, jo, jd, jnp.asarray(M2),
                                        **jkw)).astype(bool)
    tb = cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, to, td, torch.from_numpy(M2),
                                   **tkw).numpy()
    assert 0.05 < tb.mean() < 0.95                     # non-vacuous
    assert (jb == tb).mean() >= 0.999


@pytest.mark.parametrize("leaf", LEAVES, ids=lambda v: f"l{v}")
def test_leaf_hits_are_the_leaf8_hits(scene, leaf):
    """The same scene at L = 1 or 2 and at L = 8 finds the same triangles:
    slots differ, the slot maps take both to triangle ids."""
    sc, tv, flats, o, d = scene
    to, td = _tvec(o), _tvec(d)
    hits = {}
    for lf in (leaf, 8):
        flat = flats[lf][1]
        p = t_pack.pack_bvh4(flat, tv)
        h = cuda_trace.closest_tiles(torch.from_numpy(p.cbox), torch.from_numpy(p.cmeta),
                                     torch.from_numpy(p.tri), to, td, leaf_size=lf)
        tri_id = np.where(h.idx.numpy() >= 0, flat.slot_map[h.idx.numpy().clip(0)], -1)
        hits[lf] = (h.t.numpy(), tri_id)
    assert (hits[leaf][1] >= 0).mean() > 0.05
    assert np.array_equal(hits[leaf][0], hits[8][0])
    assert (hits[leaf][1] == hits[8][1]).mean() >= 0.999


# ---- (c) frame_tiles -----------------------------------------------------------

def test_frame_tiles_match_jax(scene):
    """frame_tiles at L = 2 on one packet against JAX's frame_tiles."""
    sc, tv, flats, o, d = scene
    (cbox, cmeta, tri, attr), T, jkw = _tables(scene, 2, 4)
    jp = j_pipeline.prepare(JConfig(width=32, height=32, use_native=False), scene=sc)
    lamb = np.asarray(j_pt.pack_lights(jp.ds))
    jkw = {k: v for k, v in jkw.items() if k != "dual"}
    # rays from above the scene, toward it
    o2 = [o[0] * 0.5, o[1] * 0.5, np.full_like(o[2], 8.0)]
    d2 = [d[0] * 0.3, d[1] * 0.3, -np.abs(d[2]) - 0.5]
    ref = j_pt.frame_tiles(cbox, cmeta, tri, attr, jnp.asarray(lamb), _jvec(o2), _jvec(d2),
                           bounces=2, **jkw)
    col = cuda_trace.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, torch.tensor(lamb),
                                 _tvec(o2), _tvec(d2), bounces=2, leaf_size=2,
                                 stack_depth=T.stack_depth)
    ref = np.stack([np.asarray(c) for c in ref], -1)
    img = np.stack([c.numpy() for c in col], -1)
    _assert_close(ref.reshape(-1, 1, 3), img.reshape(-1, 1, 3))


# ---- (d) make_tracer ---------------------------------------------------------------

def test_make_tracer_deep_stacked_tree():
    """tests/test_advice_fixes.py's deep, skinny tree (160 stacked triangles,
    leaf threshold 1, midpoint splits) at L = 2: the port's make_tracer
    finds the nearest triangle at t = 1, as JAX's does."""
    n = 160
    z = np.arange(n, dtype=np.float32)[:, None]
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tv = base[None, :, :] + np.concatenate(
        [np.zeros((n, 1, 2), np.float32), z[:, :, None]], axis=2)
    flat = flatten_bvh(build_bvh(tv, heuristic=1, max_depth=64, leaf_threshold=1), tv,
                       leaf_size=2)
    packed = j_pt.pack_bvh(flat, tv)
    R = j_pt.PACKET
    o = [np.full((R,), 0.3, np.float32), np.full((R,), 0.3, np.float32),
         np.full((R,), -1.0, np.float32)]
    d = [np.zeros((R,), np.float32), np.zeros((R,), np.float32), np.ones((R,), np.float32)]
    jclosest, _ = j_pt.make_tracer((packed.cbox, packed.cmeta, packed.tri), leaf_size=2,
                                   interpret=True,
                                   stack_depth=j_pt.required_stack_depth(flat.depth, 2))
    jh = jclosest(JVec3(*(jnp.asarray(p) for p in o)), JVec3(*(jnp.asarray(p) for p in d)))
    tclosest, _ = cuda_trace.make_tracer(
        tuple(torch.from_numpy(a) for a in (packed.cbox, packed.cmeta, packed.tri)),
        leaf_size=2)
    th = tclosest(_tvec(o), _tvec(d))
    assert th.t.shape == (R,) and th.t.dtype == torch.float32
    np.testing.assert_allclose(th.t.numpy(), 1.0, atol=1e-5)
    np.testing.assert_array_equal(th.t.numpy(), np.asarray(jh.t))
    np.testing.assert_array_equal(th.idx.numpy(), np.asarray(jh.idx))


def _prepared(leaf):
    """The port's prepare at leaf size `leaf` on the blocker scene with
    spheres (width 4, the MXU leaf asked for), and the C-matrix table the
    width-4 packer builds at this L (ops/pack.split_cmat), which prepare
    does not take below L = 4."""
    kw = dict(width=32, height=32, bounces=2, bvh_heuristic=6, tile_rows=32, tile_cols=32,
              use_native=False, leaf_size=leaf)
    sc = blocker_cloud_scene(with_spheres=True)
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    tcmat = torch.from_numpy(t_pack.split_cmat(
        t_pack.pack_bvh4(tp.flat, sc.triangle_vertices()).cmat)).view(torch.bfloat16)
    assert tp.leaf_size == leaf and tp.tables.cmat is None and not tp.mxu
    assert tp.ds.num_spheres > 0
    assert tcmat.shape == (tp.tables.tri.shape[0] * 4 * leaf, 32)
    return sc, kw, tp, tcmat


def _camera_rays():
    basis = tuple(jnp.asarray(a) for a in ray_basis(default_camera(), 32, 32))
    return generate_rays_tiled(basis, 32, 32, 32, 32)


def _shadow_rays(jo, jd, t, lp):
    """Rays from just off each hit point (t = 0 on a miss) toward the
    light, and their windows."""
    t = np.where(np.asarray(t) < 1e30, np.asarray(t), 0.0).astype(np.float32)
    p = [np.asarray(oo) + np.asarray(dd) * t for oo, dd in zip(jo, jd)]
    sd = [lp[i] - p[i] for i in range(3)]
    so = [pp + np.float32(1e-3) * c for pp, c in zip(p, sd)]
    return so, sd, sum(c * c for c in sd).astype(np.float32)


@pytest.mark.parametrize("leaf", LEAVES, ids=lambda v: f"l{v}")
def test_make_tracer_ignores_cmat(leaf):
    """make_tracer at L = 1 and 2 with attr, a trailing C-matrix table and
    dual=True gives the FP32 leaf's outputs bit for bit, with and without
    `ds`: the C-matrix table is ignored below L = 4, as JAX's wrappers
    ignore it (mxu needs leaf_size 4 or 8); closest gives HitFull with
    attr, Hit with `ds`, on flat (R,) planes; spheres only add blockers.
    frame_tiles ignores it too."""
    sc, kw, tp, tcmat = _prepared(leaf)
    T = tp.tables
    jo, jd = _camera_rays()
    to, td = _tvec(jo), _tvec(jd)
    tables = (T.cbox, T.cmeta, T.tri, T.attr)
    t_cmat = cuda_trace.make_tracer(tables + (tcmat,), leaf, dual=True)
    t_fp32 = cuda_trace.make_tracer(tables, leaf)
    t_sph = cuda_trace.make_tracer(tables + (tcmat,), leaf, ds=tp.ds, dual=True)
    f_sph = cuda_trace.make_tracer(tables, leaf, ds=tp.ds)
    th, fh = t_cmat[0](to, td), t_fp32[0](to, td)
    assert isinstance(th, cuda_trace.HitFull) and th.t.shape == (1024,)
    assert all(torch.equal(a, b) for a, b in zip(
        (th.t, th.idx, th.norm_dir, *th.n, *th.kd, *th.ks, *th.kr),
        (fh.t, fh.idx, fh.norm_dir, *fh.n, *fh.kd, *fh.ks, *fh.kr)))
    sh, fsh = t_sph[0](to, td), f_sph[0](to, td)
    assert type(sh) is cuda_trace.Hit and all(torch.equal(a, b) for a, b in zip(sh, fsh))
    assert (sh.idx >= tp.ds.num_triangles).float().mean() > 0.02     # spheres are hit
    so, sd, m2 = _shadow_rays(jo, jd, sh.t.numpy(), np.asarray(sc.lights_pos[0], np.float32))
    blocked = {k: fn[1](_tvec(so), _tvec(sd), torch.from_numpy(m2)).numpy()
               for k, fn in (("cmat", t_cmat), ("fp32", t_fp32), ("sph", t_sph))}
    assert blocked["sph"].shape == (1024,) and 0.02 < blocked["sph"].mean() < 0.98
    assert np.array_equal(blocked["cmat"], blocked["fp32"])
    assert not (blocked["fp32"] & ~blocked["sph"]).any()
    # the wrappers' own rule (JAX's leaf_size in (4, 8)), and the fused frame
    assert not cuda_trace._use_mxu(tcmat, 4, False, leaf)
    assert cuda_trace._use_mxu(tcmat, 4, False, 4)
    fkw = dict(bounces=2, leaf_size=leaf, stack_depth=T.stack_depth)
    planes = (to.reshape(8, 128), td.reshape(8, 128))
    fc = cuda_trace.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, *planes, cmat=tcmat, **fkw)
    ff = cuda_trace.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, *planes, **fkw)
    assert all(torch.equal(a, b) for a, b in zip(fc, ff))


def test_make_tracer_matches_jax():
    """make_tracer at L = 1 on the small scene with spheres, attr and a
    trailing C-matrix table (dual=True) against JAX's make_tracer on JAX's
    prepare's tables and its interleaved C-matrix table: HitFull within the
    hit bounds, attributes where idx agrees; with `ds` the sphere-merged
    hits, and the blocked masks of shadow rays."""
    leaf = 1
    sc, kw, tp, tcmat = _prepared(leaf)
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    assert len(jp.packed_dev) == 4                    # no MXU leaf at L = 1
    jcmat = _interleave_cmat(j_pt.pack_bvh4(jp.flat, sc.triangle_vertices()).cmat)
    T = tp.tables
    jo, jd = _camera_rays()
    to, td = _tvec(jo), _tvec(jd)
    jtr = dict(interpret=True, stack_depth=jp.pallas_stack_depth, dual=True)
    j_attr = j_pt.make_tracer(tuple(jp.packed_dev) + (jcmat,), leaf, **jtr)
    j_sph = j_pt.make_tracer(tuple(jp.packed_dev) + (jcmat,), leaf, ds=jp.ds, **jtr)
    tables = (T.cbox, T.cmeta, T.tri, T.attr, tcmat)
    t_attr = cuda_trace.make_tracer(tables, leaf, dual=True)
    t_sph = cuda_trace.make_tracer(tables, leaf, ds=tp.ds, dual=True)
    jh, th = j_attr[0](jo, jd), t_attr[0](to, td)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    for jv, tv_ in zip((*jh.n, *jh.kd, *jh.ks, *jh.kr), (*th.n, *th.kd, *th.ks, *th.kr)):
        np.testing.assert_allclose(tv_.numpy()[same], np.asarray(jv)[same], atol=1e-6)
    jsh, tsh = j_sph[0](jo, jd), t_sph[0](to, td)
    _assert_hits(jsh.t, jsh.idx, tsh.t.numpy(), tsh.idx.numpy())
    assert (tsh.idx.numpy() >= tp.ds.num_triangles).mean() > 0.02
    so, sd, m2 = _shadow_rays(jo, jd, jsh.t, np.asarray(sc.lights_pos[0], np.float32))
    jb = np.asarray(j_sph[1](_jvec(so), _jvec(sd), jnp.asarray(m2)))
    tb = t_sph[1](_tvec(so), _tvec(sd), torch.from_numpy(m2)).numpy()
    assert 0.02 < tb.mean() < 0.98
    assert (jb == tb).mean() >= 0.999


def test_make_tracer_refuses_rows_not_flat(scene):
    """make_tracer's closures take flat (R,) planes with R a multiple of a
    128-lane row (JAX asserts whole 1,024-ray packets; the wrappers need
    whole rows only): (8, 128) planes and 500 rays are refused, and 512
    rays give the first 512 of the 1,024-ray call's hits."""
    *_, o, d = scene
    _, T, _ = _tables(scene, 1, 4)
    closest, occluded = cuda_trace.make_tracer((T.cbox, T.cmeta, T.tri), 1)
    with pytest.raises(ValueError, match="flat"):
        closest(_tvec(o), _tvec(d))
    fo, fd = _tvec([x.reshape(-1) for x in o]), _tvec([x.reshape(-1) for x in d])
    with pytest.raises(ValueError, match="flat"):
        occluded(TVec3(*(p[:500] for p in fo)), TVec3(*(p[:500] for p in fd)),
                 torch.ones(500))
    whole, half = closest(fo, fd), closest(TVec3(*(p[:512] for p in fo)),
                                           TVec3(*(p[:512] for p in fd)))
    assert all(torch.equal(a[:512], b) for a, b in zip(whole, half))


def test_pass_render_frame_of_whole_rows():
    """The pass-based render() of a frame of 8x16 tiles, 768 rays (whole
    128-lane rows, not whole 1,024-ray packets), through make_tracer: the
    brute-force frame within tests/test_fused.py's bounds."""
    kw = dict(width=48, height=16, tile_rows=8, tile_cols=16, bounces=2, bvh_heuristic=6,
              use_native=False, mxu_leaf=False)
    tp = t_pipeline.prepare(TConfig(**kw), scene=synthetic_scene(250, seed=3), device="cpu")
    assert tp.resolved_variant() == "pallas"
    img = tp.render().numpy()
    assert img.shape == (16, 48, 3) and img.std() > 0.01
    _assert_close(tp.render(variant="bruteforce").numpy(), img)


# ---- (e) prepare, the build -----------------------------------------------------

PREPARE = {"w2": dict(bvh_width=2), "w4": {}, "w8": dict(bvh_width=8),
           "w4_bf16": dict(bf16_bvh=True), "w2_bf16": dict(bvh_width=2, bf16_bvh=True)}


@pytest.mark.parametrize("leaf", LEAVES, ids=lambda v: f"l{v}")
@pytest.mark.parametrize("case", list(PREPARE))
def test_prepare_as_jax(case, leaf):
    """prepare(leaf_size=1|2) packs JAX's prepare's tables bit for bit, with
    leaves of at least L triangles, and takes the FP32 leaf where JAX's
    does (every table: JAX takes the MXU leaf at L = 4 and 8 only)."""
    kw = dict(width=32, height=32, bvh_heuristic=6, tile_rows=32, tile_cols=32,
              use_native=False, leaf_size=leaf, **PREPARE[case])
    sc = synthetic_scene(500, seed=3)
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    T = tp.tables
    assert jp.leaf_size == tp.leaf_size == T.leaf_size == leaf
    assert T.compressed == jp.compressed
    jcbox = np.asarray(jp.packed_dev[0])
    view = np.uint16 if jcbox.dtype.itemsize == 2 else np.uint32
    tcbox = T.cbox.view(torch.int16).numpy() if T.cbox.dtype == torch.bfloat16 else T.cbox.numpy()
    assert np.array_equal(tcbox.view(view), jcbox.view(view))
    for jt, tt in zip(jp.packed_dev[1:4], (T.cmeta, T.tri, T.attr)):
        assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert len(jp.packed_dev) == 4 and not tp.mxu and T.cmat is None
    assert np.array_equal(jp.flat.slot_map, tp.flat.slot_map)


def test_build_units_no_mxu_below_leaf4():
    """_build compiles every FP32 tier unit at L = 8, 4, 2 and 1 and the MXU
    units at L = 8 and 4 only (no MXU symbol exists at L = 1 or 2)."""
    for leaf in (1, 2):
        units = [u for u in _build.UNITS if u.endswith(f".l{leaf}")]
        assert sorted(u[:-3] for u in units) == sorted(_build.FP32_SOURCES)
        assert not any(u[:-3] in _build.MXU_SOURCES for u in units)
    for src in _build.MXU_SOURCES:
        assert src in _build.UNITS and f"{src}.l4" in _build.UNITS
    assert set(_build.LEAF_SIZES) == set(cuda_trace.LEAF_SIZES)
    assert set(_build.MXU_LEAF_SIZES) == set(cuda_trace.MXU_LEAF_SIZES)

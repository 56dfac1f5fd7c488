"""Leaf size 4 in the port against the JAX package.

- (a) Tables at L = 4: build_cmat, the packers' f32 and bf16 tables and
  their C-matrices, split_cmat and pack_cmi4 give JAX's bit for bit
  (uint32 / uint16 views), at widths 2, 4 and 8.
- (b) The wrappers at L = 4 (on the CPU their plain versions) against JAX's
  closest_tiles / closest_tiles_full / occluded_tiles in interpret mode on
  one packet of 1,024 rays: widths 2, 4 and 8 with f32 boxes and widths 2
  and 4 with bf16 boxes (the raw bf16 binary table at width 2, pair rows
  at 4); tests/test_torch_leaf4_mxu.py has the pair rows at width 8 and the
  MXU leaf. The L = 4 hits are also the L = 8 tables' hits, slot for slot
  through the slot maps.
- (c) prepare(leaf_size=4) against JAX's prepare (use_native=False) at
  widths 2, 4 and 8 and bf16: the same tables bit for bit (cbox, cmeta,
  tri, attr and the uploaded C-matrix table), the same MXU decision.
- (d) frame_tiles at L = 4 against JAX's frame_tiles on one packet (the
  whole frames are in tests/test_torch_leaf4_mxu.py), the refusal of leaf
  sizes the kernels do not hold, and the launch keys.

Bounds as tests/test_torch_trace.py (hits: miss masks equal, t within atol
1e-4 / rtol 1e-5, idx agreement >= 0.999, attributes equal where idx
agrees, blocked agreement >= 0.999) and tests/test_fused.py (frames: more
than 99% of pixels within 1e-3, median below 1e-5). JAX's interpret-mode
results are computed once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import _assert_close
from test_torch_mxu import _bits, _interleave_cmat
from test_torch_trace import _assert_hits, _jvec, _tvec
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.scene import synthetic_scene
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops.bvh import build_bvh
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.ops import pack as t_pack
from parallel_ray_tracer_tpu_torch.ops.bvh import build_bvh as t_build
from parallel_ray_tracer_tpu_torch.ops.bvh_flat import flatten_bvh as t_flatten

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

L = 4
J_PACK = {2: j_pt.pack_bvh, 4: j_pt.pack_bvh4, 8: j_pt.pack_bvh8}
T_PACK = {2: t_pack.pack_bvh, 4: t_pack.pack_bvh4, 8: t_pack.pack_bvh8}


@pytest.fixture(scope="module")
def scene():
    """The synthetic scene of tests/test_kernel_variants.py's leaf-4 test,
    flattened at L = 4 (and at L = 8) by both packages' builders, and one
    packet of 1,024 random rays."""
    sc = synthetic_scene(2000, seed=3)
    tv = sc.triangle_vertices()
    flats = {}
    for leaf in (4, 8):
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


def test_build_cmat_identical():
    rng = np.random.RandomState(5)
    G, S = 9, 9 * L
    v0, e1, e2 = (rng.normal(size=(S, 3)).astype(np.float32) for _ in range(3))
    n = np.cross(e1, e2)
    sm = np.arange(S)
    sm[rng.rand(S) < 0.2] = -1
    a = j_pt._build_cmat(v0, e1, e2, n, sm, G, L)
    b = t_pack.build_cmat(v0, e1, e2, n, sm, G, L)
    assert a.shape == b.shape == ((G + 1) * 4 * L, 16)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_packers_identical(scene, width, bf16):
    _, tv, flats, *_ = scene
    jflat, tflat = flats[L]
    assert np.array_equal(jflat.slot_map, tflat.slot_map)
    jp, tp = J_PACK[width](jflat, tv, bf16=bf16), T_PACK[width](tflat, tv, bf16=bf16)
    assert np.array_equal(jp.cmeta, tp.cmeta) and np.array_equal(jp.tri, tp.tri)
    assert not tp.tri[:, 12 * L:].any()            # a row holds 4 triangles
    assert np.array_equal(jp.cbox.view(np.uint16 if width == 2 and bf16 else np.uint32),
                          tp.cbox.view(np.uint16 if width == 2 and bf16 else np.uint32))
    assert np.array_equal(jp.cmat.view(np.uint32), tp.cmat.view(np.uint32))
    assert tp.cmat.shape == (tp.tri.shape[0] * 4 * L, 16)


@pytest.mark.parametrize("width", [4, 8])
def test_split_cmat_and_cmi4_identical(scene, width):
    _, tv, flats, *_ = scene
    jp, tp = J_PACK[width](flats[L][0], tv), T_PACK[width](flats[L][1], tv)
    assert np.array_equal(_bits(_interleave_cmat(jp.cmat)), t_pack.split_cmat(tp.cmat))
    assert np.array_equal(_bits(j_pt.pack_cmi4(jp.cmat, L)), t_pack.pack_cmi4(tp.cmat, L))


# ---- (b) the wrappers against JAX's kernels at L = 4 -------------------------

_TABLES = {}


def _tables(scene, width, bf16=False, mxu=False):
    """JAX's L = 4 tables of one width and box format (bf16: pair rows at 4
    and 8, compressed; the raw bf16 binary table at 2), carried across, and
    the JAX kernels' keywords; made once per case."""
    key = (width, bf16, mxu)
    if key in _TABLES:
        return _TABLES[key]
    sc, tv, flats, *_ = scene
    jflat = flats[L][0]
    packed = J_PACK[width](jflat, tv, bf16=bf16)
    attr = j_pt.pack_attr(jflat, sc.mat_idx, sc.mats_kd, sc.mats_ks, sc.mats_kr)
    compressed = bool(getattr(packed, "compressed", False))
    cmi = _interleave_cmat(packed.cmat) if mxu else None
    j = tuple(jnp.asarray(a) for a in (packed.cbox, packed.cmeta, packed.tri, attr))
    T = packed_from_numpy(packed.cbox, packed.cmeta, packed.tri, attr,
                          np.zeros((1, 8), np.float32), device="cpu", leaf_size=L,
                          compressed=compressed,
                          cmat=None if cmi is None else np.asarray(cmi))
    jkw = dict(leaf_size=L, interpret=True, dual=width >= 4, compressed=compressed,
               stack_depth=j_pt.required_stack_depth(jflat.depth, width))
    _TABLES[key] = (j, cmi, T, jkw)
    return _TABLES[key]


# (width, bf16 boxes, MXU leaf)
CASES = {"w2": (2, False, False), "w4": (4, False, False), "w8": (8, False, False),
         "w2_bf16": (2, True, False), "w4_bf16": (4, True, False)}
M2 = np.full((8, 128), 25.0, np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_wrappers_match_jax(scene, case):
    check_wrappers(scene, CASES[case])


def check_wrappers(scene, case):
    """closest_tiles, closest_tiles_full and occluded_tiles at L = 4 on the
    tables of `case` (width, bf16, mxu)."""
    *_, o, d = scene
    (cbox, cmeta, tri, attr), cmi, T, jkw = _tables(scene, *case)
    tkw = dict(leaf_size=L, compressed=T.compressed, cmat=T.cmat)
    jo, jd, to, td = _jvec(o), _jvec(d), _tvec(o), _tvec(d)
    jh = j_pt.closest_tiles_full(cbox, cmeta, tri, attr, jo, jd, cmat=cmi, **jkw)
    th = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, to, td, **tkw)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy()[same]).all()
    for jv, tv_ in zip((*jh.n, *jh.kd, *jh.ks, *jh.kr), (*th.n, *th.kd, *th.ks, *th.kr)):
        np.testing.assert_allclose(tv_.numpy()[same], np.asarray(jv)[same], atol=1e-6)
    jc = j_pt.closest_tiles(cbox, cmeta, tri, jo, jd, cmat=cmi, **jkw)
    tc = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, to, td, **tkw)
    _assert_hits(jc.t, jc.idx, tc.t.numpy(), tc.idx.numpy())
    jb = np.asarray(j_pt.occluded_tiles(cbox, cmeta, tri, jo, jd, jnp.asarray(M2),
                                        cmat=cmi, **jkw)).astype(bool)
    tb = cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, to, td, torch.from_numpy(M2),
                                   **tkw).numpy()
    assert 0.05 < tb.mean() < 0.95                     # non-vacuous
    assert (jb == tb).mean() >= 0.999


def test_leaf4_hits_are_the_leaf8_hits(scene):
    """The same tree at L = 4 and L = 8 finds the same triangles: slots
    differ, the slot maps take both to triangle ids."""
    sc, tv, flats, o, d = scene
    to, td = _tvec(o), _tvec(d)
    hits = {}
    for leaf in (4, 8):
        flat = flats[leaf][1]
        p = t_pack.pack_bvh4(flat, tv)
        h = cuda_trace.closest_tiles(torch.from_numpy(p.cbox), torch.from_numpy(p.cmeta),
                                     torch.from_numpy(p.tri), to, td, leaf_size=leaf)
        tri_id = np.where(h.idx.numpy() >= 0, flat.slot_map[h.idx.numpy().clip(0)], -1)
        hits[leaf] = (h.t.numpy(), tri_id)
    assert (hits[4][1] >= 0).mean() > 0.05
    assert np.array_equal(hits[4][0], hits[8][0])
    assert (hits[4][1] == hits[8][1]).mean() >= 0.999


# ---- (c) prepare ------------------------------------------------------------

PREPARE = {"w2": dict(bvh_width=2), "w4": {}, "w8": dict(bvh_width=8),
           "w4_bf16": dict(bf16_bvh=True), "w2_bf16": dict(bvh_width=2, bf16_bvh=True)}


@pytest.mark.parametrize("case", list(PREPARE))
def test_prepare_as_jax(case):
    """prepare(leaf_size=4) packs JAX's prepare's tables bit for bit, and
    takes the MXU leaf where JAX's does (widths 4 and 8)."""
    kw = dict(width=32, height=32, bvh_heuristic=6, tile_rows=32, tile_cols=32,
              use_native=False, leaf_size=L, **PREPARE[case])
    sc = synthetic_scene(2000, seed=3)
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    T = tp.tables
    assert jp.leaf_size == tp.leaf_size == T.leaf_size == L
    assert tp.tables.compressed == jp.compressed
    jcbox = np.asarray(jp.packed_dev[0])
    view = np.uint16 if jcbox.dtype.itemsize == 2 else np.uint32
    tcbox = T.cbox.view(torch.int16).numpy() if T.cbox.dtype == torch.bfloat16 else T.cbox.numpy()
    assert np.array_equal(tcbox.view(view), jcbox.view(view))
    for jt, tt in zip(jp.packed_dev[1:4], (T.cmeta, T.tri, T.attr)):
        assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert tp.mxu == (len(jp.packed_dev) == 5)
    if tp.mxu:
        assert T.cmat.shape == (T.tri.shape[0] * 4 * L, 32)
        assert np.array_equal(T.cmat.view(torch.int16).numpy().view(np.uint16),
                              _bits(jp.packed_dev[4]))


# ---- (d) frame_tiles, refusals, keys ------------------------------------------------

def test_frame_tiles_match_jax(scene):
    """frame_tiles at L = 4 on one packet against JAX's frame_tiles."""
    sc, tv, flats, o, d = scene
    (cbox, cmeta, tri, attr), _, T, jkw = _tables(scene, 4)
    jp = j_pipeline.prepare(JConfig(width=32, height=32, use_native=False), scene=sc)
    lamb = np.asarray(j_pt.pack_lights(jp.ds))
    jkw = {k: v for k, v in jkw.items() if k != "dual"}
    # rays from above the scene, toward it
    o2 = [o[0] * 0.5, o[1] * 0.5, np.full_like(o[2], 8.0)]
    d2 = [d[0] * 0.3, d[1] * 0.3, -np.abs(d[2]) - 0.5]
    ref = j_pt.frame_tiles(cbox, cmeta, tri, attr, jnp.asarray(lamb), _jvec(o2), _jvec(d2),
                           bounces=2, **jkw)
    col = cuda_trace.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, torch.tensor(lamb),
                                 _tvec(o2), _tvec(d2), bounces=2, leaf_size=L,
                                 stack_depth=T.stack_depth)
    ref = np.stack([np.asarray(c) for c in ref], -1)
    img = np.stack([c.numpy() for c in col], -1)
    _assert_close(ref.reshape(-1, 1, 3), img.reshape(-1, 1, 3))


@pytest.mark.parametrize("leaf_size", [1, 2, 3, 16])
def test_other_leaf_sizes_refused(leaf_size):
    """The kernels hold 1, 2, 4 or 8 triangles a group (every power of two
    whose triangles fit a 128-lane row, as JAX's _pick_leaf_size): leaf
    sizes 1 and 2 are accepted by prepare and by the wrappers, 3 and 16
    refused, on every device."""
    o = cuda_trace.Vec3(*(torch.zeros((8, 128)) for _ in range(3)))
    tables = (torch.zeros((2, 32)), torch.zeros((2, 8), dtype=torch.int32),
              torch.zeros((2, 128)))
    if leaf_size in (1, 2):
        p = t_pipeline.prepare(TConfig(width=32, height=32, leaf_size=leaf_size,
                                       synthetic_triangles=64, use_native=False),
                               device="cpu")
        assert p.leaf_size == p.tables.leaf_size == leaf_size
        assert not bool(p.tables.tri[:, 12 * leaf_size:].any())
        h = cuda_trace.closest_tiles(*tables, o, o, leaf_size=leaf_size)
        assert bool((h.idx == -1).all())
        return
    with pytest.raises(NotImplementedError, match="leaf_size"):
        t_pipeline.prepare(TConfig(width=32, height=32, leaf_size=leaf_size), device="cpu")
    with pytest.raises(NotImplementedError, match="leaf_size"):
        cuda_trace.closest_tiles(*tables, o, o, leaf_size=leaf_size)


def test_launch_keys_name_the_leaf_size():
    """A launch at L = 4, 2 or 1 is counted under its own key
    ("frame_mxu<4,l4>", "frame<4,l2>", "closest_stream<8,bf16,l1>"), the
    L = 8 keys keep their names, and the MXU instances have keys at L = 8
    and 4 only."""
    assert cuda_trace._instance("frame", 4, cuda_trace.BOX_F32, mxu=True,
                                leaf_size=4) == "frame_mxu<4,l4>"
    assert cuda_trace._instance("closest", 8, cuda_trace.BOX_PAIRS, deep=True,
                                leaf_size=4) == "closest<8,bf16,deep,l4>"
    assert cuda_trace._instance("frame", 4, cuda_trace.BOX_F32, mxu=True) == "frame_mxu<4>"
    assert cuda_trace._instance("frame", 4, cuda_trace.BOX_F32, leaf_size=2) == "frame<4,l2>"
    assert cuda_trace._instance("closest", 8, cuda_trace.BOX_PAIRS, stream=True,
                                leaf_size=1) == "closest_stream<8,bf16,l1>"
    keys = list(cuda_trace.LAUNCHES)
    l8 = [k for k in keys if not k.endswith((",l4>", ",l2>", ",l1>"))]
    assert sum(k.endswith(",l4>") for k in keys) == len(l8)
    fp32 = [k for k in l8 if "_mxu<" not in k]
    for tag in (",l2>", ",l1>"):
        assert sorted(k for k in keys if k.endswith(tag)) == sorted(k[:-1] + tag for k in fp32)

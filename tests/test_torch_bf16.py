"""bf16 node boxes in the port against the JAX package.

- The port's pack_box_bf16_pairs and pack_bvh / pack_bvh4 / pack_bvh8 with
  bf16=True give JAX's tables bit for bit (uint32 views, NaN rows included;
  the width-2 table as uint16 against JAX's ml_dtypes array), and the pairs
  decoded as the kernels decode them enclose the f32 boxes.
- convert.packed_from_numpy keeps a JAX width-2 bf16 table 16-bit and
  refuses the combinations JAX asserts against; the wrappers route a bf16
  or compressed table to its instance and refuse the same combinations.
- The wrappers on tables carried across from JAX's bf16 state against JAX's
  kernels on that state, in interpret mode:
    - w2_bf16: _closest_kernel, _closest_attr_kernel, _occluded_kernel on
      the raw bf16 binary table;
    - w4_bf16_dual: the dual-pop kernels with compressed=True;
    - w8_bf16_single: _closest4_kernel, _closest_attr_kernel and
      _occluded4_kernel at arity 8 with compressed=True.
  On the CPU the port runs the plain versions, which read no node table.
- prepare(bf16_bvh=True) at widths 2, 4 and 8 gives the JAX prepare's
  (use_native=False) compressed flag and cbox bits, and a width-4 bf16
  frame matches JAX render(variant="fused", interpret=True).

Bounds as tests/test_torch_trace.py (hits) and tests/test_fused.py (frames).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from test_torch_arity import FRAME, PACK_SCENES, W, H, flats  # noqa: F401
from test_torch_frame import _assert_close
from test_torch_trace import _assert_hits, _jvec, _shadow_rays_from, _tvec
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.camera import default_camera, ray_basis
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops.render import generate_rays_tiled
from parallel_ray_tracer_tpu_torch import _build
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.ops import pack as t_pack

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

J_PACK = {2: j_pt.pack_bvh, 4: j_pt.pack_bvh4, 8: j_pt.pack_bvh8}
T_PACK = {2: t_pack.pack_bvh, 4: t_pack.pack_bvh4, 8: t_pack.pack_bvh8}

# ---- packers ---------------------------------------------------------------


@pytest.mark.parametrize("width", [2, 4, 8])
def test_bf16_packer_identical(flats, width):  # noqa: F811
    tv, jflat, tflat = flats
    jp, tp = J_PACK[width](jflat, tv, bf16=True), T_PACK[width](tflat, tv, bf16=True)
    assert tp.compressed == bool(getattr(jp, "compressed", False)) == (width != 2)
    for f in ("cmeta", "tri"):
        assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
    if width == 2:
        assert jp.cbox.dtype.name == "bfloat16" and tp.cbox.dtype == np.uint16
        assert np.array_equal(jp.cbox.view(np.uint16), tp.cbox)
    else:
        assert jp.cbox.dtype == tp.cbox.dtype == np.float32
        assert np.array_equal(jp.cbox.view(np.uint32), tp.cbox.view(np.uint32))
        # pack_box_bf16_pairs on its own, on the f32 table
        f32 = T_PACK[width](tflat, tv).cbox
        assert np.array_equal(t_pack.pack_box_bf16_pairs(f32, width).view(np.uint32),
                              j_pt.pack_box_bf16_pairs(f32, width).view(np.uint32))


@pytest.mark.parametrize("width", [4, 8])
def test_pairs_enclose_f32_boxes(flats, width):  # noqa: F811
    """Decoded as the kernels decode them, the pairs enclose the f32 boxes of
    valid children; absent children stay NaN."""
    tv, _, tflat = flats
    pf, pc = T_PACK[width](tflat, tv), T_PACK[width](tflat, tv, bf16=True)
    mn, mx = t_pack.unpack_box_bf16_pairs(pc.cbox, width)
    lo = pf.cbox[:, :6 * width].reshape(-1, width, 6)[..., :3]
    hi = pf.cbox[:, :6 * width].reshape(-1, width, 6)[..., 3:]
    valid = pf.cmeta[:, width:2 * width] > 0
    assert valid.any()
    assert (mn[valid] <= lo[valid]).all() and (mx[valid] >= hi[valid]).all()
    assert np.isnan(mn[~valid]).all() and np.isnan(mx[~valid]).all()
    assert not pc.cbox[:, 3 * width:].view(np.uint32).any()  # lanes past 3A


# ---- carrying tables across, and the wrappers' routing ----------------------


def _small_tables(width, bf16):
    sc = PACK_SCENES["synthetic2000"]()
    cfg = JConfig(width=32, height=32, bvh_heuristic=6, use_native=False,
                  mxu_leaf=False, bvh_width=width, bf16_bvh=bf16)
    jp = j_pipeline.prepare(cfg, scene=sc)
    return jp, [np.asarray(a) for a in jp.packed_dev[:4]], np.asarray(j_pt.pack_lights(jp.ds))


def test_jax_bf16_binary_table_stays_16_bit():
    jp, (cbox, cmeta, tri, attr), lamb = _small_tables(2, True)
    assert cbox.dtype.name == "bfloat16" and not jp.compressed
    for arr in (cbox, cbox.view(np.uint16), cbox.view(np.int16)):
        T = packed_from_numpy(arr, cmeta, tri, attr, lamb, device="cpu")
        assert T.cbox.dtype == torch.bfloat16 and not T.compressed and T.arity == 2
        assert np.array_equal(T.cbox.view(torch.int16).numpy().view(np.uint16),
                              cbox.view(np.uint16))
    with pytest.raises(ValueError, match="compressed"):
        packed_from_numpy(cbox, cmeta, tri, attr, lamb, device="cpu", compressed=True)
    with pytest.raises(ValueError, match="bf16"):
        packed_from_numpy(cbox.view(np.float16), cmeta, tri, attr, lamb, device="cpu")


@pytest.mark.parametrize("width", [4, 8])
def test_16_bit_table_at_width_4_or_8_raises(width):
    cbox = np.zeros((3, 8 * width), np.uint16)
    cmeta = np.zeros((3, t_pack.META_WIDTH[width]), np.int32)
    tri = np.zeros((2, 128), np.float32)
    with pytest.raises(ValueError, match="binary table"):
        packed_from_numpy(cbox, cmeta, tri, tri, np.zeros((1, 8), np.float32),
                          device="cpu")
    # and the wrappers refuse a bf16 tensor of that width
    o = cuda_trace.Vec3(*(torch.zeros((1, 128)) for _ in range(3)))
    with pytest.raises(ValueError, match="binary table"):
        cuda_trace.closest_tiles(torch.from_numpy(cbox.view(np.int16)).view(torch.bfloat16),
                                 torch.from_numpy(cmeta), torch.from_numpy(tri), o, o,
                                 leaf_size=8)


def test_wrappers_refuse_compressed_binary_table():
    _, (cbox, cmeta, tri, attr), lamb = _small_tables(2, False)
    T = packed_from_numpy(cbox, cmeta, tri, attr, lamb, device="cpu")
    o = cuda_trace.Vec3(*(torch.zeros((1, 128)) for _ in range(3)))
    for fn, args in (
        (cuda_trace.closest_tiles, (T.cbox, T.cmeta, T.tri, o, o)),
        (cuda_trace.closest_tiles_full, (T.cbox, T.cmeta, T.tri, T.attr, o, o)),
        (cuda_trace.occluded_tiles, (T.cbox, T.cmeta, T.tri, o, o, o.x)),
    ):
        with pytest.raises(ValueError, match="compressed"):
            fn(*args, leaf_size=8, compressed=True)
    with pytest.raises(ValueError, match="compressed"):
        packed_from_numpy(cbox, cmeta, tri, attr, lamb, device="cpu", compressed=True)


def test_box_format_routing():
    """Each table picks its instance: the LAUNCHES key a CUDA launch counts."""
    cases = {(2, False, torch.float32): "closest<2>",
             (2, False, torch.bfloat16): "closest<2,bf16>",
             (4, False, torch.float32): "closest<4>",
             (4, True, torch.float32): "closest<4,bf16>",
             (8, True, torch.float32): "closest<8,bf16>"}
    for (arity, compressed, dtype), key in cases.items():
        cbox = torch.zeros((2, {2: 16, 4: 32, 8: 64}[arity]), dtype=dtype)
        a, box = cuda_trace._box_format(cbox, compressed)
        assert cuda_trace._instance("closest", a, box) == key
        assert key in cuda_trace.LAUNCHES


def test_cuda_branch_raises_when_the_kernels_cannot_build(monkeypatch, tmp_path):
    """What a CUDA tensor reaches first: the library build. Without nvcc it
    raises; nothing falls back to the plain versions."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    cmeta = torch.zeros((2, 8), dtype=torch.int32)
    cmeta[0, 0], cmeta[0, 4] = -1, 1
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_trace._launch_setup(cmeta, 4, None, False)


# ---- traversal kernels on JAX's bf16 state ----------------------------------

# (bvh_width, dual, repack at width 8 with pack_bvh8(bf16=True))
BF16_CASES = {
    "w2_bf16": (2, False),          # _closest_kernel, _closest_attr_kernel, _occluded_kernel
    "w4_bf16_dual": (4, True),      # _closest_dual_kernel(0, 12), _occluded_dual_kernel
    "w8_bf16_single": (8, False),   # _closest4_kernel, _closest_attr_kernel, _occluded4_kernel
}


@pytest.fixture(scope="module", params=sorted(BF16_CASES))
def case(request):
    width, dual = BF16_CASES[request.param]
    sc = blocker_cloud_scene()
    cfg = JConfig(width=W, height=H, bvh_heuristic=6, use_native=False,
                  mxu_leaf=False, tile_rows=8, tile_cols=128, bvh_width=width,
                  bf16_bvh=True)
    jp = j_pipeline.prepare(cfg, scene=sc)
    cbox, cmeta, tri, attr = jp.packed_dev[:4]
    compressed = jp.compressed
    if width == 8:
        # JAX's prepare keeps width 8 in f32; its pair kernels are reached
        # through pack_bvh8(bf16=True), as tests/test_kernel_variants.py does
        assert not compressed and cbox.dtype == jnp.float32
        packed = j_pt.pack_bvh8(jp.flat, sc.triangle_vertices(), bf16=True)
        cbox, cmeta, compressed = jnp.asarray(packed.cbox), jnp.asarray(packed.cmeta), True
    assert compressed == (width != 2)
    T = packed_from_numpy(
        *(np.asarray(a) for a in (cbox, cmeta, tri, attr)),
        np.asarray(j_pt.pack_lights(jp.ds)), device="cpu", leaf_size=jp.leaf_size,
        compressed=compressed,
    )
    assert T.cbox.dtype == (torch.bfloat16 if width == 2 else torch.float32)
    basis = tuple(jnp.asarray(a) for a in ray_basis(default_camera(), W, H))
    o, d = generate_rays_tiled(basis, W, H, 8, 128)
    rows = o.x.shape[0] // 128
    o = [np.asarray(p).reshape(rows, 128) for p in o]
    d = [np.asarray(p).reshape(rows, 128) for p in d]
    jkw = dict(leaf_size=jp.leaf_size, interpret=True, dual=dual,
               stack_depth=jp.pallas_stack_depth, compressed=compressed)
    return (cbox, cmeta, tri, attr), T, o, d, jkw


def test_closest(case):
    (cbox, cmeta, tri, _), T, o, d, jkw = case
    jh = j_pt.closest_tiles(cbox, cmeta, tri, _jvec(o), _jvec(d), **jkw)
    th = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, _tvec(o), _tvec(d),
                                  leaf_size=T.leaf_size, compressed=T.compressed)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy()[same]).all()


def test_closest_full(case):
    (cbox, cmeta, tri, attr), T, o, d, jkw = case
    jh = j_pt.closest_tiles_full(cbox, cmeta, tri, attr, _jvec(o), _jvec(d), **jkw)
    th = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, _tvec(o),
                                       _tvec(d), leaf_size=T.leaf_size,
                                       compressed=T.compressed)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    for jv, tv in zip((jh.n, jh.kd, jh.ks, jh.kr), (th.n, th.kd, th.ks, th.kr)):
        for a, b in zip(jv, tv):
            assert (np.asarray(a)[same] == b.numpy()[same]).all()


def test_occluded_reversed_shadows(case):
    (cbox, cmeta, tri, _), T, o, d, jkw = case
    h = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, _tvec(o), _tvec(d),
                                 leaf_size=T.leaf_size, compressed=T.compressed)
    so, sd, m2 = _shadow_rays_from(h.t.numpy(), o, d)
    jb = np.asarray(j_pt.occluded_tiles(cbox, cmeta, tri, _jvec(so), _jvec(sd),
                                        jnp.asarray(m2), **jkw))
    tb = cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, _tvec(so), _tvec(sd),
                                   torch.from_numpy(m2), leaf_size=T.leaf_size,
                                   compressed=T.compressed)
    assert 0.0 < jb.mean() < 1.0  # non-vacuous: some rays are blocked
    assert (jb == tb.numpy()).mean() >= 0.999


# ---- prepare and whole frames -----------------------------------------------


@pytest.mark.parametrize("width", [2, 4, 8])
def test_prepare_bf16_as_jax(width):
    """The tables JAX's prepare (use_native=False) packs for bf16_bvh: pairs
    at width 4, the raw bf16 binary table at width 2, f32 at width 8."""
    sc = PACK_SCENES["synthetic2000"]()
    kw = dict(width=32, height=32, bvh_heuristic=6, use_native=False,
              mxu_leaf=False, bvh_width=width, bf16_bvh=True)
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    assert tp.tables.compressed == jp.compressed == (width == 4)
    jcbox = np.asarray(jp.packed_dev[0])
    tcbox = tp.tables.cbox
    if width == 2:
        assert tcbox.dtype == torch.bfloat16
        assert np.array_equal(tcbox.view(torch.int16).numpy().view(np.uint16),
                              jcbox.view(np.uint16))
    else:
        assert tcbox.dtype == torch.float32 and jcbox.dtype == np.float32
        assert np.array_equal(tcbox.numpy().view(np.uint32), jcbox.view(np.uint32))
    assert np.array_equal(tp.tables.cmeta.numpy(), np.asarray(jp.packed_dev[1]))


def test_frame_bf16_matches_jax():
    kw = dict(FRAME, bvh_width=4, bf16_bvh=True)
    sc = blocker_cloud_scene()
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    assert tp.tables.compressed and tp.resolved_variant() == "fused"
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    assert jp.compressed
    ref = np.asarray(jp.render(variant="fused", interpret=True))
    _assert_close(ref, tp.render().numpy())

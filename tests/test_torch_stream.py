"""Streamed leaf rows in the port against the JAX package.

- The streamed wrappers (stream=True; on the CPU their plain versions) against
  JAX's streamed kernels, make_tracer(..., stream=True, interpret=True), on
  the 2,000-triangle synthetic scene (seed 3) at width 4: closest_full and
  occluded (_closest_stream_kernel(n_attr=12), _occluded_stream_kernel), and
  closest on the bf16 pair rows (_closest_stream_kernel(n_attr=0),
  compressed=True).
- prepare decides `stream` by JAX's rule (stream_decision against JAX's
  prepare, with both ceilings patched low so that a tiny scene streams), and
  a streamed pipeline renders "auto" by the pass-based path, as JAX does.
- A 64x32, 2-bounce render with stream="on" against JAX's
  render(variant="pallas", interpret=True) with stream="on".
- Padding to whole blocks, and the refusals: streaming at width 2, an
  unpadded table; bf16 boxes streamed; the command line with --stream on.

Bounds: hits as tests/test_torch_trace.py (miss masks equal, t within atol
1e-4 / rtol 1e-5, idx agreement >= 0.999), attributes within 1e-6 where idx
agrees, blocked equal; frames as tests/test_fused.py.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REF = dict(use_native=False, mxu_leaf=False)


# ---- the streamed wrappers against JAX's streamed kernels -------------------


@pytest.fixture(scope="module")
def streamed():
    """JAX's width-4 tables of the 2,000-triangle scene (seed 3), as
    tests/test_kernel_variants.py builds them, carried across padded; 1,024
    random rays (seed 0)."""
    sc = synthetic_scene(2000, seed=3)
    tv = sc.triangle_vertices()
    flat = flatten_bvh(build_bvh(tv, heuristic=6, leaf_threshold=8), tv, leaf_size=8)
    packed = j_pt.pack_bvh4(flat, tv)
    attr = j_pt.pack_attr(flat, sc.mat_idx, sc.mats_kd, sc.mats_ks, sc.mats_kr)
    sd = j_pt.required_stack_depth(flat.depth, 4)
    rng = np.random.RandomState(0)
    o = [rng.uniform(-6, 6, 1024).astype(np.float32) for _ in range(3)]
    dn = rng.normal(size=(3, 1024)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    d = list(dn)
    T = packed_from_numpy(
        packed.cbox, packed.cmeta, t_pack.pad_stream_rows(packed.tri),
        t_pack.pad_stream_rows(attr), np.zeros((1, 8), np.float32), device="cpu")
    jargs = (jnp.asarray(packed.cbox), jnp.asarray(packed.cmeta),
             jnp.asarray(packed.tri), jnp.asarray(attr))
    return flat, tv, jargs, sd, T, o, d


def _j(planes):
    return JVec3(*(jnp.asarray(p) for p in planes))


def _t(planes):
    return _tvec([p.reshape(8, 128) for p in planes])


def test_closest_full_stream_matches_jax(streamed):
    _, _, jargs, sd, T, o, d = streamed
    closest, _ = j_pt.make_tracer(jargs, 8, interpret=True, stack_depth=sd, stream=True)
    jh = closest(_j(o), _j(d))
    th = cuda_trace.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, _t(o), _t(d),
                                       leaf_size=8, stream=True)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy().ravel(), th.idx.numpy().ravel())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy().ravel()[same]).all()
    for jv, tv in zip((jh.n, jh.kd, jh.ks, jh.kr), (th.n, th.kd, th.ks, th.kr)):
        for a, b in zip(jv, tv):
            np.testing.assert_allclose(b.numpy().ravel()[same], np.asarray(a)[same],
                                       atol=1e-6, rtol=0)


def test_occluded_stream_matches_jax(streamed):
    _, _, jargs, sd, T, o, d = streamed
    _, occluded = j_pt.make_tracer(jargs[:3], 8, interpret=True, stack_depth=sd,
                                   stream=True)
    m2 = np.full(1024, 25.0, np.float32)
    jb = np.asarray(occluded(_j(o), _j(d), jnp.asarray(m2)))
    tb = cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, _t(o), _t(d),
                                   torch.from_numpy(m2.reshape(8, 128)), leaf_size=8,
                                   stream=True)
    assert 0.0 < jb.mean() < 1.0  # non-vacuous: some rays are blocked
    assert np.array_equal(jb, tb.numpy().ravel())


def test_closest_stream_bf16_pairs_matches_jax(streamed):
    flat, tv, jargs, sd, T, o, d = streamed
    pc = j_pt.pack_bvh4(flat, tv, bf16=True)
    assert pc.compressed
    closest, _ = j_pt.make_tracer(
        (jnp.asarray(pc.cbox), jnp.asarray(pc.cmeta), jargs[2]), 8, interpret=True,
        stack_depth=sd, stream=True, compressed=True)
    jh = closest(_j(o), _j(d))
    C = packed_from_numpy(pc.cbox, pc.cmeta, T.tri.numpy(), T.attr.numpy(),
                          T.lamb.numpy(), device="cpu", compressed=True)
    th = cuda_trace.closest_tiles(C.cbox, C.cmeta, C.tri, _t(o), _t(d), leaf_size=8,
                                  compressed=True, stream=True)
    same = _assert_hits(jh.t, jh.idx, th.t.numpy().ravel(), th.idx.numpy().ravel())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy().ravel()[same]).all()


# ---- the stream decision ----------------------------------------------------

# (stream mode, patch both ceilings to 0) -> streams
DECISIONS = {"auto_past_ceiling": ("auto", True, True),
             "off_past_ceiling": ("off", True, False),
             "auto_fits": ("auto", False, False)}


@pytest.mark.parametrize("case", sorted(DECISIONS))
def test_stream_decision_as_jax(case, tiny_scene, monkeypatch):
    mode, low, want = DECISIONS[case]
    if low:
        monkeypatch.setattr(j_pt, "RESIDENT_ROWS_CEILING_BYTES", 0)
        monkeypatch.setattr(t_pack, "RESIDENT_ROWS_CEILING_BYTES", 0)
    kw = dict(width=32, height=32, tile_rows=32, tile_cols=32, stream=mode, **REF)
    jp = j_pipeline.prepare(JConfig(**kw), scene=tiny_scene)
    tp = t_pipeline.prepare(TConfig(**kw), scene=tiny_scene, device="cpu")
    assert tp.stream == jp.stream == want
    assert tp.resolved_variant() == jp.resolved_variant() == ("pallas" if want else "fused")
    assert t_pack.stream_decision(tp.tables.cbox.shape[0], tp.tables.cmeta.shape[0],
                                  len(jp.packed_dev[2]), mode) == want
    # an explicit "fused" still runs the resident frame kernel, as in JAX
    assert tp.resolved_variant("fused") == "fused"


def test_row_model_threshold():
    """JAX's row model: 512 bytes a row, tri rows twice (tri + attr)."""
    ceiling = t_pack.RESIDENT_ROWS_CEILING_BYTES
    assert ceiling == j_pt.RESIDENT_ROWS_CEILING_BYTES == 126 * 1024 * 1024
    rows = ceiling // 512
    assert not t_pack.stream_decision(rows - 2, 0, 1, "auto")
    assert t_pack.stream_decision(rows - 1, 0, 1, "auto")
    assert t_pack.stream_decision(1, 1, 1, "on")
    assert not t_pack.stream_decision(rows, rows, rows, "off")


# ---- a streamed render against JAX's ---------------------------------------


def test_render_streamed_matches_jax(tiny_scene):
    """As test_pipeline_streams_when_forced (tests/test_kernel_variants.py)."""
    kw = dict(width=64, height=32, bounces=2, tile_rows=8, tile_cols=128,
              stream="on", **REF)
    jp = j_pipeline.prepare(JConfig(**kw), scene=tiny_scene)
    tp = t_pipeline.prepare(TConfig(**kw), scene=tiny_scene, device="cpu")
    assert jp.stream and tp.stream and tp.resolved_variant() == "pallas"
    ref = np.asarray(jp.render(variant="pallas", interpret=True))
    _assert_close(ref, tp.render().numpy())


# ---- padding and refusals ---------------------------------------------------


@pytest.mark.parametrize("rows", [1, 4, 6, 9])
def test_pad_stream_rows_as_jax(rows):
    a = np.arange(rows * 128, dtype=np.float32).reshape(rows, 128)
    ours = t_pack.pad_stream_rows(a)
    assert ours.shape[0] % t_pack.STREAM_BLK == 0
    assert np.array_equal(ours, np.asarray(j_pt._pad_stream_rows(jnp.asarray(a))))
    assert (t_pack.STREAM_RING, t_pack.STREAM_KPRE, t_pack.STREAM_BLK) == (
        j_pt.STREAM_RING, j_pt.STREAM_KPRE, j_pt.STREAM_BLK)


def test_prepare_pads_streamed_tables(tiny_scene):
    kw = dict(width=32, height=32, **REF)
    off = t_pipeline.prepare(TConfig(stream="off", **kw), scene=tiny_scene, device="cpu")
    on = t_pipeline.prepare(TConfig(stream="on", **kw), scene=tiny_scene, device="cpu")
    assert not off.stream and on.stream
    g = off.tables.tri.shape[0]
    assert g % t_pack.STREAM_BLK  # the tiny scene's rows need padding
    for name in ("tri", "attr"):
        a, b = getattr(off.tables, name), getattr(on.tables, name)
        assert b.shape[0] == g + (-g) % t_pack.STREAM_BLK
        assert torch.equal(b[:g], a) and not b[g:].any()
    assert torch.equal(on.tables.cbox.view(torch.int32), off.tables.cbox.view(torch.int32))
    # the resident kernels' entry points take the padded tables too
    assert torch.equal(on.render(variant="fused"), off.render(variant="fused"))


def test_stream_at_width_2_raises(tiny_scene):
    with pytest.raises(ValueError, match="bvh_width >= 4"):
        t_pipeline.prepare(TConfig(width=32, height=32, bvh_width=2, stream="on", **REF),
                           scene=tiny_scene, device="cpu")
    tp = t_pipeline.prepare(TConfig(width=32, height=32, bvh_width=2, **REF),
                            scene=tiny_scene, device="cpu")
    T = tp.tables
    o = cuda_trace.Vec3(*(torch.zeros((1, 128)) for _ in range(3)))
    with pytest.raises(ValueError, match="arity of 4 or 8"):
        cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, o, o, leaf_size=8, stream=True)


def test_unpadded_table_raises(streamed):
    _, _, jargs, _, T, o, d = streamed
    tri, attr = np.asarray(jargs[2]), np.asarray(jargs[3])
    assert tri.shape[0] % t_pack.STREAM_BLK
    U = packed_from_numpy(np.asarray(jargs[0]), np.asarray(jargs[1]), tri, attr,
                          np.zeros((1, 8), np.float32), device="cpu")
    ro, rd = _t(o), _t(d)
    m2 = torch.full((8, 128), 25.0)
    for fn, args in (
        (cuda_trace.closest_tiles, (U.cbox, U.cmeta, U.tri, ro, rd)),
        (cuda_trace.closest_tiles_full, (U.cbox, U.cmeta, U.tri, U.attr, ro, rd)),
        (cuda_trace.occluded_tiles, (U.cbox, U.cmeta, U.tri, ro, rd, m2)),
    ):
        with pytest.raises(ValueError, match="whole blocks"):
            fn(*args, leaf_size=8, stream=True)
        fn(*args, leaf_size=8)  # the resident instances take them


def test_stream_launch_keys():
    assert cuda_trace.STREAM_COUNTS[:5] == cuda_trace.COUNTS
    assert cuda_trace.STREAM_COUNTS[5:] == ("block_fills", "sync_fetches")
    for kernel in ("closest", "closest_full", "occluded"):
        for arity in (4, 8):
            for box, sfx in ((cuda_trace.BOX_F32, ""), (cuda_trace.BOX_PAIRS, ",bf16")):
                key = cuda_trace._instance(kernel, arity, box, stream=True)
                assert key == f"{kernel}_stream<{arity}{sfx}>" and key in cuda_trace.LAUNCHES


def test_bf16_streamed_pipeline(tiny_scene):
    kw = dict(width=64, height=32, bounces=2, tile_rows=8, tile_cols=128,
              bvh_width=4, bf16_bvh=True, stream="on", **REF)
    jp = j_pipeline.prepare(JConfig(**kw), scene=tiny_scene)
    tp = t_pipeline.prepare(TConfig(**kw), scene=tiny_scene, device="cpu")
    assert jp.compressed and jp.stream
    T = tp.tables
    assert tp.stream and T.compressed and T.arity == 4
    assert T.tri.shape[0] % t_pack.STREAM_BLK == 0 == T.attr.shape[0] % t_pack.STREAM_BLK
    assert np.array_equal(T.cbox.numpy().view(np.uint32),
                          np.asarray(jp.packed_dev[0]).view(np.uint32))
    f32 = t_pipeline.prepare(TConfig(**dict(kw, bf16_bvh=False)), scene=tiny_scene,
                             device="cpu")
    assert torch.equal(tp.render(), f32.render())


# ---- the command line -------------------------------------------------------


def test_cli_stream_on(tmp_path, capsys):
    argv = ["--device", "cpu", "--synthetic", "64", "--width", "32", "--height",
            "32", "--bounces", "1", "--warmup", "0", "--stream", "on"]
    rec_path, bmps = tmp_path / "m.json", [tmp_path / "on.bmp", tmp_path / "off.bmp"]
    assert cli.main(argv + ["--output", str(bmps[0]), "--metrics-json", str(rec_path)]) == 0
    out = capsys.readouterr().out
    assert "variant: pallas (auto), stream: True" in out
    rec = json.loads(rec_path.read_text())
    assert rec["stream"] is True and rec["config"]["stream"] == "on"
    argv[-1] = "off"
    assert cli.main(argv + ["--variant", "pallas", "--output", str(bmps[1])]) == 0
    assert "stream: False" in capsys.readouterr().out
    assert bmps[0].read_bytes() == bmps[1].read_bytes()
    with pytest.raises(ValueError, match="bvh_width >= 4"):
        cli.main(argv[:-1] + ["on", "--bvh-width", "2"])

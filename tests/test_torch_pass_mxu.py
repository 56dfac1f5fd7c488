"""The MXU closest-hit and any-hit passes: what the CPU can check.

- (a) compare_frames.py's `--passes mxu` tables parse and name every MXU
  pass family (csrc/trace.cuh: the while-while loop rt_ww_mxu_on, and
  rt_closest_mxu_on's loop where rt_mxu_while_while leaves it): widths 4
  and 8, leaf sizes 8 and 4, closest, closest_full and occluded, f32 and
  bf16 pair boxes, the DEEP stack tier; each name is the LAUNCHES key its
  launch counts under.
- (b) The MXU pass kernels' counting instances keep the step counts after
  the MXU counts: ops/cuda_trace.count_names(mxu=True) follows the count
  layout of csrc/trace.cuh (the RT_C_* and RT_S_* enums, the pass kernels'
  NC), and compare_frames.mxu_shares derives lanes a batch, batches a ray
  and leaf steps a ray from it.
- (c) The pass-based render() with the MXU leaf through make_tracer on
  conftest's blocker cloud (a lit floor under 30 small blockers, so the
  any-hit pass finds shadows) at L = 8 and 4 against the JAX package's frame
  (its "jax" variant), within tests/test_fused.py's bounds; on the CPU the
  wrappers run the plain MXU versions (ops/trace_plain.*_mxu_plain).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import compare_frames
from conftest import blocker_cloud_scene
from test_torch_frame import _assert_close
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.ops import cuda_trace

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_CUH = os.path.join(ROOT, "parallel_ray_tracer_tpu_torch", "csrc", "trace.cuh")


# ---- (a) the tables -----------------------------------------------------------

def _table_key(spec, kernel):
    """The LAUNCHES key of an MXU_TABLES pass: car_boxed specs are (width,
    leaf size, bf16 pair rows), the chain scene's DEEP tier at width 4."""
    if spec == "chain":
        return cuda_trace._instance(kernel, 4, cuda_trace.BOX_F32, deep=True, mxu=True)
    width, leaf, pairs = spec
    box = cuda_trace.BOX_PAIRS if pairs else cuda_trace.BOX_F32
    return cuda_trace._instance(kernel, width, box, mxu=True, leaf_size=leaf)


def test_mxu_tables_name_every_family():
    tables = compare_frames.MXU_TABLES
    names = [t[0] for t in tables]
    assert len(set(names)) == len(names) == 10
    widths, leaves, kernels, deep, pairs, render = set(), set(), set(), False, False, False
    for name, spec, kernel, rays in tables:
        assert kernel in ("closest", "closest_full", "occluded", "render")
        assert rays == ("shadow" if kernel == "occluded" else None if kernel == "render"
                        else "primary")
        if kernel == "render":
            # the pass-based render of the default MXU tables: closest_full_mxu<4>
            # and occluded_mxu<4>
            assert spec == (4, 8, False) and "closest_full_mxu<4>" in name
            assert "occluded_mxu<4>" in name
            render = True
            continue
        key = _table_key(spec, kernel)
        assert key in cuda_trace.LAUNCHES
        assert name == key, (name, key)
        kernels.add(kernel)
        if spec == "chain":
            deep = True
            widths.add(4)
        else:
            widths.add(spec[0])
            leaves.add(spec[1])
            pairs = pairs or spec[2]
    assert widths == {4, 8} and leaves == set(cuda_trace.MXU_LEAF_SIZES) == {8, 4}
    assert kernels == {"closest", "closest_full", "occluded"} and deep and pairs and render
    assert set(names) >= {
        "closest_mxu<4>", "closest_full_mxu<4>", "occluded_mxu<4>", "closest_full_mxu<8>",
        "occluded_mxu<8,bf16>", "closest_full_mxu<4,l4>", "occluded_mxu<4,l4>",
        "closest_full_mxu<4,deep>", "occluded_mxu<4,deep>"}


@pytest.mark.parametrize("mode", ("mxu", "resident", "stream", "frame"))
def test_passes_modes_parse(mode, monkeypatch):
    """--passes mxu is a choice beside the others; without a card main()
    stops after parsing with 2, and an unknown mode is refused."""
    monkeypatch.setattr(sys, "argv", ["compare_frames.py", "--passes", mode,
                                      "--other", "parent=/nonexistent"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compare_frames.main() == 2
    monkeypatch.setattr(sys, "argv", ["compare_frames.py", "--passes", "mxu_bogus"])
    with pytest.raises(SystemExit):
        compare_frames.main()


# ---- (b) the count layout -----------------------------------------------------

def _enum(src, first):
    """The names of the enum whose first member is `first`, in order."""
    m = re.search(r"enum \{ (" + first + r"\b[^}]*)\}", src)
    assert m, first
    return [n.strip().split("=")[0].strip() for n in m.group(1).split(",") if n.strip()]


def test_mxu_count_names_follow_the_kernel_layout():
    src = open(TRACE_CUH).read()
    counts = _enum(src, "RT_C_INNER")
    steps = _enum(src, "RT_S_INNER")
    assert counts[-1] == "RT_NCOUNTS" and steps[-1] == "RT_NSTEPS"
    # the MXU instances keep the two extra counts as batches and lanes served
    assert "enum { RT_C_BATCHES = RT_C_FILLS, RT_C_SERVED = RT_C_SYNCS };" in src
    # every pass kernel (closest_kernel, occluded_kernel) keeps its mode's
    # counts and then the steps (an MXU instance on rt_closest_mxu_on's loop
    # counts none and writes the first seven); the frame kernel its mode's
    # counts only
    assert src.count(
        "constexpr int NC = rt_ncounts(MXU || STREAM) + (MXU && !WW ? 0 : RT_NSTEPS);") == 2
    assert "rt_count<rt_ncounts(MXU)>(counts, cnt);" in src
    n_mxu = len(counts) - 1           # rt_ncounts(true)
    n_steps = len(steps) - 1
    mxu_pass = cuda_trace.count_names(mxu=True)
    assert len(mxu_pass) == n_mxu + n_steps
    assert mxu_pass == cuda_trace.MXU_COUNTS + cuda_trace.STEP_COUNTS
    assert cuda_trace.count_names(mxu=True, steps=False) == cuda_trace.MXU_COUNTS
    assert len(cuda_trace.MXU_COUNTS) == n_mxu
    # the names in the kernel's order: RT_C_* (FILLS, SYNCS as BATCHES,
    # SERVED under MXU), then RT_S_*
    kernel = [c for c in counts[:-1]] + [s for s in steps[:-1]]
    kernel = [{"RT_C_FILLS": "RT_C_BATCHES", "RT_C_SYNCS": "RT_C_SERVED"}.get(k, k)
              for k in kernel]
    assert kernel == ["RT_C_INNER", "RT_C_BOX", "RT_C_LEAF", "RT_C_TRI", "RT_C_RAYS",
                      "RT_C_BATCHES", "RT_C_SERVED", "RT_S_INNER", "RT_S_LEAF", "RT_S_ROWS"]
    assert mxu_pass == ("inner_visits", "box_tests", "leaf_visits", "tri_tests", "traversals",
                        "mma_batches", "lanes_served", "inner_steps", "leaf_steps", "leaf_rows")
    # the while-while MXU loop counts a batch and a leaf row per distinct
    # group, a leaf step once, and its pop steps (shared with rt_ww_on) the
    # inner steps
    body = src[src.index("RT_FN int rt_ww_mxu_on("):src.index("RT_FN int rt_closest_ww_mxu(")]
    assert "cnt.add(RT_C_BATCHES);\n      rt_step_add<B>(cnt, RT_S_ROWS);" in body
    assert "rt_step_add<B>(cnt, RT_S_LEAF)" in body and "rt_ww_pops<A, F, OCC, B>(" in body
    pops = src[src.index("RT_FN unsigned rt_ww_pops("):src.index("RT_FN int rt_ww_on(")]
    assert "rt_step<B>(cnt, false, 0)" in pops


def test_mxu_shares():
    names = cuda_trace.count_names(mxu=True)
    c = dict(zip(names, (500, 900, 120, 960, 40, 10, 120, 30, 6, 10)))
    assert compare_frames.mxu_shares(c) == {"lanes_per_batch": 12.0, "batches_per_ray": 0.25,
                                            "leaf_steps_per_ray": 0.15}
    # rows a leaf step are the batches a leaf step
    assert compare_frames.step_shares(c)["rows_per_leaf_step"] == c["mma_batches"] / 6
    # a library without step counts (the parent's MXU loop) reads null there
    old = dict(c, inner_steps=0, leaf_steps=0, leaf_rows=0)
    assert compare_frames.mxu_shares(old)["leaf_steps_per_ray"] is None
    assert compare_frames.mxu_shares(old)["lanes_per_batch"] == 12.0


# ---- (c) the pass-based render with the MXU leaf against JAX -------------------

@pytest.mark.parametrize("leaf", (8, 4), ids=lambda v: f"l{v}")
def test_pass_render_mxu_matches_jax(leaf, monkeypatch):
    kw = dict(width=32, height=32, bounces=2, bvh_heuristic=6, tile_rows=32, tile_cols=32,
              use_native=False, mxu_leaf=True, leaf_size=leaf, leaf_threshold=leaf)
    sc = blocker_cloud_scene()
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    assert tp.leaf_size == leaf and tp.mxu and tp.tables.cmat is not None and not tp.stream
    made, plain = [], []
    real = cuda_trace.make_tracer

    def spy(packed, *a, **k):
        made.append((len(packed), k.get("dual"), k.get("stream", False)))
        return real(packed, *a, **k)

    monkeypatch.setattr(cuda_trace, "make_tracer", spy)
    for name in ("closest_full_mxu_plain", "occluded_mxu_plain"):
        fn = getattr(cuda_trace, name)

        def counted(*a, _fn=fn, _name=name, **k):
            plain.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(cuda_trace, name, counted)
    img = tp.render(variant="pallas").numpy()
    # cbox, cmeta, tri, attr, cmat: the MXU instances' plain versions ran
    assert made == [(5, True, False)]
    n_lights = len(sc.lights_pos)
    assert n_lights and plain.count("closest_full_mxu_plain") == 2
    assert plain.count("occluded_mxu_plain") == 2 * n_lights
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    ref = np.asarray(jp.render(variant="jax"))
    _assert_close(ref, img)

"""The resident closest-hit and any-hit passes: what the CPU can check.

- (a) compare_frames.py's `--passes resident` tables parse and name every
  pass kernel family (csrc/trace.cuh: the while-while loop rt_ww_on, and
  rt_closest_on's loop where rt_while_while leaves it):
  widths 2, 4 and 8, leaf sizes 8, 4, 2 and 1, closest, closest_full and
  occluded, f32 and bf16 pair boxes, the DEEP stack tier; each name is the
  LAUNCHES key its launch counts under.
- (b) The C entries rt_closest / rt_occluded / rt_frame of
  csrc/trace_kernels.cu take what _build.ENTRY_ARGTYPES binds (the types
  every library gets, this tree's through ops/cuda_trace.py and another
  commit's through compare_frames.py), and ops/cuda_trace.py passes them
  that many arguments.
- (c) The pass-based render() through make_tracer on a small synthetic
  scene at L = 8 and 2 against the JAX package's frame (its "jax"
  variant), within tests/test_fused.py's bounds.
"""

import ast
import ctypes
import os
import re
import sys

import numpy as np
import pytest
import torch

import compare_frames
from test_torch_frame import _assert_close
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.scene import synthetic_scene
from parallel_ray_tracer_tpu_torch import _build
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.ops import cuda_trace

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS_CU = os.path.join(ROOT, "parallel_ray_tracer_tpu_torch", "csrc", "trace_kernels.cu")
CUDA_TRACE = os.path.join(ROOT, "parallel_ray_tracer_tpu_torch", "ops", "cuda_trace.py")


# ---- (a) the tables -----------------------------------------------------------

def _table_key(spec, kernel):
    """The LAUNCHES key of a RESIDENT_TABLES pass: car_boxed specs are
    (width, leaf size, bf16 pair rows), the chain scene's DEEP tier at
    width 4; synthetic_600k takes width 4, L = 8."""
    if spec == "chain":
        return cuda_trace._instance(kernel, 4, cuda_trace.BOX_F32, deep=True)
    if isinstance(spec, int):
        return cuda_trace._instance(kernel, 4, cuda_trace.BOX_F32)
    width, leaf, pairs = spec
    box = cuda_trace.BOX_PAIRS if pairs else cuda_trace.BOX_F32
    return cuda_trace._instance(kernel, width, box, leaf_size=leaf)


def test_resident_tables_name_every_family():
    tables = compare_frames.RESIDENT_TABLES
    names = [t[0] for t in tables]
    assert len(set(names)) == len(names) == 13
    widths, leaves, kernels, deep, pairs = set(), set(), set(), False, False
    for name, spec, kernel, rays in tables:
        assert kernel in ("closest", "closest_full", "occluded", "render")
        assert rays == ("shadow" if kernel == "occluded" else None if kernel == "render"
                        else "primary")
        if kernel == "render":
            assert isinstance(spec, int) and "stream=False" in name
            continue
        key = _table_key(spec, kernel)
        assert key in cuda_trace.LAUNCHES
        assert name.split(" ")[0] == key, (name, key)
        kernels.add(kernel)
        if spec == "chain":
            deep = True
            widths.add(4)
        elif isinstance(spec, int):
            assert spec == 600_000 and "synthetic_600k" in name
        else:
            widths.add(spec[0])
            leaves.add(spec[1])
            pairs = pairs or spec[2]
    assert widths == {2, 4, 8} and leaves == {8, 4, 2, 1}
    assert kernels == {"closest", "closest_full", "occluded"} and deep and pairs
    # the families the mode was made for, by key
    assert {n.split(" ")[0] for n in names} >= {
        "closest<4>", "closest_full<4>", "occluded<4>", "closest_full<2>", "occluded<2>",
        "closest_full<8,bf16>", "closest<4,l2>", "occluded<8,bf16,l1>",
        "closest_full<4,deep>", "occluded<4,deep>"}


def test_passes_resident_parses(monkeypatch):
    """--passes resident is a choice; without a card main() stops after
    parsing with 2, and an unknown mode is refused by the parser."""
    monkeypatch.setattr(sys, "argv", ["compare_frames.py", "--passes", "resident",
                                      "--other", "parent=/nonexistent"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compare_frames.main() == 2
    monkeypatch.setattr(sys, "argv", ["compare_frames.py", "--passes", "bogus"])
    with pytest.raises(SystemExit):
        compare_frames.main()


def test_step_shares_and_agreement():
    """The mode's derived step shares, and its hit agreement: t and the
    miss mask bit for bit, differing idx counted as ties only where t is
    equal."""
    c = dict(inner_visits=300, leaf_visits=100, inner_steps=20, leaf_steps=10, leaf_rows=40)
    assert compare_frames.step_shares(c) == {"lanes_per_inner_step": 15.0,
                                             "lanes_per_leaf_step": 10.0,
                                             "rows_per_leaf_step": 4.0}
    assert compare_frames.step_shares(dict(c, inner_steps=0, leaf_steps=0)) == {
        "lanes_per_inner_step": None, "lanes_per_leaf_step": None, "rows_per_leaf_step": None}
    t = torch.tensor([1.0, 2.0, 3e38, 4.0])
    idx = torch.tensor([3, 5, -1, 7], dtype=torch.int32)
    nd = torch.tensor([True, False, False, True])
    ref = cuda_trace.Hit(t=t, idx=idx, norm_dir=nd)
    tie = cuda_trace.Hit(t=t.clone(), idx=torch.tensor([3, 6, -1, 7], dtype=torch.int32),
                         norm_dir=nd.clone())
    a = compare_frames.hit_agreement(tie, ref)
    assert a["t_equal"] and a["miss_equal"] and a["idx_differ"] == 1 and a["idx_ties"] == 1
    assert not a["bitwise_equal"] and a["rest_equal_where_idx_agrees"]
    assert compare_frames.hit_agreement(ref, ref)["bitwise_equal"]
    blocked = torch.tensor([True, False])
    b = compare_frames.hit_agreement(~blocked, blocked)
    assert not b["bitwise_equal"] and b["differ"] == 2


# ---- (b) the C entries --------------------------------------------------------

def _prototypes() -> dict:
    """{entry: [ctypes type per parameter]} from the extern "C" block."""
    src = open(KERNELS_CU).read()
    block = src[src.index('extern "C" {'):]
    out = {}
    for name in _build.ENTRY_ARGTYPES:
        m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{", block)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        out[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert all("*" in p or p.split()[0] == "int" for p in params), params
    return out


def _call_arity(call: ast.Call) -> int:
    """Arguments of a call, a starred generator over (*o, *d) counting the
    six ray planes."""
    n = 0
    for a in call.args:
        if isinstance(a, ast.Starred) and isinstance(a.value, ast.GeneratorExp):
            elts = a.value.generators[0].iter.elts
            assert all(isinstance(e, ast.Starred) for e in elts)
            n += 3 * len(elts)      # each a Vec3 of three planes
        else:
            assert not isinstance(a, ast.Starred)
            n += 1
    return n


def test_entry_prototypes_match_argtypes():
    protos = _prototypes()
    for name, argtypes in _build.ENTRY_ARGTYPES.items():
        assert protos[name] == argtypes, name
    # ops/cuda_trace.py calls each entry with that many arguments
    calls = {}
    for node in ast.walk(ast.parse(open(CUDA_TRACE).read())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in protos):
            calls.setdefault(node.func.attr, []).append(_call_arity(node))
    assert set(calls) == set(protos)
    for name, arities in calls.items():
        assert arities == [len(protos[name])] * len(arities), (name, arities)


def test_bind_entries_sets_argtypes():
    class Fn:
        pass

    class Lib:
        pass

    lib = Lib()
    for name in _build.ENTRY_ARGTYPES:
        setattr(lib, name, Fn())
    assert _build.bind_entries(lib) is lib
    for name, argtypes in _build.ENTRY_ARGTYPES.items():
        assert getattr(lib, name).argtypes == argtypes
        assert getattr(lib, name).restype is ctypes.c_int
    assert "bind_entries" in open(compare_frames.__file__).read()


# ---- (c) the pass-based render against JAX -------------------------------------

@pytest.mark.parametrize("leaf", (8, 2), ids=lambda v: f"l{v}")
def test_pass_render_matches_jax(leaf, monkeypatch):
    kw = dict(width=32, height=32, bounces=2, bvh_heuristic=6, tile_rows=32, tile_cols=32,
              use_native=False, mxu_leaf=False, leaf_size=leaf, leaf_threshold=leaf)
    sc = synthetic_scene(250, seed=3)
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    assert tp.leaf_size == leaf and not tp.mxu and not tp.stream
    made = []
    real = cuda_trace.make_tracer

    def spy(*a, **k):
        made.append(k.get("stream", False))
        return real(*a, **k)

    monkeypatch.setattr(cuda_trace, "make_tracer", spy)
    img = tp.render(variant="pallas").numpy()
    assert made == [False]
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    ref = np.asarray(jp.render(variant="jax"))
    _assert_close(ref, img)

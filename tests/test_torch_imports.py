"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
runs on CUDA unless told otherwise, and refuses only the leaf sizes it has
no kernels for."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parallel_ray_tracer_tpu_torch import pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig
from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "parallel_ray_tracer_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py", "compare_frames.py",
                                           "packet_schedules.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "parallel_ray_tracer_tpu"


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, (path, bad)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import parallel_ray_tracer_tpu_torch.pipeline\n"
        "import parallel_ray_tracer_tpu_torch.ops.cuda_trace\n"
        "import parallel_ray_tracer_tpu_torch.convert\n"
        "import parallel_ray_tracer_tpu_torch.utils.bmp\n"
        "import parallel_ray_tracer_tpu_torch.cli\n"
        "import parallel_ray_tracer_tpu_torch.utils.stats\n"
        "import parallel_ray_tracer_tpu_torch.models.procgen\n"
        "import parallel_ray_tracer_tpu_torch.microbench.__main__\n"
        "import parallel_ray_tracer_tpu_torch.microbench.tiled\n"
        "import parallel_ray_tracer_tpu_torch.microbench.mxu_inner\n"
        "import parallel_ray_tracer_tpu_torch.native.builder\n"
        "import parallel_ray_tracer_tpu_torch.ops.diff\n"
        "import parallel_ray_tracer_tpu_torch.ops.trace_bvh\n"
        "import parallel_ray_tracer_tpu_torch.parallel.sharded\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'parallel_ray_tracer_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_prepare_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.prepare(RenderConfig(width=32, height=32, use_native=False))


@pytest.mark.parametrize("kw", [
    dict(leaf_size=0), dict(leaf_size=3), dict(leaf_size=16),
])
def test_unported_knobs_raise(kw):
    with pytest.raises(NotImplementedError):
        pipeline.prepare(RenderConfig(width=32, height=32, **kw), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(fast_light=False), dict(presplit=0.1), dict(leaf_size=4),
    dict(reverse_shadows=False), dict(num_devices=2), dict(variant="jax"),
])
def test_ported_knobs_render(kw):
    """The knobs that raised before their paths were ported prepare and
    render: a synthetic scene's fused, pass-based or packet-traversal
    frame, in frame."""
    cfg = RenderConfig(width=32, height=32, bounces=1, synthetic_triangles=64,
                       use_native=False, **kw)
    pipe = pipeline.prepare(cfg, device="cpu")
    assert pipe.leaf_size == (4 if kw.get("leaf_size") == 4 else 8)
    assert pipe.resolved_variant() == kw.get(
        "variant", "pallas" if "fast_light" in kw else "fused")
    img = pipe.render()
    assert img.shape == (32, 32, 3) and img.std() > 0.01


def test_bvh_width_other_than_2_4_8_raises():
    with pytest.raises(ValueError, match="bvh_width"):
        pipeline.prepare(RenderConfig(width=32, height=32, bvh_width=3), device="cpu")


def _tiny_tables():
    cbox = np.full((2, 32), np.nan, np.float32)
    cbox[0, :6] = [0, 0, 0, 1, 1, 1]
    cmeta = np.zeros((2, 8), np.int32)
    cmeta[0, 0], cmeta[0, 4] = -1, 1
    tri = np.zeros((2, 128), np.float32)
    tri[0, :12] = [0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1]
    lamb = np.zeros((2, 8), np.float32)
    return packed_from_numpy(cbox, cmeta, tri, tri * 0, lamb, device="cpu")


def _rays(rows=1, dtype=torch.float32):
    z = torch.zeros((rows, 128), dtype=dtype)
    return Vec3(z + 0.2, z + 0.2, z + 1.0), Vec3(z, z, z - 1.0)


def test_wrappers_check_inputs():
    T = _tiny_tables()
    o, d = _rays()
    h = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, leaf_size=8)
    assert (h.idx == 0).all() and torch.allclose(h.t, torch.ones_like(h.t))
    assert T.stack_depth == 5
    with pytest.raises(TypeError):
        cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, *_rays(dtype=torch.float64),
                                 leaf_size=8)
    with pytest.raises(ValueError):
        cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri,
                                 Vec3(*(p.reshape(2, 64) for p in o)), d, leaf_size=8)
    with pytest.raises(ValueError):
        cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri,
                                 Vec3(*(p.t() for p in _rays(128)[0])),
                                 _rays(128)[1], leaf_size=8)
    for leaf_size in (3, 16):
        with pytest.raises(NotImplementedError):
            cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, leaf_size=leaf_size)
    # leaf size 4 and forward shadow rays are ported: a row of 4 triangles
    h4 = cuda_trace.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, leaf_size=4)
    assert torch.equal(h4.t, h.t) and torch.equal(h4.idx, h.idx)
    fwd = cuda_trace.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, o, d,
                                 bounces=1, leaf_size=8, reverse_shadows=False)
    assert all(torch.isfinite(c).all() for c in fwd)
    with pytest.raises(ValueError, match="counters"):
        cuda_trace.occluded_tiles(T.cbox, T.cmeta, T.tri, o, d, o.x, leaf_size=8,
                                  counters=True)
    # the fused frame exists at arity 4 and 8 only; rows of another width
    # are no node table
    cbox2 = np.zeros((1, 16), np.float32)
    cbox2[0, :12] = [0, 0, 0, 1, 1, 1] * 2
    cmeta2 = np.zeros((1, 8), np.int32)
    cmeta2[0, :2] = -1
    B = packed_from_numpy(cbox2, cmeta2, T.tri.numpy(), T.attr.numpy(),
                          T.lamb.numpy(), device="cpu")
    assert (B.arity, B.stack_depth) == (2, 3)
    with pytest.raises(ValueError, match="arity"):
        cuda_trace.frame_tiles(B.cbox, B.cmeta, B.tri, B.attr, B.lamb, o, d,
                               bounces=1, leaf_size=8)
    with pytest.raises(ValueError):
        packed_from_numpy(np.zeros((1, 24), np.float32), cmeta2, T.tri.numpy(),
                          T.attr.numpy(), T.lamb.numpy(), device="cpu")


def test_stack_check_raises_before_launch():
    """No tree is refused for its depth: one that needs more stack entries
    per ray than the standard tier's private stack holds takes the DEEP
    tier (a stack sized to the tree), at each arity; one that fits keeps
    the standard tier."""
    for arity, size in cuda_trace.STACK_SIZE.items():
        assert not cuda_trace.use_deep_tier(size, arity)
        assert cuda_trace.use_deep_tier(size + 1, arity)
    assert not cuda_trace.use_deep_tier(_tiny_tables().stack_depth, 4)

"""A BVH deeper than the standard stack tier, in the port and in JAX.

models/procgen.chain_scene (56 small triangles at distances 2.5**k) built
with largest-axis midpoint splits and bvh_max_depth=64 gives a 48-level
tree: its traversal needs more stack entries per ray (ops/pack.stack_need)
than the CUDA kernels' private stacks hold (cuda_trace.STACK_SIZE) at
arity 2, 4 and 8, so every launch on it takes the DEEP tier, whose stack
is sized to the tree, as JAX sizes its own (required_stack_depth). The
plain versions use no stack: on the CPU the port's frame at each arity is
held against JAX's fused frame (interpret mode, 16x16, 1 bounce) within
the bounds of tests/test_fused.py. The card runs the DEEP instances
(chip_smoke.py, phase `deep`).
"""

import numpy as np
import pytest
import torch

from test_torch_frame import _assert_close
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.scene import Scene as JScene
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.models.procgen import chain_scene
from parallel_ray_tracer_tpu_torch.ops import cuda_trace

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

CFG = dict(width=16, height=16, bounces=1, bvh_heuristic=1, bvh_max_depth=64,
           tile_rows=32, tile_cols=32, use_native=False, mxu_leaf=False)
FIELDS = ("verts", "faces", "mat_idx", "mats_kd", "mats_ks", "mats_kr",
          "lights_pos", "lights_kl")


@pytest.fixture(scope="module")
def jax_deep():
    """JAX's width-4 pipeline on the chain and its fused frame."""
    sc = chain_scene()
    jp = j_pipeline.prepare(JConfig(**CFG), scene=JScene(**{f: getattr(sc, f) for f in FIELDS}))
    return jp, np.asarray(jp.render(variant="fused", interpret=True))


@pytest.mark.parametrize("width", [2, 4, 8])
def test_deep_tree_takes_the_deep_tier(width, jax_deep):
    jp, _ = jax_deep
    tp = t_pipeline.prepare(TConfig(**CFG, bvh_width=width), scene=chain_scene(), device="cpu")
    assert tp.flat.depth == jp.flat.depth == 48
    need, size = tp.tables.stack_depth, cuda_trace.STACK_SIZE[width]
    assert need > size
    assert cuda_trace.use_deep_tier(need, width)
    # JAX renders this tree: its stack is sized to it
    assert j_pt.required_stack_depth(jp.flat.depth, width, npop=2) >= need


@pytest.mark.parametrize("width", [2, 4, 8])
def test_deep_tree_renders_as_jax(width, jax_deep):
    _, ref = jax_deep
    tp = t_pipeline.prepare(TConfig(**CFG, bvh_width=width), scene=chain_scene(), device="cpu")
    assert tp.resolved_variant() == ("fused" if width >= 4 else "pallas")
    _assert_close(ref, tp.render().numpy())
    _assert_close(ref, tp.render(variant="pallas").numpy())

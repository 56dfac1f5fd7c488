"""Whole frames at leaf size 4 in the port against the JAX package
(tests/test_fused.py:130-146 and tests/test_kernel_variants.py:410: the
leaf-4 MXU frame matches the leaf-8 one): the port's L = 4 fused frames
with and without the MXU leaf, and its pass-based frames, against JAX's
L = 4 MXU fused frame in interpret mode (made once), and the port's default
(L = 8) frame against it too. Bounds as tests/test_fused.py: more than 99%
of pixels within 1e-3, median below 1e-5.
"""

import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from test_torch_frame import _assert_close
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

L = 4
FRAME = dict(width=32, height=32, bounces=2, bvh_heuristic=6, tile_rows=32, tile_cols=32,
             use_native=False, pop_width=2, adaptive_pop=False)
_JFRAME = {}


def _jax_leaf4_frame():
    """JAX's L = 4 fused frame with the MXU leaf on the blocker cloud, in
    interpret mode (tests/test_fused.py:130-146's configuration, made once)."""
    if "img" not in _JFRAME:
        jp = j_pipeline.prepare(JConfig(leaf_size=L, leaf_threshold=L, **FRAME),
                                scene=blocker_cloud_scene())
        assert len(jp.packed_dev) == 5 and jp.leaf_size == L
        _JFRAME["img"] = np.asarray(jp.render(variant="fused", interpret=True))
    return _JFRAME["img"]


@pytest.mark.parametrize("mxu", [True, False], ids=["mxu", "fp32"])
def test_frame_leaf4_matches_jax(mxu):
    ref = _jax_leaf4_frame()
    tp = t_pipeline.prepare(TConfig(leaf_size=L, leaf_threshold=L, mxu_leaf=mxu, **FRAME),
                            scene=blocker_cloud_scene(), device="cpu")
    assert tp.leaf_size == L and tp.mxu == mxu and tp.resolved_variant() == "fused"
    _assert_close(ref, tp.render().numpy())
    _assert_close(ref, tp.render(variant="pallas").numpy())


def test_frame_leaf8_matches_jax_leaf4():
    """JAX's leaf-4 frame is its leaf-8 frame (tests/test_fused.py:145):
    so is the port's default frame."""
    tp = t_pipeline.prepare(TConfig(**FRAME), scene=blocker_cloud_scene(), device="cpu")
    assert tp.leaf_size == 8
    _assert_close(_jax_leaf4_frame(), tp.render().numpy())

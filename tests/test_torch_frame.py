"""Whole frames of the port against the JAX package.

prepare(cfg, device="cpu").render() resolves to the fused frame kernel's
entry point, which on the CPU runs its plain version (the pass-based bounce
loop over brute-force traversals). It is held against the JAX fused kernel
in interpret mode on the blocker cloud, and against the JAX packet tracer
(variant="jax") on car_boxed.

Bounds, as tests/test_fused.py: more than 99% of pixels within 1e-3 (an
isolated silhouette pixel may flip a binary occlusion), median below 1e-5.
"""

import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REF = dict(use_native=False, mxu_leaf=False)


def _assert_close(ref, img):
    assert img.shape == ref.shape and img.dtype == np.float32
    assert ref.std() > 0.01  # non-vacuous: the scene is in frame
    diff = np.abs(ref - img)
    assert (diff.max(axis=-1) < 1e-3).mean() > 0.99, diff.max()
    assert np.median(diff) < 1e-5


@pytest.mark.parametrize("bounces", [1, 3])
def test_frame_matches_jax_fused(bounces):
    kw = dict(width=32, height=32, bounces=bounces, bvh_heuristic=6,
              tile_rows=32, tile_cols=32, **REF)
    sc = blocker_cloud_scene()
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    assert tp.resolved_variant() == "fused"
    img = tp.render().numpy()
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    ref = np.asarray(jp.render(variant="fused", interpret=True))
    _assert_close(ref, img)
    # the pass-based path of the port renders the same frame
    _assert_close(ref, tp.render(variant="pallas").numpy())


def test_car_boxed_matches_jax_variant():
    kw = dict(scene="car_boxed", width=64, height=32, bounces=4,
              bvh_heuristic=6, tile_rows=32, tile_cols=32, **REF)
    img = t_pipeline.prepare(TConfig(**kw), device="cpu").render().numpy()
    ref = np.asarray(j_pipeline.prepare(JConfig(**kw)).render(variant="jax"))
    _assert_close(ref, img)

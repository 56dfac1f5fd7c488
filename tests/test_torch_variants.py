"""Both packages resolve the "auto" variant the same way: the fused frame
kernel at bvh_width 4 or 8 with any-hit shadows and 1024-pixel tiles, the
pass-based path otherwise (parallel_ray_tracer_tpu/pipeline.py:80-104);
fast_light=False (shadows by the closest-hit kernel) always resolves to
the pass-based path."""

import pytest
import torch

from conftest import blocker_cloud_scene
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools


@pytest.mark.parametrize("fast_light", [True, False])
@pytest.mark.parametrize("tile", [(32, 32), (8, 128), (16, 16)], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("bvh_width", [2, 4, 8])
def test_auto_resolves_as_jax(bvh_width, tile, fast_light):
    kw = dict(width=32, height=32, bvh_width=bvh_width, tile_rows=tile[0],
              tile_cols=tile[1], fast_light=fast_light, use_native=False,
              mxu_leaf=False)
    sc = blocker_cloud_scene()
    want = j_pipeline.prepare(JConfig(**kw), scene=sc).resolved_variant()
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    assert tp.resolved_variant() == want
    if not fast_light:
        assert want == "pallas"
    assert tp.resolved_variant("auto") == want
    for explicit in ("fused", "pallas"):
        assert tp.resolved_variant(explicit) == explicit

"""The pre-split of large triangles (models/presplit.py) in the port
against the JAX package: presplit_scene bit for bit against JAX's on
tests/test_presplit.py's scene and on car_boxed, and prepare(presplit=1/8)
against JAX's prepare: the same split scene and tables bit for bit, and the
frame of the unsplit scene within atol 1e-4 (tests/test_presplit.py:87).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.presplit import presplit_scene as j_presplit
from parallel_ray_tracer_tpu.models.scene import Scene as JScene
from parallel_ray_tracer_tpu.models.scene import load_scene_npz as j_load_npz
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.models.presplit import presplit_scene
from parallel_ray_tracer_tpu_torch.models.scene import Scene as TScene
from parallel_ray_tracer_tpu_torch.models.scene import load_scene_npz

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _box_scene(pkg):
    """tests/test_presplit.py's scene: two scene-sized floor triangles and a
    small off-centre one."""
    verts = np.array([[0, 0, 0], [10, 0, 0], [10, 0, 10], [0, 0, 10],
                      [4, 1, 4], [4.5, 1, 4], [4, 1, 4.5]], np.float32)
    return pkg(verts=verts, faces=np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32),
               mat_idx=np.array([0, 0, 1], np.int32),
               mats_kd=np.array([[0.5, 0.5, 0.5], [0.9, 0.1, 0.1]], np.float32),
               mats_ks=np.zeros((2, 3), np.float32), mats_kr=np.zeros((2, 3), np.float32),
               lights_pos=np.array([[5.0, 5.0, 5.0]], np.float32),
               lights_kl=np.array([[1.0, 1.0, 1.0]], np.float32))


def _assert_scenes_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), f.name


SPLITS = {"box_1_8": ("box", dict(ratio=1 / 8, budget=200.0)),
          "box_noop": ("box", dict(ratio=10.0)),
          "box_budget": ("box", dict(ratio=1 / 64, budget=2.0)),
          "car_boxed_1_8": ("car_boxed", dict(ratio=1 / 8))}


@pytest.mark.parametrize("case", list(SPLITS))
def test_presplit_identical(case):
    name, kw = SPLITS[case]
    if name == "box":
        js, ts = _box_scene(JScene), _box_scene(TScene)
    else:
        path = os.path.join(REPO, "assets", "car_boxed.npz")
        js, ts = j_load_npz(path), load_scene_npz(path)
    jsp, jsrc = j_presplit(js, **kw)
    tsp, tsrc = presplit_scene(ts, **kw)
    _assert_scenes_equal(jsp, tsp)
    assert np.array_equal(jsrc, tsrc)
    if case in ("box_1_8", "car_boxed_1_8"):
        assert tsp.num_triangles > ts.num_triangles


@pytest.mark.parametrize("width", [4, 2])
def test_prepare_presplit_as_jax(width):
    """prepare(presplit=1/8) on the blocker cloud, whose floor quad spans
    the scene: JAX's split scene and tables bit for bit, and the frame of
    the unsplit scene within atol 1e-4 (tests/test_presplit.py:87)."""
    kw = dict(width=64, height=32, bounces=2, bvh_heuristic=6, tile_rows=32, tile_cols=32,
              use_native=False, mxu_leaf=False, bvh_width=width)
    sc = blocker_cloud_scene()
    jp = j_pipeline.prepare(JConfig(presplit=1 / 8, **kw), scene=sc)
    tp = t_pipeline.prepare(TConfig(presplit=1 / 8, **kw), scene=sc, device="cpu")
    assert tp.scene.num_triangles == jp.scene.num_triangles > sc.num_triangles
    _assert_scenes_equal(jp.scene, tp.scene)
    for jt, tt in zip(jp.packed_dev[:4], tp.tables[:4]):
        assert np.array_equal(np.asarray(jt).view(np.uint32), tt.numpy().view(np.uint32))
    img1 = tp.render().numpy()
    img0 = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu").render().numpy()
    assert img0.std() > 0.01
    np.testing.assert_allclose(img0, img1, atol=1e-4)

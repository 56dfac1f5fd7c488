"""The port's procedural scenes (models/procgen.py) against the JAX package's.

- dragon_scene at its default 180k triangles and at a small target: the same
  arrays.
- two_cars_scene and sportscar_scene on the same car_only geometry (both
  modules' load_scene return the assets/car_only.npz scene): the same
  arrays.
- pipeline._load falls back to the substitute as JAX's prepare does: the
  dragon from an empty asset root; two_cars and sportscar raise JAX's
  FileNotFoundError without a car_only OBJ folder.
No BVH of the dragon is built here.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from parallel_ray_tracer_tpu.models import procgen as j_procgen
from parallel_ray_tracer_tpu.models.scene import load_scene_npz as j_load_npz
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.models import procgen as t_procgen
from parallel_ray_tracer_tpu_torch.models.scene import load_scene_npz as t_load_npz

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAR_NPZ = os.path.join(REPO, "assets", "car_only.npz")
FIELDS = ("verts", "faces", "mat_idx", "mats_kd", "mats_ks", "mats_kr",
          "lights_pos", "lights_kl")


def _assert_same_scene(j, t):
    for f in FIELDS:
        a, b = np.asarray(getattr(j, f)), np.asarray(getattr(t, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert t.num_spheres == j.num_spheres == 0


@pytest.fixture(scope="module")
def jax_dragon():
    return j_procgen.dragon_scene()


@pytest.mark.parametrize("target", [None, 8_000], ids=["default", "8k"])
def test_dragon_as_jax(target, jax_dragon):
    kw = {} if target is None else dict(target_triangles=target)
    j = jax_dragon if target is None else j_procgen.dragon_scene(**kw)
    t = t_procgen.dragon_scene(**kw)
    _assert_same_scene(j, t)
    assert t.num_lights == 2 and t.num_materials == 6
    if target is None:
        assert t.num_triangles == 180_002


@pytest.mark.parametrize("name", ["two_cars", "sportscar"])
def test_car_substitutes_as_jax(name, monkeypatch):
    monkeypatch.setattr(j_procgen, "load_scene", lambda _: j_load_npz(CAR_NPZ))
    monkeypatch.setattr(t_procgen, "load_scene", lambda _: t_load_npz(CAR_NPZ))
    fn = f"{name}_scene"
    _assert_same_scene(getattr(j_procgen, fn)("unused"), getattr(t_procgen, fn)("unused"))


def test_load_falls_back_to_the_dragon(jax_dragon, tmp_path):
    cfg = TConfig(scene="dragon", asset_root=str(tmp_path))
    _assert_same_scene(j_procgen.substitute_scene("dragon", (str(tmp_path),)),
                       t_pipeline._load(cfg))
    # the default roots (the repo's assets/) hold no dragon either
    _assert_same_scene(jax_dragon, t_pipeline._load(dataclasses.replace(cfg, asset_root=None)))


@pytest.mark.parametrize("name", ["two_cars", "sportscar"])
def test_car_substitute_needs_car_only(name, tmp_path):
    roots = (str(tmp_path),)
    with pytest.raises(FileNotFoundError) as j_err:
        j_procgen.substitute_scene(name, roots)
    with pytest.raises(FileNotFoundError) as t_err:
        t_pipeline._load(TConfig(scene=name, asset_root=str(tmp_path)))
    assert str(t_err.value) == str(j_err.value)
    # an unknown scene is no substitute: the asset lookup's own error
    assert t_procgen.substitute_scene("no_such_scene", roots) is None
    with pytest.raises(FileNotFoundError, match="no_such_scene"):
        t_pipeline._load(TConfig(scene="no_such_scene", asset_root=str(tmp_path)))

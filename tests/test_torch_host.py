"""The port's host code against the JAX package's: scene loading (npz, OBJ,
synthetic), the BVH build, flatten and packers, the camera basis, the
tile-major ray planes and the BMP writer are bit-identical for the same
inputs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from parallel_ray_tracer_tpu.models import camera as j_camera
from parallel_ray_tracer_tpu.models import scene as j_scene
from parallel_ray_tracer_tpu.models.device_scene import device_scene_from_host
from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.ops import render as j_render
from parallel_ray_tracer_tpu.ops.bvh import build_bvh as j_build
from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh as j_flatten
from parallel_ray_tracer_tpu.utils import bmp as j_bmp
from parallel_ray_tracer_tpu_torch.models import camera as t_camera
from parallel_ray_tracer_tpu_torch.models import scene as t_scene
from parallel_ray_tracer_tpu_torch.ops import pack as t_pack
from parallel_ray_tracer_tpu_torch.ops import render as t_render
from parallel_ray_tracer_tpu_torch.ops.bvh import build_bvh as t_build
from parallel_ray_tracer_tpu_torch.ops.bvh_flat import flatten_bvh as t_flatten
from parallel_ray_tracer_tpu_torch.utils import bmp as t_bmp

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
SCENE_FIELDS = (
    "verts", "faces", "mat_idx", "mats_kd", "mats_ks", "mats_kr",
    "lights_pos", "lights_kl",
)
L = 8


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("name", ["car_boxed", "car_only"])
def test_scene_npz_load_identical(name):
    path = os.path.join(ASSETS, name + ".npz")
    js, ts = j_scene.load_scene_npz(path), t_scene.load_scene_npz(path)
    for f in SCENE_FIELDS:
        _same(getattr(js, f), getattr(ts, f))
    _same(js.triangle_vertices(), ts.triangle_vertices())


MTL = """newmtl red
Ns 250.0
Kd 0.6 0 0
Ks 0.5 0.5 0.5
Kr 0.2 0.1 0.1

newmtl far_kd
l1
l2
l3
l4
l5
Kd 0.9 0.9 0.9
"""

OBJ = """v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1.5
f 1 2 3
usemtl red
f 1/1/1 2/2/2 4/4/4
usemtl missing_name
f 2 3 4
usemtl far_kd
f 1 3 4
"""

LIGHTS = "0 -8 3 50 50 50\n1 2 3 4 5 6\n"


def test_obj_scene_load_identical(tmp_path):
    for name, text in (("triangles.obj", OBJ), ("triangles.mtl", MTL),
                       ("lights.obj", LIGHTS)):
        (tmp_path / name).write_text(text)
    js, ts = j_scene.load_scene(str(tmp_path)), t_scene.load_scene(str(tmp_path))
    assert ts.num_triangles == 4 and ts.num_lights == 2
    for f in SCENE_FIELDS:
        _same(getattr(js, f), getattr(ts, f))


@pytest.mark.parametrize("n,seed", [(100, 1), (2000, 7)])
def test_synthetic_scene_identical(n, seed):
    js, ts = j_scene.synthetic_scene(n, seed=seed), t_scene.synthetic_scene(n, seed=seed)
    for f in SCENE_FIELDS:
        _same(getattr(js, f), getattr(ts, f))


def test_bmp_bytes_and_read_identical(tmp_path):
    img = np.random.RandomState(5).uniform(-0.2, 1.2, (9, 13, 3)).astype(np.float32)
    data = j_bmp.bmp_bytes(img)
    assert t_bmp.bmp_bytes(img) == data
    path = str(tmp_path / "img.bmp")
    t_bmp.write_bmp(path, img)
    _same(j_bmp.read_bmp(path), t_bmp.read_bmp(path))


def _car_boxed():
    return j_scene.load_scene_npz(os.path.join(ASSETS, "car_boxed.npz"))


_CASES = {
    "blocker_h3": (blocker_cloud_scene, 3),
    "blocker_h6": (blocker_cloud_scene, 6),
    "car_boxed_h6": (_car_boxed, 6),
}


@pytest.fixture(scope="module", params=sorted(_CASES))
def built(request):
    make, heuristic = _CASES[request.param]
    sc = make()
    tv = sc.triangle_vertices()
    kw = dict(heuristic=heuristic, leaf_threshold=L, seed=1, true_sah=True)
    jflat = j_flatten(j_build(tv, **kw), tv, leaf_size=L)
    tflat = t_flatten(t_build(tv, **kw), tv, leaf_size=L)
    return sc, tv, jflat, tflat


def test_build_and_flatten_identical(built):
    _, _, jflat, tflat = built
    for f in ("node_min", "node_max", "count", "a", "slot_map"):
        _same(getattr(jflat, f), getattr(tflat, f))
    assert (jflat.leaf_size, jflat.depth) == (tflat.leaf_size, tflat.depth)


def test_pack_bvh4_and_attr_identical(built):
    sc, tv, jflat, tflat = built
    jp = j_pt.pack_bvh4(jflat, tv)
    tp = t_pack.pack_bvh4(tflat, tv)
    _same(jp.cbox, tp.cbox)
    _same(jp.cmeta, tp.cmeta)
    _same(jp.tri, tp.tri)
    _same(
        j_pt.pack_attr(jflat, sc.mat_idx, sc.mats_kd, sc.mats_ks, sc.mats_kr),
        t_pack.pack_attr(tflat, sc.mat_idx, sc.mats_kd, sc.mats_ks, sc.mats_kr),
    )
    for npop in (2, 8):
        assert j_pt.required_stack_depth(jflat.depth, 4, npop) == \
            t_pack.required_stack_depth(tflat.depth, 4, npop)
    # the per-ray stack bound from the table never exceeds the depth bound
    packed_depth = -(-tflat.depth // 2)
    assert t_pack.stack_need(tp.cmeta, 4) <= 3 * packed_depth + 2


def test_pack_lights_identical(built):
    sc = built[0]
    ambient = (0.5, 0.4, 0.3)
    ds = device_scene_from_host(sc, ambient=ambient)
    _same(
        np.asarray(j_pt.pack_lights(ds)),
        t_pack.pack_lights(sc.lights_pos, sc.lights_kl, ambient),
    )


@pytest.mark.parametrize("width,height", [(64, 32), (1920, 1080), (100, 50)])
def test_ray_basis_identical(width, height):
    cam_j = j_camera.default_camera()
    cam_t = t_camera.default_camera()
    for a, b in zip(j_camera.ray_basis(cam_j, width, height),
                    t_camera.ray_basis(cam_t, width, height)):
        _same(a, b)


@pytest.mark.parametrize("width,height,tr,tc", [
    (64, 64, 32, 32), (256, 16, 8, 128), (100, 50, 32, 32), (100, 50, 8, 128),
])
def test_generate_rays_tiled_identical(width, height, tr, tc):
    basis = j_camera.ray_basis(j_camera.default_camera(), width, height)
    jo, jd = j_render.generate_rays_tiled(
        tuple(jnp.asarray(a) for a in basis), width, height, tr, tc
    )
    to, td = t_render.generate_rays_tiled(basis, width, height, tr, tc,
                                           device="cpu")
    for a, b in zip((*jo, *jd), (*to, *td)):
        _same(a, b.numpy())
    img = np.arange(jo.x.shape[0] * 3, dtype=np.float32).reshape(-1, 3)
    _same(
        j_render.tiles_to_image(jnp.asarray(img), width, height, tr, tc),
        t_render.tiles_to_image(torch.from_numpy(img), width, height, tr, tc).numpy(),
    )


def test_config_fields_and_defaults_identical():
    import dataclasses

    from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
    from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig

    def fields(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert fields(JConfig) == fields(TConfig)

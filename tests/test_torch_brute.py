"""The brute-force tracer and renderer of the port against the JAX package:
every ray against every triangle (ops/trace_brute.py), the oracle that the
JAX package holds its BVH renders against (tests/test_spheres.py).

- closest_hit and occluded (through make_tracer, so with the scene's
  spheres) against JAX's on 8,192 rays, on 2,000 random triangles and on
  the blocker cloud with spheres: miss masks equal, t within atol 1e-4 /
  rtol 1e-5, idx agreement >= 0.999, blocked agreement >= 0.999.
- render_bruteforce of tests/test_spheres.py's scene (a floor, a diffuse
  and a mirror sphere, one light) at 64x48 with 2 bounces against JAX's,
  within the frame bounds of tests/test_fused.py (more than 99% of pixels
  within 1e-3, median below 1e-5); row_chunk gives the same frame to the
  bit.
- use_bvh=False and variant="bruteforce" through prepare + render(), and
  --no-bvh / --variant bruteforce through the command line on a scene
  folder whose spheres.obj holds the spheres, against JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from test_torch_frame import _assert_close
from test_torch_trace import _assert_hits
from parallel_ray_tracer_tpu import cli as j_cli
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.camera import default_camera
from parallel_ray_tracer_tpu.models.device_scene import device_scene_from_host as j_dsfh
from parallel_ray_tracer_tpu.models.scene import Scene as JScene
from parallel_ray_tracer_tpu.models.scene import synthetic_scene
from parallel_ray_tracer_tpu.ops import trace_brute as j_brute
from parallel_ray_tracer_tpu.ops.render import render_bruteforce as j_render_bruteforce
from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as JVec3
from parallel_ray_tracer_tpu_torch import cli, pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.models.camera import default_camera as t_default_camera
from parallel_ray_tracer_tpu_torch.models.device_scene import device_scene_from_host
from parallel_ray_tracer_tpu_torch.models.scene import Scene as TScene
from parallel_ray_tracer_tpu_torch.models.scene import load_scene
from parallel_ray_tracer_tpu_torch.ops import trace_brute
from parallel_ray_tracer_tpu_torch.ops.render import render_bruteforce
from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3 as TVec3
from parallel_ray_tracer_tpu_torch.utils.bmp import read_bmp

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

# tests/test_spheres.py's sphere_scene: a floor, a diffuse red sphere, a
# mirror sphere and one light.
SPHERE_SCENE = dict(
    verts=np.array([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]], np.float32),
    faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
    mat_idx=np.zeros(2, np.int32),
    mats_kd=np.array([[0.7, 0.7, 0.7], [0.7, 0.2, 0.2], [0.1, 0.1, 0.1]], np.float32),
    mats_ks=np.array([[0.0, 0.0, 0.0], [0.4, 0.4, 0.4], [0.2, 0.2, 0.2]], np.float32),
    mats_kr=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.8, 0.8, 0.8]], np.float32),
    lights_pos=np.array([[0.0, -5.0, 7.0]], np.float32),
    lights_kl=np.array([[40.0, 40.0, 40.0]], np.float32),
    spheres_center=np.array([[-1.2, 0.5, 1.0], [1.4, 1.0, 1.2]], np.float32),
    spheres_radius=np.array([1.0, 1.2], np.float32),
    spheres_mat=np.array([1, 2], np.int32),
)
W, H, BOUNCES = 64, 48, 2


def _j(planes):
    return JVec3(*(jnp.asarray(p) for p in planes))


def _t(planes):
    return TVec3(*(torch.as_tensor(np.ascontiguousarray(p)) for p in planes))


@pytest.mark.parametrize("name", ["synthetic2000", "blocker_spheres"])
def test_brute_hits_as_jax(name):
    sc = synthetic_scene(2000, seed=3) if name == "synthetic2000" else \
        blocker_cloud_scene(with_spheres=True)
    jds = j_dsfh(sc)
    tds = device_scene_from_host(sc, device="cpu")
    rng = np.random.RandomState(1)
    n = 8192
    lo, hi = sc.verts.min(0), sc.verts.max(0)
    o = rng.uniform(lo - 2, hi + 2, (n, 3)).astype(np.float32)
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    m2 = rng.uniform(0.0, 60.0, n).astype(np.float32)
    j_closest, j_occluded = j_brute.make_tracer(jds)
    t_closest, t_occluded = trace_brute.make_tracer(tds)
    jh, th = j_closest(_j(o.T), _j(d.T)), t_closest(_t(o.T), _t(d.T))
    same = _assert_hits(jh.t, jh.idx, th.t.numpy(), th.idx.numpy())
    assert (np.asarray(jh.norm_dir)[same] == th.norm_dir.numpy()[same]).all()
    if sc.num_spheres:
        assert (th.idx.numpy() >= tds.num_triangles).mean() > 0.05
    jb = np.asarray(j_occluded(_j(o.T), _j(d.T), jnp.asarray(m2)))
    tb = t_occluded(_t(o.T), _t(d.T), torch.as_tensor(m2)).numpy()
    assert (jb == tb).mean() >= 0.999 and 0.05 < tb.mean() < 0.95


def test_brute_chunks_bound_the_temporaries(monkeypatch):
    """A chunk holds at most `chunk` triangles and at most _CHUNK_ELEMS
    (rays x triangles); the hits do not depend on the chunking."""
    tds = device_scene_from_host(synthetic_scene(2000, seed=3), device="cpu")
    rng = np.random.RandomState(2)
    o = _t(rng.uniform(-6, 6, (3, 512)).astype(np.float32))
    d = _t(rng.normal(size=(3, 512)).astype(np.float32))
    ref = trace_brute.closest_hit(tds, o, d)
    assert [b - a for a, b in trace_brute._chunks(tds, 512, 512)][:1] == [512]
    monkeypatch.setitem(trace_brute._CHUNK_ELEMS, "cpu", 512 * 100)
    assert max(b - a for a, b in trace_brute._chunks(tds, 512, 512)) == 100
    h = trace_brute.closest_hit(tds, o, d)
    assert all(torch.equal(a, b) for a, b in zip(h, ref))


@pytest.fixture(scope="module")
def jax_sphere_frame():
    """JAX's brute-force frame of the sphere scene (tests/test_spheres.py)."""
    jds = j_dsfh(JScene(**SPHERE_SCENE))
    return np.asarray(j_render_bruteforce(jds, default_camera(), W, H, bounces=BOUNCES))


def test_render_bruteforce_as_jax(jax_sphere_frame):
    tds = device_scene_from_host(TScene(**SPHERE_SCENE), device="cpu")
    img = render_bruteforce(tds, t_default_camera(), W, H, bounces=BOUNCES)
    assert img.shape == (H, W, 3)
    _assert_close(jax_sphere_frame, img.numpy())
    img = img.numpy()   # as tests/test_spheres.py: the red sphere shows
    red = (img[..., 0] > img[..., 1] + 0.1) & (img[..., 0] > img[..., 2] + 0.1)
    assert red.sum() > 10 and img.std() > 0.05
    # the frame in 16-row bands is the same frame, to the bit
    banded = render_bruteforce(tds, t_default_camera(), W, H, bounces=BOUNCES,
                               row_chunk=16)
    assert torch.equal(banded, torch.as_tensor(img))
    with pytest.raises(ValueError, match="row_chunk"):
        render_bruteforce(tds, t_default_camera(), W, H, bounces=BOUNCES, row_chunk=20)


@pytest.mark.parametrize("kw", [dict(use_bvh=False), dict(variant="bruteforce")],
                         ids=["use_bvh=False", "variant=bruteforce"])
def test_pipeline_bruteforce_as_jax(kw, jax_sphere_frame):
    """prepare + render() of the sphere scene: use_bvh=False builds no BVH
    and every variant resolves to "bruteforce", as in JAX; an explicit
    "bruteforce" on a BVH pipeline renders the same frame."""
    cfg = dict(width=W, height=H, bounces=BOUNCES, use_native=False, mxu_leaf=False,
               tile_rows=32, tile_cols=32, **kw)
    tp = t_pipeline.prepare(TConfig(**cfg), scene=TScene(**SPHERE_SCENE), device="cpu")
    jp = j_pipeline.prepare(JConfig(**cfg), scene=JScene(**SPHERE_SCENE))
    variants = (None, "auto", "fused", "pallas", "bruteforce")
    assert [tp.resolved_variant(v) for v in variants] == \
        [jp.resolved_variant(v) for v in variants]
    if not kw.get("use_bvh", True):
        assert tp.flat is None and tp.tables is None and tp.build_ms == 0.0
        assert tp.resolved_variant("fused") == "bruteforce"
    assert tp.resolved_variant() == "bruteforce"
    _assert_close(jax_sphere_frame, tp.render().numpy())


def _write_sphere_folder(root):
    """tests/test_spheres.py's scene as an asset folder: triangles.obj and
    .mtl, lights.obj, and spheres.obj (material 0 is the loader's implicit
    black slot, so the MTL's materials are 1-3)."""
    folder = root / "spheres"
    folder.mkdir()
    (folder / "triangles.obj").write_text(
        "mtllib triangles.mtl\n"
        "v -8 -8 0\nv 8 -8 0\nv 8 8 0\nv -8 8 0\n"
        "usemtl floor\nf 1 2 3\nf 1 3 4\n")
    (folder / "triangles.mtl").write_text(   # 6-line blocks: see parse_materials
        "newmtl floor\nKd 0.7 0.7 0.7\nKs 0 0 0\nKr 0 0 0\nNs 10\nd 1\n"
        "newmtl red\nKd 0.7 0.2 0.2\nKs 0.4 0.4 0.4\nKr 0 0 0\nNs 10\nd 1\n"
        "newmtl mirror\nKd 0.1 0.1 0.1\nKs 0.2 0.2 0.2\nKr 0.8 0.8 0.8\nNs 10\nd 1\n")
    (folder / "lights.obj").write_text("0 -5 7 40 40 40\n")
    (folder / "spheres.obj").write_text("-1.2 0.5 1.0 1.0 2\n1.4 1.0 1.2 1.2 3\n")


def _settings(text):
    """The settings lines of a CLI run: "use_bvh: ..." as printed, and the
    "Time to build the bvh:" line by its label only (its milliseconds are a
    wall-clock reading, not a setting)."""
    return [ln if ln.startswith("use_bvh:") else ln.split(":")[0] + ":"
            for ln in text.splitlines() if ln.startswith(("use_bvh:", "Time to build"))]


@pytest.mark.parametrize("flag", [["--no-bvh"], ["--variant", "bruteforce"]], ids=" ".join)
def test_cli_bruteforce_renders_spheres_obj(flag, tmp_path, capsys):
    """The command line renders a --scene folder's spheres by brute force:
    rc 0, more than 99% of the BMP's pixels within one level of JAX's,
    JAX's settings lines."""
    _write_sphere_folder(tmp_path)
    argv = ["--scene", "spheres", "--asset-root", str(tmp_path), "--width", "32",
            "--height", "32", "--bounces", "2", "--warmup", "0", "--no-native", *flag]
    assert j_cli.main(argv + ["--output", str(tmp_path / "j.bmp")]) == 0
    j_out = capsys.readouterr().out
    assert cli.main(["--device", "cpu", *argv, "--output", str(tmp_path / "t.bmp")]) == 0
    t_out = capsys.readouterr().out
    assert "variant: bruteforce" in t_out
    j_lines, t_lines = _settings(j_out), _settings(t_out)
    assert [ln.split(", width:")[0] for ln in t_lines] == j_lines
    assert (not any(ln.startswith("Time to build") for ln in t_lines)) == ("--no-bvh" in flag)
    # the folder is the sphere scene: the same frame as from the arrays
    scene = load_scene(str(tmp_path / "spheres"))
    assert np.array_equal(scene.mats_kd[scene.mat_idx], SPHERE_SCENE["mats_kd"][SPHERE_SCENE["mat_idx"]])
    assert np.array_equal(scene.mats_kr[scene.spheres_mat],
                          SPHERE_SCENE["mats_kr"][SPHERE_SCENE["spheres_mat"]])
    ref = read_bmp(str(tmp_path / "j.bmp")).astype(np.int32)
    ours = read_bmp(str(tmp_path / "t.bmp")).astype(np.int32)
    assert ours.shape == ref.shape == (32, 32, 3) and ours.std() > 5
    assert (np.abs(ours - ref).max(-1) <= 1).mean() > 0.99

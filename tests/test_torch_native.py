"""The port's native host runtime (parallel_ray_tracer_tpu_torch/native/)
against the JAX package's and against the port's numpy builder, on the CPU.

- Trees: the port's C++ build equals the JAX package's C++ build bit for
  bit on the same triangles (same source, same flags, same machine): the
  flat tree (slot_map, node boxes, count, a) and the packed binary table
  (cbox, cmeta, tri). Against the port's numpy builder the flat trees agree
  as tests/test_native.py:89-105 holds JAX's, with both area formulas.
- Builds are deterministic per seed.
- Scene folders: an OBJ/MTL/lights/spheres folder written to tmp_path
  loads equal through load_scene_native (the port's and JAX's) and the
  Python parser.
- prepare(use_native=True) at widths 2, 4 and 8 (and the bf16 binary
  table) uploads the tables JAX's prepare(use_native=True) uploads, bit
  for bit, says which builder ran, and renders the frame JAX's packet
  tracer (variant="jax") renders on the native tree, within the bounds of
  tests/test_fused.py. On the CPU the port's frame runs the kernels' plain
  versions, which read no node table, so the tables' equality is what ties
  each width to JAX; the frame ties the slot order and the rows to it.
- use_native=False, and a host without g++, take the numpy builder.
- The `native` fixture skips only on a host without g++. JAX's builder can
  lose a build race between xdist workers and then never loads again;
  load_jax_native rebuilds it one worker at a time (a file lock of this
  test's own) and fails the tests only if it still does not load.
"""

import fcntl
import os
import shutil
import tempfile
import time

import numpy as np
import pytest
import torch

from conftest import blocker_cloud_scene
from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.scene import load_scene as j_load_scene
from parallel_ray_tracer_tpu.native import builder as jb
from parallel_ray_tracer_tpu_torch import pipeline as t_pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig as TConfig
from parallel_ray_tracer_tpu_torch.models.scene import load_scene as t_load_scene
from parallel_ray_tracer_tpu_torch.native import builder as tb
from parallel_ray_tracer_tpu_torch.ops.bvh import build_bvh
from parallel_ray_tracer_tpu_torch.ops.bvh_flat import flatten_bvh

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

FLAT = ("slot_map", "node_min", "node_max", "count", "a")
PACKED = ("cbox", "cmeta", "tri")
FRAME = dict(width=32, height=32, bounces=2, bvh_heuristic=6, tile_rows=32,
             tile_cols=32, mxu_leaf=False, use_native=True)
SCENE_FIELDS = ("verts", "faces", "mat_idx", "mats_kd", "mats_ks", "mats_kr",
                "lights_pos", "lights_kl", "spheres_center", "spheres_radius",
                "spheres_mat")


JB_LOCK = os.path.join(tempfile.gettempdir(), "test_torch_native.jb.lock")


def load_jax_native(timeout: float = 60.0) -> bool:
    """Whether JAX's native library loads, rebuilding it if it does not.

    JAX's builder (parallel_ray_tracer_tpu/native/builder.py) compiles
    straight into librtnative.so under a thread lock only, so an xdist
    worker can load a file another worker is still writing; it then sets
    _lib_failed and never tries again. Here the workers take a file lock of
    this test's own and, one at a time, reset the builder's state, rebuild
    through its own _compile() and load again, until it loads or `timeout`
    seconds have passed."""
    if jb.available():
        return True
    deadline = time.monotonic() + timeout
    with open(JB_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                jb._lib, jb._lib_failed = None, False
                if jb.available():    # another worker rebuilt it meanwhile
                    return True
                jb._lib_failed = False
                if jb._compile() and jb.available():
                    return True
                if time.monotonic() >= deadline:
                    return False
                time.sleep(1.0)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def native():
    """Both packages' native builders. Skips only on a host without g++;
    with g++ a library that does not load fails the test."""
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: both packages fall back to numpy")
    assert tb.available(), "g++ is present but the port's native library does not load"
    assert load_jax_native(), ("g++ is present but JAX's native library does not load, "
                               "even rebuilt one worker at a time for 60 s")
    return tb


def _tris(n=2000, seed=3):
    return np.random.RandomState(seed).rand(n, 3, 3).astype(np.float32)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("heuristic,true_sah", [(6, False), (6, True), (3, True)])
def test_native_tree_equals_jax_native(native, heuristic, true_sah):
    tv = _tris()
    kw = dict(heuristic=heuristic, leaf_threshold=8, leaf_size=8, true_sah=true_sah)
    tflat, tpacked, tstats = native.build_bvh_native(tv, **kw)
    jflat, jpacked, jstats = jb.build_bvh_native(tv, **kw)
    for f in FLAT:
        assert _bits_equal(getattr(tflat, f), getattr(jflat, f)), f
    assert tflat.depth == jflat.depth
    for f in PACKED:
        assert _bits_equal(getattr(tpacked, f), getattr(jpacked, f)), f
    assert tpacked.cmat is None and not tpacked.compressed
    assert tstats == jstats


@pytest.mark.parametrize("true_sah", [False, True])
def test_native_tree_matches_numpy(native, true_sah):
    """As tests/test_native.py:89-105: the same tree from both builders."""
    tv = _tris()
    flat_n, _, stats = native.build_bvh_native(tv, heuristic=6, leaf_threshold=8,
                                               leaf_size=8, true_sah=true_sah)
    bvh = build_bvh(tv, heuristic=6, leaf_threshold=8, true_sah=true_sah)
    flat_p = flatten_bvh(bvh, tv, leaf_size=8)
    assert np.array_equal(flat_n.slot_map, flat_p.slot_map)
    np.testing.assert_allclose(flat_n.node_min, flat_p.node_min)
    np.testing.assert_allclose(flat_n.node_max, flat_p.node_max)
    assert np.array_equal(flat_n.count, flat_p.count)
    assert np.array_equal(flat_n.a, flat_p.a)
    assert stats == bvh.stats


def test_native_deterministic_per_seed(native):
    tv = _tris(500, seed=5)
    a = native.build_bvh_native(tv, heuristic=3, seed=7)
    b = native.build_bvh_native(tv, heuristic=3, seed=7)
    c = native.build_bvh_native(tv, heuristic=3, seed=8)
    for f in FLAT:
        assert _bits_equal(getattr(a[0], f), getattr(b[0], f))
    for f in PACKED:
        assert _bits_equal(getattr(a[1], f), getattr(b[1], f))
    # heuristic 3 draws its split at random: another seed, another tree
    assert not np.array_equal(a[0].slot_map, c[0].slot_map)


def _write_folder(folder):
    """A scene folder in the reference's format: vertices on a 1/64 grid
    (exact in f32 and in decimal), faces before any usemtl (the loader's
    black slot 0), an unknown usemtl (keeps the current material), three
    materials of six lines each, two lights and two spheres."""
    rng = np.random.RandomState(11)
    verts = rng.randint(-512, 512, (60, 3)) / 64.0
    faces = rng.randint(1, 61, (40, 3))
    mtl = {"grey": ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25), (0.0, 0.0, 0.0)),
           "red": ((0.75, 0.125, 0.125), (0.5, 0.5, 0.5), (0.0, 0.0, 0.0)),
           "mirror": ((0.125, 0.125, 0.125), (0.25, 0.25, 0.25), (0.75, 0.75, 0.75))}
    obj = ["mtllib triangles.mtl"] + [f"v {x} {y} {z}" for x, y, z in verts]
    for k, (i, j, m) in enumerate(faces):
        if k in (4, 15, 27):
            obj.append(f"usemtl {('grey', 'red', 'mirror')[(k // 10) % 3]}")
        if k == 33:
            obj.append("usemtl no_such_material")
        obj.append(f"f {i} {j} {m}")
    files = {
        "triangles.obj": "\n".join(obj) + "\n",
        "triangles.mtl": "".join(
            f"newmtl {n}\nKd {' '.join(map(str, kd))}\nKs {' '.join(map(str, ks))}\n"
            f"Kr {' '.join(map(str, kr))}\nNs 10\nd 1\n" for n, (kd, ks, kr) in mtl.items()),
        "lights.obj": "0.0 -5.0 7.0 40.0 40.0 40.0\n2.5 1.5 6.0 10.0 20.0 30.0\n",
        "spheres.obj": "-1.25 0.5 1.0 1.0 2\n1.5 1.0 1.25 1.25 3\n",
    }
    os.makedirs(folder)
    for name, text in files.items():
        with open(os.path.join(folder, name), "w") as f:
            f.write(text)


def test_scene_folder_loads_equal(native, tmp_path):
    folder = str(tmp_path / "obj_scene")
    _write_folder(folder)
    sn = native.load_scene_native(folder)
    sp = t_load_scene(folder)
    sj = jb.load_scene_native(folder)
    sjp = j_load_scene(folder)
    assert sn.num_triangles == 40 and sn.lights_pos.shape == (2, 3)
    assert sn.spheres_radius.shape == (2,) and len(np.unique(sn.mat_idx)) >= 3
    for f in SCENE_FIELDS:
        for other in (sp, sj, sjp):
            assert _bits_equal(getattr(sn, f), getattr(other, f)), f


def test_prepare_loads_the_folder_natively(native, tmp_path):
    """An OBJ folder under asset_root goes through the native loader; the
    npz and procedural fallbacks come after it, as in JAX."""
    _write_folder(str(tmp_path / "obj_scene"))
    kw = dict(FRAME, scene="obj_scene", asset_root=str(tmp_path), bounces=1)
    tp = t_pipeline.prepare(TConfig(**kw), device="cpu")
    jp = j_pipeline.prepare(JConfig(**kw))
    assert tp.builder == "native"
    for f in SCENE_FIELDS:
        assert _bits_equal(getattr(tp.scene, f), getattr(jp.scene, f)), f


@pytest.fixture(scope="module")
def jax_native_frame():
    """JAX's prepare(use_native=True) on the blocker cloud, its frame by the
    packet tracer over the native tree (one compile for the module)."""
    jp = j_pipeline.prepare(JConfig(**FRAME), scene=blocker_cloud_scene())
    assert jp.bvh is None and jp.bvh_stats is not None    # JAX's native path
    return np.asarray(jp.render(variant="jax"))


@pytest.mark.parametrize("width,bf16", [(2, False), (4, False), (8, False), (2, True)],
                         ids=["w2", "w4", "w8", "w2_bf16"])
def test_prepare_native_as_jax(native, jax_native_frame, width, bf16):
    kw = dict(FRAME, bvh_width=width, bf16_bvh=bf16)
    sc = blocker_cloud_scene()
    jp = j_pipeline.prepare(JConfig(**kw), scene=sc)
    tp = t_pipeline.prepare(TConfig(**kw), scene=sc, device="cpu")
    assert tp.builder == "native" and tp.bvh_stats == jp.bvh_stats
    assert tp.flat.depth == jp.flat.depth
    for f in FLAT:
        assert _bits_equal(getattr(tp.flat, f), getattr(jp.flat, f)), f
    jt = [np.asarray(a) for a in jp.packed_dev[:4]]
    tt = (tp.tables.cbox, tp.tables.cmeta, tp.tables.tri, tp.tables.attr)
    for name, t, j in zip(("cbox", "cmeta", "tri", "attr"), tt, jt):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16).numpy().view(np.uint16)
            j = j.view(np.uint16)
        assert _bits_equal(t.numpy() if isinstance(t, torch.Tensor) else t, j), name
    assert tp.tables.compressed == jp.compressed
    img = tp.render().numpy()
    assert img.shape == jax_native_frame.shape and jax_native_frame.std() > 0.01
    diff = np.abs(img - jax_native_frame)
    assert (diff.max(axis=-1) < 1e-3).mean() > 0.99, diff.max()
    assert np.median(diff) < 1e-5


def test_numpy_builder_without_native(monkeypatch):
    """use_native=False takes the numpy builder; so does a host where g++
    fails (the fallback JAX has), with the same tables."""
    sc = blocker_cloud_scene()
    off = t_pipeline.prepare(TConfig(**dict(FRAME, use_native=False)), scene=sc, device="cpu")
    assert off.builder == "numpy"
    monkeypatch.setattr(tb, "get_lib", lambda: None)
    gone = t_pipeline.prepare(TConfig(**FRAME), scene=sc, device="cpu")
    assert gone.builder == "numpy"
    for name in ("cbox", "cmeta", "tri", "attr"):
        assert _bits_equal(getattr(off.tables, name).numpy(), getattr(gone.tables, name).numpy())
    assert tb.build_bvh_native(_tris(10)) is None and tb.load_scene_native("x") is None


def test_build_goes_to_the_package_build_dir(native):
    path = tb.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(os.path.dirname(path)) == tb.BUILD_ROOT
    assert os.path.basename(os.path.dirname(path)).startswith("native-")
    assert os.path.realpath(path) != os.path.realpath(jb._LIB)


def test_jax_native_recovers_from_a_failed_load(native, monkeypatch):
    """A worker that lost the race (JAX's builder left with _lib None and
    _lib_failed True) gets the library back through load_jax_native."""
    monkeypatch.setattr(jb, "_lib", None)
    monkeypatch.setattr(jb, "_lib_failed", True)
    assert not jb.available()
    assert load_jax_native()
    assert jb.available() and not jb._lib_failed
    flat = jb.build_bvh_native(_tris(50), heuristic=6)
    assert flat is not None

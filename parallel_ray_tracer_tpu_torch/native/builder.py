"""Copy of parallel_ray_tracer_tpu/native/builder.py: ctypes bindings for the
native host runtime (src/rtnative.cpp, a copy of the JAX package's).

The shared library is compiled with g++ at first use, with the JAX
package's flags, into `_build/native-<hash>/librtnative.so` of this
package, where the hash covers the source, the flags and the host's CPU
(-march=native), so a changed source or another machine builds anew. The
build goes to a temporary name and is renamed into place under a file
lock, so processes that start at once build it once and never load a
partial library. The JAX package's own librtnative.so is never loaded.

As in JAX, every entry point returns None when no compiler is found or
the build fails, and the caller falls back to the numpy implementations
(ops/bvh.py, ops/bvh_flat.py, ops/pack.py, models/scene.py): this is host
code, and the numpy path stays the portable fallback and the parity
oracle. BUILD_INFO records the library's path and build seconds, or why
it is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "rtnative.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_DIR), "_build")
# builder.py:28-40 of the JAX package.
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_lib_failed = False
BUILD_INFO: dict = {}


def _cpu_id() -> bytes:
    """The host CPU's model and flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return os.uname().machine.encode()


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + _cpu_id())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}", "librtnative.so")


def _compile(out: str) -> bool:
    """Build the library at `out` unless it is there; False if g++ fails or
    is missing."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lockf:
        try:
            import fcntl
            fcntl.flock(lockf, fcntl.LOCK_EX)
        except ImportError:
            pass
        if os.path.isfile(out):
            BUILD_INFO.update(path=out, seconds=0.0, cached=True)
            return True
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        t0 = time.perf_counter()
        try:
            subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        except (OSError, subprocess.SubprocessError) as e:
            BUILD_INFO.update(error=f"{type(e).__name__}: {e}")
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        BUILD_INFO.update(path=out, seconds=time.perf_counter() - t0, cached=False)
        return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        out = library_path()
        if not _compile(out):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            BUILD_INFO.update(error=f"OSError: {e}")
            _lib_failed = True
            return None

        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        lib.rt_bvh_build.restype = ctypes.c_void_p
        lib.rt_bvh_build.argtypes = [
            f32p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.c_int,
        ]
        for name in ("rt_bvh_n_flat_nodes", "rt_bvh_n_slots",
                     "rt_bvh_n_inner", "rt_bvh_n_groups"):
            getattr(lib, name).restype = ctypes.c_longlong
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.rt_bvh_depth.restype = ctypes.c_int
        lib.rt_bvh_depth.argtypes = [ctypes.c_void_p]
        lib.rt_bvh_get_flat.restype = None
        lib.rt_bvh_get_flat.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, i32p, i32p]
        lib.rt_bvh_get_packed.restype = None
        lib.rt_bvh_get_packed.argtypes = [ctypes.c_void_p, f32p, i32p, f32p]
        lib.rt_bvh_stats.restype = None
        lib.rt_bvh_stats.argtypes = [ctypes.c_void_p, f64p]
        lib.rt_bvh_free.restype = None
        lib.rt_bvh_free.argtypes = [ctypes.c_void_p]

        lib.rt_scene_load.restype = ctypes.c_void_p
        lib.rt_scene_load.argtypes = [ctypes.c_char_p]
        for name in ("rt_scene_n_verts", "rt_scene_n_faces",
                     "rt_scene_n_mats", "rt_scene_n_lights"):
            getattr(lib, name).restype = ctypes.c_longlong
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.rt_scene_get.restype = None
        lib.rt_scene_get.argtypes = [
            ctypes.c_void_p, f32p, i32p, i32p, f32p, f32p, f32p, f32p,
        ]
        lib.rt_scene_free.restype = None
        lib.rt_scene_free.argtypes = [ctypes.c_void_p]

        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_bvh_native(
    tri_verts: np.ndarray,
    heuristic: int = 6,
    max_depth: int = 32,
    leaf_threshold: int = 8,
    sah_bins: int = 32,
    seed: int = 1,
    leaf_size: int = 8,
    true_sah: bool = False,
):
    """Build + flatten + pack in C++. Returns (FlatBVH, PackedBVH, stats)
    with the same array semantics as the numpy path (the binary node table
    of ops/pack.pack_bvh, without its C-matrices), or None if the native
    library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    from ..ops.bvh_flat import FlatBVH
    from ..ops.pack import LANES, PackedBVH

    tv = np.ascontiguousarray(tri_verts, np.float32).reshape(-1, 9)
    T = tv.shape[0]
    h = lib.rt_bvh_build(
        tv, T, heuristic, max_depth, leaf_threshold, sah_bins, seed, leaf_size,
        int(true_sah),
    )
    if not h:
        return None
    try:
        n_nodes = lib.rt_bvh_n_flat_nodes(h)
        n_slots = lib.rt_bvh_n_slots(h)
        ni = lib.rt_bvh_n_inner(h)
        ng = lib.rt_bvh_n_groups(h)
        depth = lib.rt_bvh_depth(h)

        node_min = np.empty((n_nodes, 3), np.float32)
        node_max = np.empty((n_nodes, 3), np.float32)
        count = np.empty(n_nodes, np.int32)
        a = np.empty(n_nodes, np.int32)
        slot_map = np.empty(n_slots, np.int32)
        lib.rt_bvh_get_flat(h, node_min, node_max, count, a, slot_map)

        cbox = np.empty((ni, 16), np.float32)
        cmeta = np.empty((ni, 8), np.int32)
        # +1: the trailing all-zero NULL group row, as pack_bvh lays it out.
        tri = np.zeros((ng + 1, LANES), np.float32)
        lib.rt_bvh_get_packed(h, cbox, cmeta, tri[:ng])

        stats_raw = np.empty(5, np.float64)
        lib.rt_bvh_stats(h, stats_raw)
        stats = {
            "min_leaf": stats_raw[0],
            "max_leaf": stats_raw[1],
            "avg_leaf": stats_raw[2],
            "leaf_count": stats_raw[3],
            "n_nodes": stats_raw[4],
            "bytes": 32.0 * stats_raw[4],
        }
    finally:
        lib.rt_bvh_free(h)

    flat = FlatBVH(
        node_min=node_min, node_max=node_max, count=count, a=a,
        slot_map=slot_map, leaf_size=leaf_size, depth=depth,
    )
    packed = PackedBVH(cbox=cbox, cmeta=cmeta, tri=tri)
    return flat, packed, stats


def load_scene_native(asset_dir: str):
    """C++ OBJ/MTL/lights loader. Returns a Scene or None."""
    lib = get_lib()
    if lib is None:
        return None
    sp = lib.rt_scene_load(asset_dir.encode())
    if not sp:
        return None
    from ..models.scene import Scene

    try:
        V = lib.rt_scene_n_verts(sp)
        F = lib.rt_scene_n_faces(sp)
        M = lib.rt_scene_n_mats(sp)
        Lg = lib.rt_scene_n_lights(sp)
        verts = np.empty((V, 3), np.float32)
        faces = np.empty((F, 3), np.int32)
        mat_idx = np.empty(F, np.int32)
        kd = np.empty((M, 3), np.float32)
        ks = np.empty((M, 3), np.float32)
        kr = np.empty((M, 3), np.float32)
        lights = np.empty((Lg, 6), np.float32)
        lib.rt_scene_get(sp, verts, faces, mat_idx, kd, ks, kr, lights)
    finally:
        lib.rt_scene_free(sp)

    scene = Scene(
        verts=verts, faces=faces, mat_idx=mat_idx,
        mats_kd=kd, mats_ks=ks, mats_kr=kr,
        lights_pos=np.ascontiguousarray(lights[:, :3]),
        lights_kl=np.ascontiguousarray(lights[:, 3:]),
    )
    # The C++ loader does not parse spheres: the Python parse runs here so
    # that both loaders agree on sphere scenes.
    spheres_path = os.path.join(asset_dir, "spheres.obj")
    if os.path.exists(spheres_path):
        from ..models.scene import load_spheres

        with open(spheres_path) as f:
            c, r, m = load_spheres(f.read())
        scene.spheres_center, scene.spheres_radius, scene.spheres_mat = c, r, m
    return scene

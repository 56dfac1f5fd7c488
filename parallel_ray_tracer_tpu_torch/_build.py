"""Build and load the CUDA kernels (csrc/) as a plain C shared library.

nvcc compiles csrc/trace_kernels.cu for sm_90a into `_build/<hash>/`, where
the hash covers the sources and the flags, so a changed source builds anew
and an unchanged one is reused. The build happens at first use, inside the
call that launches a kernel; importing this module builds nothing. The
library is loaded with ctypes; pointers and the stream pass as c_void_p.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("trace.cuh", "trace_kernels.cu")
BUILD_ROOT = os.path.join(_PKG, "_build")

# -fmad=false: products round on their own, as in the plain versions and the
# JAX kernels (see csrc/trace.cuh). No --use_fast_math: division and sqrt
# stay IEEE-exact.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _digest(), "libtrace.so")


def build() -> str:
    """Compile the library unless this source hash is built; returns its path.

    The .so is written under a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a partial library."""
    out = library_path()
    if os.path.isfile(out):
        BUILD_INFO.update(path=out, seconds=0.0, cached=True)
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, "trace_kernels.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = os.path.join(os.path.dirname(out), "build.log")
    with open(log, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=out, seconds=seconds, cached=False, log=log)
    return out


def load_library() -> ctypes.CDLL:
    """The built kernel library, with argument types set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rt_closest.argtypes = [P] * 10 + [I] + [P] * 6
    lib.rt_occluded.argtypes = [P] * 10 + [I] + [P] * 3
    lib.rt_frame.argtypes = [P] * 11 + [I, I, I] + [P] * 3
    for fn in (lib.rt_closest, lib.rt_occluded, lib.rt_frame):
        fn.restype = I
    lib.rt_error_string.argtypes = [I]
    lib.rt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(code: int) -> str:
    return load_library().rt_error_string(int(code)).decode()

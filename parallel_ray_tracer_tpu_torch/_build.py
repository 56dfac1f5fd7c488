"""Build and load the CUDA kernels (csrc/) as a plain C shared library.

nvcc compiles each unit of csrc/ for sm_90a, as many at once as the
process has CPUs (one process per object: the C entry points, one unit per
node arity, box format, leaf mode (resident FP32, streamed, MXU) and stack
tier, compiled once for each leaf size it holds, and the nine units of the
microbench probes), and links them into `_build/<hash>/libtrace.so`, where
the hash covers the sources and the flags, so a changed source builds anew
and an unchanged one is reused. The build happens at first use, inside the
call that launches a kernel; importing this module builds nothing. The
library is loaded with ctypes; pointers and the stream pass as c_void_p.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import resource
import subprocess
import tempfile
import time
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
# One unit per node arity, box format and leaf mode (`s` streamed leaf
# rows, `m` the MXU leaf), each again with a `d` suffix for the DEEP stack
# tier (csrc/trace.cuh). Each is compiled once per leaf size (RT_UNIT_LEAF,
# csrc/trace_launch.cuh): the FP32 units at every size of LEAF_SIZES, the
# MXU units at MXU_LEAF_SIZES only (JAX takes its MXU leaf at L = 4 and 8
# only, and rt_mxu_quants holds no other size).
_FP32_UNITS = ("a2", "a4", "a8", "a4p", "a8p", "a2h", "a4s", "a8s", "a4ps", "a8ps")
_MXU_UNITS = ("a4m", "a8m", "a4pm", "a8pm")
LEAF_SIZES = (8, 4, 2, 1)
MXU_LEAF_SIZES = (8, 4)
# The probes of microbench/ (kernels A, B and C, D; the bf16 chains and slab
# pairs; the inner-visit probes of rows 15i and 15j, whose kernel is
# microbench_inner.cuh; the branch probe of row 15l; the child-parallel and
# tensor-core inner-visit probes of rows 15k and 15m), which include
# trace.cuh.
MICROBENCH_UNITS = ("microbench_leaf.cu", "microbench_probes.cu", "microbench_overlap.cu",
                    "microbench_bf16.cu", "microbench_inner.cu", "microbench_glue.cu",
                    "microbench_cond.cu", "microbench_tiled.cu", "microbench_mxu_inner.cu")
FP32_SOURCES = tuple(f"trace_{u}{tier}.cu" for tier in ("", "d") for u in _FP32_UNITS)
MXU_SOURCES = tuple(f"trace_{u}{tier}.cu" for tier in ("", "d") for u in _MXU_UNITS)
TIER_SOURCES = FP32_SOURCES + MXU_SOURCES
SOURCES = ("trace.cuh", "trace_launch.cuh", "microbench_inner.cuh", "trace_kernels.cu") \
    + TIER_SOURCES + MICROBENCH_UNITS
# The objects, each {name: (source, extra nvcc flags)}: a tier unit at leaf
# size 8 is named by its source, at another leaf size L by its source and
# `.l<L>`.
UNITS = {"trace_kernels.cu": ("trace_kernels.cu", ()),
         **{src if leaf == 8 else f"{src}.l{leaf}": (src, (f"-DRT_UNIT_LEAF={leaf}",))
            for leaf in LEAF_SIZES for src in TIER_SOURCES
            if leaf in MXU_LEAF_SIZES or src in FP32_SOURCES},
         **{src: (src, ()) for src in MICROBENCH_UNITS}}
BUILD_ROOT = os.path.join(_PKG, "_build")

# -fmad=false: products round on their own, as in the plain versions and the
# JAX kernels (see csrc/trace.cuh). No --use_fast_math: division and sqrt
# stay IEEE-exact.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# The traversal kernels' C entries (csrc/trace_kernels.cu) and their
# argument types, set on every library loaded here or by compare_frames.py
# (which loads other commits' libraries beside this one's).
ENTRY_ARGTYPES = {
    "rt_closest": [_P] * 11 + [_I] * 6 + [_P] * 8,
    "rt_occluded": [_P] * 11 + [_I] * 6 + [_P] * 5,
    "rt_frame": [_P] * 12 + [_I, _P] + [_I] * 8 + [_P] * 5,
}


def bind_entries(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set ENTRY_ARGTYPES, returning int, on a kernel library."""
    for name, argtypes in ENTRY_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    return lib


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _digest() -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(UNITS)).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _digest(), "libtrace.so")


def object_path(unit: str) -> str:
    """The object file of one of UNITS, kept beside the library
    (microbench/sass.py reads the probes' SASS from it)."""
    return os.path.join(BUILD_ROOT, _digest(), "obj", unit + ".o")


def _words(path: str) -> list:
    try:
        with open(path) as f:
            return f.read().split()
    except OSError:
        return []


def usable_cpus() -> dict:
    """The CPUs this process may really use: its affinity mask, capped by its
    cgroup's CPU quota where there is one (cgroup v2 `cpu.max`, v1
    `cpu.cfs_quota_us` over `cpu.cfs_period_us`)."""
    affinity = len(os.sched_getaffinity(0))
    v1 = "/sys/fs/cgroup/cpu/cpu.cfs_"
    limit = _words("/sys/fs/cgroup/cpu.max") or _words(v1 + "quota_us") + _words(v1 + "period_us")
    quota = (int(limit[0]) / int(limit[1])
             if len(limit) == 2 and limit[0] not in ("max", "-1") else None)
    usable = affinity if quota is None else max(1, min(affinity, math.ceil(quota)))
    return {"affinity": affinity, "cgroup_quota": quota, "usable": usable}


def _cost(unit: str) -> int:
    """A unit's relative compile cost, to start the longest first:
    microbench_glue.cu takes the most CPU seconds, then the MXU tier units,
    about twice the others (the build record keeps each unit's)."""
    src = UNITS[unit][0]
    if src == "microbench_glue.cu":
        return 3
    return 2 if src.startswith("trace_a") and "m" in src[len("trace_a"):] else 1


def build() -> str:
    """Compile the library unless this source hash is built; returns its path.

    The units compile in parallel into a temporary directory, as many nvcc
    processes at once as this process may use CPUs, the costliest first;
    the .so is linked under a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a partial library; the
    objects are kept in obj/ beside it. BUILD_INFO records the
    wall seconds, the CPU seconds of all nvcc processes and of each unit's,
    each unit's wall seconds, the units, the host's cores, the CPUs the
    process may use and the jobs."""
    out = library_path()
    if os.path.isfile(out):
        BUILD_INFO.update(path=out, seconds=0.0, cached=True)
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    nvcc = _nvcc()
    cpus = usable_cpus()
    jobs = cpus["usable"]
    t0 = time.perf_counter()
    cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    log = os.path.join(os.path.dirname(out), "build.log")
    unit_cpu, unit_wall = {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp, \
            open(log, "w") as logf:
        objs = {unit: os.path.join(tmp, unit + ".o") for unit in UNITS}
        pending = sorted(UNITS, key=_cost, reverse=True)
        running, failed = {}, []
        while pending or running:
            while pending and len(running) < jobs:
                unit = pending.pop(0)
                src, flags = UNITS[unit]
                cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", objs[unit], os.path.join(CSRC, src)]
                with open(objs[unit] + ".log", "w") as f:   # a file: a long log never blocks nvcc
                    proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
                running[proc.pid] = (unit, cmd, proc, time.perf_counter())
            time.sleep(0.02)
            for pid in list(running):
                # wait4 reaps the unit with its rusage (nvcc's own and its
                # children's, which nvcc waits for)
                done, status, usage = os.wait4(pid, os.WNOHANG)
                if done == 0:
                    continue
                unit, cmd, proc, start = running.pop(pid)
                proc.returncode = os.waitstatus_to_exitcode(status)
                unit_wall[unit] = time.perf_counter() - start
                unit_cpu[unit] = usage.ru_utime + usage.ru_stime
                with open(objs[unit] + ".log") as f:
                    text = f.read()
                logf.write(" ".join(cmd) + "\n" + text)
                if proc.returncode != 0:
                    failed.append(f"{unit} ({proc.returncode}):\n{text[-4000:]}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        so = os.path.join(tmp, "libtrace.so")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs.values()]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logf.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.makedirs(os.path.dirname(object_path("trace_kernels.cu")), exist_ok=True)
        for unit, obj in objs.items():
            os.replace(obj, object_path(unit))
        os.replace(so, out)
    cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    BUILD_INFO.update(path=out, seconds=time.perf_counter() - t0, cached=False,
                      log=log, units=len(UNITS), cores=os.cpu_count(), cpus=cpus, jobs=jobs,
                      cpu_seconds=(cpu1.ru_utime - cpu0.ru_utime)
                      + (cpu1.ru_stime - cpu0.ru_stime), unit_cpu_seconds=unit_cpu,
                      unit_wall_seconds=unit_wall)
    return out


def load_library() -> ctypes.CDLL:
    """The built kernel library, with argument types set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = bind_entries(ctypes.CDLL(build()))
    P, I = _P, _I
    lib.rt_frame_info.argtypes = [I] * 8 + [P]
    lib.rt_frame_info.restype = I
    lib.mb_leaf.argtypes = [P] * 6 + [I] + [P] * 4 + [I] * 9 + [P] * 3
    lib.mb_stage.argtypes = [P, I, P, P, P]
    lib.mb_smem_optin.argtypes = [P]
    lib.mb_gather.argtypes = [P, I, I, P, P, P, P]
    lib.mb_overlap.argtypes = [P] * 6 + [I] + [P] * 3 + [I] * 7 + [P] * 8
    lib.mb_chain.argtypes = [P, P] + [I] * 6 + [P, P]
    lib.mb_slab.argtypes = [P] * 7 + [I] * 4 + [P, P]
    for fn in (lib.mb_inner, lib.mb_glue):
        fn.argtypes = [P] * 6 + [I] + [P] * 3 + [I] + [P] * 2 + [I] * 9 + [P] * 4
    for fn in (lib.mb_inner_occupancy, lib.mb_glue_occupancy):
        fn.argtypes = [I] * 7 + [P]
    lib.mb_cond.argtypes = [P, P] + [I] * 4 + [P] * 3
    lib.mb_tiled.argtypes = [P] * 6 + [I, P] + [I] * 5 + [P] * 3
    lib.mb_mxu_inner.argtypes = [P] * 6 + [I] + [P] * 5 + [I] * 6 + [P] * 4
    for fn in (lib.mb_leaf, lib.mb_stage, lib.mb_smem_optin, lib.mb_gather, lib.mb_overlap,
               lib.mb_chain, lib.mb_slab, lib.mb_inner, lib.mb_glue, lib.mb_inner_occupancy,
               lib.mb_glue_occupancy, lib.mb_cond, lib.mb_tiled, lib.mb_mxu_inner):
        fn.restype = I
    lib.rt_error_string.argtypes = [I]
    lib.rt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(code: int) -> str:
    return load_library().rt_error_string(int(code)).decode()

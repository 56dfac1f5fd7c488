#!/usr/bin/env python3
"""Time the frame kernels of this tree against those of other trees, in turns.

    python3 compare_frames.py --other parent=DIR [--other NAME=DIR ...]
                              [--out FILE]

Each DIR is a checkout of this repository (another commit, or a copy with
a variant of csrc/); its kernel library is built there by its own
parallel_ray_tracer_tpu_torch/_build.py, in a subprocess, and loaded beside
this tree's. car_boxed 1920x1080 with 4 bounces (chip_smoke.py's main path)
is prepared once per table with this tree's package: the width-4 tables at
L = 8 with the FP32 leaf (`frame<4>`) and the MXU leaf (`frame_mxu<4>`),
as chip_smoke.py's CFG and MXU_CFG, and at L = 2 with the FP32 leaf
(`frame<4,l2>`) and at L = 4 with the MXU leaf (`frame_mxu<4,l4>`), at the
command line's leaf threshold 8. Every library
renders each table through this tree's `ops/cuda_trace.frame_tiles` (the
C entry `rt_frame` is the same in every commit that has one), in turns:
the others, this tree, this tree, the others in reverse (parent, change,
change, parent), each turn the median of 50 calls after 10, timed with
CUDA events. It prints one JSON line per table: each library's turns and
median, its ratio to this tree's, whether its frame equals this tree's bit
for bit (and the largest difference), the work counts of every library's
counting instance, and registers, stack frame, spills and blocks per SM of
each library's instance (this tree's from rt_frame_info; another's from
its ptxas log: registers allocated 8 at a time, 65,536 a multiprocessor,
4 warps a block, at most 32 blocks). The last line is the card's name
and power limit as nvidia-smi reports them.

It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WARMUP, TIMED = 10, 50
# (name, leaf size, MXU leaf): the width-4 tables
CASES = (("frame<4>", 8, False), ("frame_mxu<4>", 8, True),
         ("frame<4,l2>", 2, False), ("frame_mxu<4,l4>", 4, True))
BUILD_SNIPPET = ("import sys; sys.path.insert(0, '.'); "
                 "from parallel_ray_tracer_tpu_torch import _build; print(_build.build())")


def time_ms(fn):
    for _ in range(WARMUP):
        fn()
    pairs = []
    for _ in range(TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def blocks_per_sm(registers: int, block: int = 128) -> int:
    """Resident blocks of `block` threads a multiprocessor holds by registers."""
    warps = 65536 // (-(-max(registers, 1) // 8) * 8 * 32)
    return min(warps // (block // 32), 32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="another checkout whose frame kernels are timed in turns")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_frames: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from parallel_ray_tracer_tpu_torch import _build, pipeline
    from parallel_ray_tracer_tpu_torch.config import RenderConfig
    from parallel_ray_tracer_tpu_torch.ops import cuda_trace as ct
    from parallel_ray_tracer_tpu_torch.ops import render as R
    from chip_smoke import read_ptxas

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    t0 = time.perf_counter()
    libs = {"this": _build.load_library()}
    logs = {"this": os.path.join(os.path.dirname(_build.library_path()), "build.log")}
    builds = {"this": time.perf_counter() - t0}
    for spec in args.other:
        name, _, root = spec.partition("=")
        t0 = time.perf_counter()
        so = subprocess.run([sys.executable, "-c", BUILD_SNIPPET], cwd=root, check=True,
                            capture_output=True, text=True).stdout.strip().splitlines()[-1]
        builds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rt_frame.argtypes = [P] * 12 + [I, P] + [I] * 8 + [P] * 5
        lib.rt_frame.restype = I
        libs[name] = lib
        logs[name] = os.path.join(os.path.dirname(so), "build.log")
    ptxas = {k: read_ptxas(v if os.path.exists(v) else None) for k, v in logs.items()}
    emit({"builds_s": builds})
    others = [k for k in libs if k != "this"]
    order = others + ["this", "this"] + others[::-1]
    default_lib = ct.load_library

    for case, leaf, mxu in CASES:
        cut = {} if leaf == 8 else dict(leaf_size=leaf, leaf_threshold=8)
        cfg = RenderConfig(scene="car_boxed", width=1920, height=1080, bounces=4,
                           bvh_heuristic=6, tile_rows=32, tile_cols=32, mxu_leaf=mxu, **cut)
        p = pipeline.prepare(cfg)
        T = p.tables
        assert (T.cmat is not None) == mxu, case
        o, d = R._tiled_planes(p.camera(), 1920, 1080, 32, 32, p.device)
        kw = dict(bounces=4, leaf_size=T.leaf_size, stack_depth=T.stack_depth,
                  compressed=T.compressed, cmat=T.cmat)

        def frame(name, counters=False):
            ct.load_library = lambda: libs[name]
            try:
                return ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, o, d,
                                      counters=counters, **kw)
            finally:
                ct.load_library = default_lib

        turns = [(name, time_ms(lambda: frame(name))) for name in order]
        ref = torch.stack(list(frame("this")))
        rec = {"case": case, "card": card, "rays": o.x.numel(), "turns": turns, "libs": {}}
        this_ms = statistics.median([t for n, t in turns if n == "this"])
        for name in libs:
            img = torch.stack(list(frame(name)))
            _, counts = frame(name, counters=True)
            ms = statistics.median([t for n, t in turns if n == name])
            mangled = [k for k in ptxas[name] if "frame_kernel" in k
                       and k.startswith(f"_Z12frame_kernelILi4EL5RtBox0ELb0ELb0ELb0ELb{int(mxu)}ELi{leaf}ELb0E")]
            row = ptxas[name].get(mangled[0], {}) if mangled else {}
            lr = {"ms": ms, "vs_this": ms / this_ms, "bitwise_equal": bool(torch.equal(img, ref)),
                  "max_abs_diff": float((img - ref).abs().max()),
                  "counts": counts.cpu().tolist(), "ptxas": row,
                  "blocks_per_sm_by_registers": blocks_per_sm(row.get("registers", 0))}
            if name == "this":
                lr["count_names"] = list(ct.MXU_COUNTS if mxu else ct.COUNTS)
                lr["frame_info"] = ct.frame_info(4, leaf_size=leaf, mxu=mxu)
            rec["libs"][name] = lr
        emit(rec)
        del p, T
    emit({"card": card})
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

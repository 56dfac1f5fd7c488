#!/usr/bin/env python3
"""Time the frame kernels of this tree against those of other trees, in turns.

    python3 compare_frames.py --other parent=DIR [--other NAME=DIR ...]
                              [--passes frame|stream|resident|mxu] [--out FILE]

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

--passes stream times the streamed traversal kernels instead, through the
C entries rt_closest and rt_occluded of every library (this tree's
ops/cuda_trace wrappers, the tables padded as prepare pads streamed ones),
on the passes of STREAM_TABLES: synthetic_600k's primary closest pass and
its "auto" render() (closest_full_stream<4> for each bounce), the primary
pass of the same scene at 2,000,000 triangles (tri rows of 128 MB, well
past the 50 MB L2; synthetic_600k's 38 MB nearly fit it); car_boxed
1080p at L = 8 (closest, closest_full and occluded at width 4, f32 boxes;
closest_full at width 8 on bf16 pair rows), at L = 2 (closest, width 4)
and at L = 1 (occluded, width 8, bf16 pair rows), both at leaf threshold
8; and the DEEP stack tier's closest_full and occluded at width 4 on
models/procgen.chain_scene (chip_smoke.py's DEEP_CFG), whose 48-level
tree passes the standard stack. Primary rays are the frame's; shadow rays
go from light 0 to each primary hit of the resident pass. A round of
turns is the others, this tree, this tree's resident twin (stream=False)
twice, this tree, the others in reverse; a table takes rounds until they
have run STREAM_ROUND_S seconds, at least MIN_ROUNDS and at most
STREAM_ROUNDS of them, so that
a pass of a tenth of a millisecond, whose turns differ by 10-20% on one
card, gets as many turns as its time allows. Each line holds every library's median and ratio to this tree's,
the resident twin's median and this tree's ratio to it, whether each
library's outputs equal this tree's bit for bit (and the twin's), each
library's stream counts (fills, sync fetches, leaf visits) from its
counting instance, and the registers, stack frame and spills of each
library's timed instance and of the twin.

--passes resident times the resident instances (stream=False) the same
way, through the same C entries, on RESIDENT_TABLES: synthetic_600k's
primary closest<4> pass and its render() with stream=False; car_boxed
1080p closest<4>, closest_full<4>, occluded<4>, closest_full<2>,
occluded<2>, closest_full<8,bf16>, closest<4,l4>, closest<4,l2> and
occluded<8,bf16,l1>;
and the chain scene's DEEP closest_full<4> and occluded<4>. A round is the
others, this tree twice, the others in reverse. Each line holds every
library's median and ratio to this tree's; its agreement with this tree's
outputs (t and the miss mask bit for bit, the rays whose idx differs and
how many of them are exact-t ties, the other planes where idx agrees; a
mask or a frame bit for bit); its work and warp-step counts (lanes a
step of the inner and the leaf branch, distinct rows a leaf step; a
library that keeps no step counts reads 0 there); and the registers,
stack frame and spills of its timed instance.

--passes mxu times the MXU pass instances (the C-matrix table passed, the
tables of prepare with the MXU leaf) the same way, on MXU_TABLES: car_boxed
1080p closest_mxu<4>, closest_full_mxu<4>, occluded_mxu<4>,
closest_full_mxu<8>, occluded_mxu<8,bf16>, closest_full_mxu<4,l4> and
occluded_mxu<4,l4>; the chain scene's DEEP closest_full_mxu<4> and
occluded_mxu<4>; and car_boxed's pass-based render(variant="pallas") with
the MXU leaf (4 closest_full_mxu<4> and 4 occluded_mxu<4> launches and
their glue). A round is the others, this tree, this tree's FP32 twin (the
same call without the C-matrix table) twice, this tree, the others in
reverse. Each line holds what --passes resident's lines hold, the twin's
median and this tree's ratio to it, and from each library's counting
instance the lanes served an mma batch, the batches a ray and the leaf
steps a ray (warp steps over traversals; null for a library that keeps
no step counts).

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
# --passes stream: (table, pipeline, kernel, rays); a pipeline is
# (bvh_width, leaf size, bf16 pair rows) of car_boxed 1080p, a number of
# triangles of the synthetic scene (chip_smoke.py's SYNTHETIC_600K at that
# count), or "chain" (chip_smoke.py's DEEP_CFG on the chain scene, width 4).
# "render" is the pipeline's "auto" render().
STREAM_TABLES = (
    ("closest_stream<4> synthetic_600k primary", 600_000, "closest", "primary"),
    ("render() auto synthetic_600k (closest_full_stream<4> x 4)", 600_000, "render", None),
    ("closest_stream<4> synthetic_2m primary", 2_000_000, "closest", "primary"),
    ("closest_stream<4>", (4, 8, False), "closest", "primary"),
    ("closest_full_stream<4>", (4, 8, False), "closest_full", "primary"),
    ("occluded_stream<4>", (4, 8, False), "occluded", "shadow"),
    ("closest_full_stream<8,bf16>", (8, 8, True), "closest_full", "primary"),
    ("closest_stream<4,l2>", (4, 2, False), "closest", "primary"),
    ("occluded_stream<8,bf16,l1>", (8, 1, True), "occluded", "shadow"),
    ("closest_full_stream<4,deep>", "chain", "closest_full", "primary"),
    ("occluded_stream<4,deep>", "chain", "occluded", "shadow"),
)
# --passes resident: the resident (stream=False) instances, on the same
# pipelines: synthetic_600k's primary pass and its render() with
# stream=False (closest_full<4> for each bounce), car_boxed 1080p at widths
# 4, 2 and 8 (bf16 pair rows) and leaf sizes 8, 4, 2 and 1, and the
# chain's DEEP tier.
RESIDENT_TABLES = (
    ("closest<4> synthetic_600k primary", 600_000, "closest", "primary"),
    ("render() synthetic_600k stream=False (closest_full<4> x 4)", 600_000, "render", None),
    ("closest<4>", (4, 8, False), "closest", "primary"),
    ("closest_full<4>", (4, 8, False), "closest_full", "primary"),
    ("occluded<4>", (4, 8, False), "occluded", "shadow"),
    ("closest_full<2>", (2, 8, False), "closest_full", "primary"),
    ("occluded<2>", (2, 8, False), "occluded", "shadow"),
    ("closest_full<8,bf16>", (8, 8, True), "closest_full", "primary"),
    ("closest<4,l4>", (4, 4, False), "closest", "primary"),
    ("closest<4,l2>", (4, 2, False), "closest", "primary"),
    ("occluded<8,bf16,l1>", (8, 1, True), "occluded", "shadow"),
    ("closest_full<4,deep>", "chain", "closest_full", "primary"),
    ("occluded<4,deep>", "chain", "occluded", "shadow"),
)
# --passes mxu: the MXU pass instances, on car_boxed's tables of prepare
# with the MXU leaf (the default) at widths 4 and 8 (bf16 pair rows at 8)
# and leaf sizes 8 and 4, and on the chain's DEEP tier with the MXU leaf;
# "render" is car_boxed's pass-based render(variant="pallas").
MXU_TABLES = (
    ("closest_mxu<4>", (4, 8, False), "closest", "primary"),
    ("closest_full_mxu<4>", (4, 8, False), "closest_full", "primary"),
    ("occluded_mxu<4>", (4, 8, False), "occluded", "shadow"),
    ("closest_full_mxu<8>", (8, 8, False), "closest_full", "primary"),
    ("occluded_mxu<8,bf16>", (8, 8, True), "occluded", "shadow"),
    ("closest_full_mxu<4,l4>", (4, 4, False), "closest_full", "primary"),
    ("occluded_mxu<4,l4>", (4, 4, False), "occluded", "shadow"),
    ("closest_full_mxu<4,deep>", "chain", "closest_full", "primary"),
    ("occluded_mxu<4,deep>", "chain", "occluded", "shadow"),
    ("render() pallas (closest_full_mxu<4> x 4, occluded_mxu<4> x 4)", (4, 8, False),
     "render", None),
)
# A table takes rounds until they have run STREAM_ROUND_S seconds, at least
# MIN_ROUNDS (a pass-based render, host-bound, swings by 5-30% a turn) and at most
# STREAM_ROUNDS.
STREAM_ROUND_S, MIN_ROUNDS, STREAM_ROUNDS = 2.0, 5, 10
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


class Libs:
    """The kernel libraries by name; call(name, fn) runs fn with this tree's
    ops/cuda_trace wrappers launching library `name`'s kernels."""

    def __init__(self, ct, libs):
        self.ct, self.libs, self.default = ct, libs, ct.load_library

    def call(self, name, fn):
        self.ct.load_library = lambda: self.libs[name]
        try:
            return fn()
        finally:
            self.ct.load_library = self.default


def ptxas_row(ptxas, prefix):
    """Registers, stack and spills of the one kernel whose mangled name
    starts with prefix, or {}."""
    names = [k for k in ptxas if k.startswith(prefix)]
    return ptxas[names[0]] if names else {}


def frame_passes(L, ptxas, order, card, emit):
    from parallel_ray_tracer_tpu_torch import pipeline
    from parallel_ray_tracer_tpu_torch.config import RenderConfig
    from parallel_ray_tracer_tpu_torch.ops import render as R

    ct = L.ct
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
            return L.call(name, lambda: ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb,
                                                       o, d, counters=counters, **kw))

        turns = [(name, time_ms(lambda: frame(name))) for name in order]
        ref = torch.stack(list(frame("this")))
        rec = {"case": case, "card": card, "rays": o.x.numel(), "turns": turns, "libs": {}}
        this_ms = statistics.median([t for n, t in turns if n == "this"])
        for name in L.libs:
            img = torch.stack(list(frame(name)))
            _, counts = frame(name, counters=True)
            ms = statistics.median([t for n, t in turns if n == name])
            row = ptxas_row(ptxas[name], "_Z12frame_kernelILi4EL5RtBox0ELb0ELb0ELb0ELb"
                            f"{int(mxu)}ELi{leaf}ELb0E")
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


def hit_agreement(out, ref) -> dict:
    """How a pass's outputs agree with this tree's: bit for bit overall;
    for hits, t and the miss mask bit for bit, the rays whose idx differs
    and of those the ties (t equal bit for bit, so both libraries' triangles
    gave that t and the first one visited was kept), and the other planes
    where idx agrees; for a mask or a frame, the differing elements."""
    if isinstance(out, torch.Tensor):
        return {"bitwise_equal": bool(torch.equal(out, ref)),
                "differ": int((out != ref).sum()),
                "max_abs_diff": float((out.float() - ref.float()).abs().max())}
    def planes(x):
        return (x,) if isinstance(x, torch.Tensor) else tuple(x)

    same = out.idx == ref.idx
    rest = [(a, b) for f in out._fields[2:]
            for a, b in zip(planes(getattr(out, f)), planes(getattr(ref, f)))]
    rec = {"t_equal": bool(torch.equal(out.t, ref.t)),
           "miss_equal": bool(torch.equal(out.idx < 0, ref.idx < 0)),
           "idx_differ": int((~same).sum()),
           "idx_ties": int(((~same) & (out.t == ref.t)).sum()),
           "rest_equal_where_idx_agrees": all(torch.equal(a[same], b[same]) for a, b in rest)}
    rec["bitwise_equal"] = (rec["t_equal"] and rec["idx_differ"] == 0
                            and all(torch.equal(a, b) for a, b in rest))
    return rec


def step_shares(c: dict) -> dict:
    """Lanes a warp step of each branch, and rows a leaf step, from a pass's
    counts (ops/cuda_trace.STEP_COUNTS; null where a library kept none)."""
    def ratio(a, b):
        return c[a] / c[b] if c.get(b) else None
    return {"lanes_per_inner_step": ratio("inner_visits", "inner_steps"),
            "lanes_per_leaf_step": ratio("leaf_visits", "leaf_steps"),
            "rows_per_leaf_step": ratio("leaf_rows", "leaf_steps")}


def mxu_shares(c: dict) -> dict:
    """Lanes served an mma batch, batches a ray and leaf steps a ray, from
    an MXU pass's counts (ops/cuda_trace.MXU_COUNTS and STEP_COUNTS; a leaf
    step is a warp's, divided by the rays traced; null where a library kept
    no step counts)."""
    def ratio(a, b):
        return c[a] / c[b] if c.get(a) and c.get(b) else None
    return {"lanes_per_batch": ratio("lanes_served", "mma_batches"),
            "batches_per_ray": ratio("mma_batches", "traversals"),
            "leaf_steps_per_ray": ratio("leaf_steps", "traversals")}


def pass_tables(L, ptxas, others, card, emit, mode):
    """The STREAM_TABLES passes (mode "stream"), the RESIDENT_TABLES passes
    ("resident") or the MXU_TABLES passes ("mxu"), in turns."""
    import dataclasses

    from chip_smoke import DEEP_CFG, SYNTHETIC_600K
    from parallel_ray_tracer_tpu_torch import pipeline
    from parallel_ray_tracer_tpu_torch.config import RenderConfig
    from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
    from parallel_ray_tracer_tpu_torch.models.procgen import chain_scene
    from parallel_ray_tracer_tpu_torch.ops import render as R
    from parallel_ray_tracer_tpu_torch.ops.intersect import EPSILON
    from parallel_ray_tracer_tpu_torch.ops.pack import pack_bvh8, pad_stream_rows
    from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3

    ct = L.ct
    mxu = mode == "mxu"
    # the twin: this tree's resident instance of a streamed pass, or its
    # FP32 instance of an MXU pass
    twin = {"stream": "resident", "mxu": "fp32"}.get(mode)
    tables = {"stream": STREAM_TABLES, "resident": RESIDENT_TABLES, "mxu": MXU_TABLES}[mode]
    if twin:
        order = others + ["this", twin, twin, "this"] + others[::-1]
    else:
        order = others + ["this", "this"] + others[::-1]

    def prepared(spec):
        """The pipeline of a table's spec; for --passes stream its tri and
        attr padded to whole blocks (ops/pack.pad_stream_rows), as prepare
        pads streamed ones (the synthetic scenes stream under auto, and
        are padded so in both modes); for --passes mxu with the MXU leaf."""
        if isinstance(spec, int):
            p = pipeline.prepare(RenderConfig(**dict(SYNTHETIC_600K, synthetic_triangles=spec)))
            assert mode == "resident" or p.stream, \
                f"{spec} synthetic triangles do not stream under auto"
            return p
        if spec == "chain":
            p = pipeline.prepare(RenderConfig(**dict(DEEP_CFG, mxu_leaf=mxu)), scene=chain_scene())
            pairs = False
        else:
            width, leaf, pairs = spec
            cut = {} if leaf == 8 else dict(leaf_size=leaf, leaf_threshold=8)
            p = pipeline.prepare(RenderConfig(scene="car_boxed", width=1920, height=1080,
                                              bounces=4, bvh_heuristic=6, tile_rows=32,
                                              tile_cols=32, mxu_leaf=mxu, bvh_width=width,
                                              **cut))
        assert p.mxu == mxu, (spec, p.mxu)
        t = p.tables
        if pairs:  # pair rows at width 8: prepare packs width 8 in f32, as JAX's does
            packed = pack_bvh8(p.flat, p.scene.triangle_vertices(), bf16=True)
            t = packed_from_numpy(packed.cbox, packed.cmeta, packed.tri, t.attr.cpu().numpy(),
                                  t.lamb.cpu().numpy(), device=p.device,
                                  leaf_size=t.leaf_size, compressed=True)._replace(cmat=t.cmat)
        if mode != "stream":
            return dataclasses.replace(p, tables=t)

        def pad(a):
            return torch.as_tensor(pad_stream_rows(a.cpu().numpy()), device=a.device)

        return dataclasses.replace(p, tables=t._replace(tri=pad(t.tri), attr=pad(t.attr)),
                                   stream=True)

    def shadow_rays(T, o, d, hit):
        """Reversed shadow rays from light 0 to each hit, as the renderer
        traces them."""
        lp = T.lamb[0, :3]
        ok = hit.idx >= 0
        p = o + d * torch.where(ok, hit.t, 1.0)
        lv = Vec3(lp[0] - p.x, lp[1] - p.y, lp[2] - p.z)
        mag = torch.sqrt(lv.mag2())
        so = Vec3(*(torch.where(ok, c.expand_as(mag), 1e30) for c in lp))
        sd = Vec3(*(torch.where(ok, -c / mag, 0.0) for c in lv))
        m2 = (mag - EPSILON).clamp(min=0.0) ** 2
        return so.contiguous(), sd.contiguous(), m2.contiguous()

    def outputs(out):
        """A pass's or a frame's output planes, for comparisons bit for bit."""
        if isinstance(out, torch.Tensor):
            return [out]
        return [x for x in out if isinstance(x, torch.Tensor)] + [
            c for x in out if isinstance(x, Vec3) for c in x]

    cache = {}
    for table, spec, kernel, rays in tables:
        if spec not in cache:
            cache.clear()
            torch.cuda.empty_cache()
            cache[spec] = prepared(spec)
        p = cache[spec]
        T = p.tables
        o, d = R._tiled_planes(p.camera(), p.cfg.width, p.cfg.height, p.cfg.tile_rows,
                               p.cfg.tile_cols, p.device)
        kw = dict(leaf_size=T.leaf_size, stack_depth=T.stack_depth, compressed=T.compressed)
        if rays == "shadow":
            ray_args = shadow_rays(T, o, d, ct.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, **kw))
        else:
            ray_args = (o, d)

        def run(name, counters=False):
            s = mode == "stream" and name != twin
            lib = "this" if name == twin else name
            cmat = T.cmat if mxu and name != twin else None
            if kernel == "render":  # "auto" on a streamed pipeline is pass-based
                q = dataclasses.replace(p, stream=s, mxu=cmat is not None,
                                        tables=T._replace(cmat=cmat))
                return L.call(lib, lambda: q.render(variant="pallas"))
            fn = {"closest": lambda: ct.closest_tiles(T.cbox, T.cmeta, T.tri, *ray_args,
                                                      stream=s, counters=counters, cmat=cmat,
                                                      **kw),
                  "closest_full": lambda: ct.closest_tiles_full(
                      T.cbox, T.cmeta, T.tri, T.attr, *ray_args, stream=s, counters=counters,
                      cmat=cmat, **kw),
                  "occluded": lambda: ct.occluded_tiles(T.cbox, T.cmeta, T.tri, *ray_args,
                                                        stream=s, counters=counters, cmat=cmat,
                                                        **kw)}
            return L.call(lib, fn[kernel])

        turns, t0 = [], time.perf_counter()
        for i in range(STREAM_ROUNDS):
            turns += [(name, time_ms(lambda: run(name))) for name in order]
            if i + 1 >= MIN_ROUNDS and time.perf_counter() - t0 >= STREAM_ROUND_S:
                break
        ref_out = run("this")
        ref = outputs(ref_out)
        med = {n: statistics.median([t for m, t in turns if m == n]) for n in set(order)}
        rec = {"table": table, "card": card, "rays": o.x.numel(),
               "rounds": len(turns) // len(order), "turns": turns, "libs": {}}
        if twin:
            rec.update({f"{twin}_ms": med[twin], f"this_vs_{twin}": med["this"] / med[twin]})
        a = T.arity
        box = 2 if T.cbox.dtype == torch.bfloat16 else 1 if T.compressed else 0
        deep = int(ct.use_deep_tier(T.stack_depth, a))
        full = kernel in ("closest_full", "render")
        for name in list(L.libs) + ([twin] if twin else []):
            raw = run(name)
            out = outputs(raw)
            lr = {"ms": med[name], "vs_this": med[name] / med["this"],
                  "bitwise_equal": len(out) == len(ref) and all(
                      torch.equal(x, y) for x, y in zip(out, ref))}
            if mode != "stream":
                lr["agreement"] = hit_agreement(raw, ref_out)
            s = mode == "stream" and name != twin
            m = int(mxu and name != twin)
            if kernel == "occluded":
                prefix = (f"_Z15occluded_kernelILi{a}EL5RtBox{box}ELb0ELb{int(s)}ELb{deep}"
                          f"ELb{m}ELi{T.leaf_size}E")
            else:
                prefix = (f"_Z14closest_kernelILi{a}EL5RtBox{box}ELb{int(full)}ELb0ELb{int(s)}"
                          f"ELb{deep}ELb{m}ELi{T.leaf_size}E")
            lr["ptxas"] = ptxas_row(ptxas["this" if name == twin else name], prefix)
            if kernel != "render":
                counts = run(name, counters=True)[1].cpu().tolist()
                lr["counts"] = dict(zip(ct.count_names(s, bool(m)), counts))
                lr.update(step_shares(lr["counts"]))
                if m:
                    lr.update(mxu_shares(lr["counts"]))
                if s:
                    c = lr["counts"]
                    lr["fills_per_leaf"] = c["block_fills"] / max(c["leaf_visits"], 1)
                    lr["syncs_per_leaf"] = c["sync_fetches"] / max(c["leaf_visits"], 1)
            rec["libs"][name] = lr
        emit(rec)
        del T, o, d, ray_args, ref, ref_out
    cache.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="another checkout whose kernels are timed in turns")
    ap.add_argument("--passes", choices=("frame", "stream", "resident", "mxu"), default="frame",
                    help="time the fused frames, the streamed traversal passes, the "
                         "resident ones, or the MXU ones")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_frames: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from parallel_ray_tracer_tpu_torch import _build
    from parallel_ray_tracer_tpu_torch.ops import cuda_trace as ct
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
        libs[name] = _build.bind_entries(ctypes.CDLL(so))
        logs[name] = os.path.join(os.path.dirname(so), "build.log")
    ptxas = {k: read_ptxas(v if os.path.exists(v) else None) for k, v in logs.items()}
    emit({"builds_s": builds})
    others = [k for k in libs if k != "this"]
    L = Libs(ct, libs)
    if args.passes != "frame":
        pass_tables(L, ptxas, others, card, emit, args.passes)
    else:
        frame_passes(L, ptxas, others + ["this", "this"] + others[::-1], card, emit)
    emit({"card": card})
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--out-dir DIR]

Drives parallel_ray_tracer_tpu_torch's main path on the card: car_boxed at
1920x1080 with 4 bounces (the bench configuration). It builds the CUDA
kernels from csrc/, holds each kernel against its plain PyTorch version,
renders the frame and holds it against the reference binary's BMP, compares
the fused frame with the pass-based one, times every kernel with CUDA
events, runs each plain version once on every 7th 32x32 tile of the
frame's rays (against the kernel's output on those rows), and shows
through the launch counters that each path ran exactly its kernels: the
fused render() one frame kernel, the pass-based render one closest-hit and
one any-hit launch per bounce and light, the primary pass one closest-hit
launch.

Its `arity` phase does the same for the other node tables: bvh_width 2
(whose "auto" render is the pass-based path), bvh_width 8, bvh_width 4
with dual_pop=False, and the bf16 node boxes (bf16_bvh) at each width: the
pair rows at width 4, the raw bf16 binary table at width 2, and at width 8
the pair rows of pack_bvh8(bf16=True), carried across with
compressed=True since the pipeline keeps width 8 in f32 as JAX does. The
plain versions read no node table, so the width-4 plain results serve every
table; each table's frame is also held against the reference BMP and the
width-4 frame, and each bf16 table's work counts are set beside those of
the f32 table of its width. The command line
(`python -m parallel_ray_tracer_tpu_torch`) renders the width-8 frame and
the --bf16-bvh frame once each.

Its `dragon` phase runs the procedural dragon (models/procgen.py, 180k
triangles) at bench.py's configuration, with f32 and bf16 tables: prepare,
one primary closest-hit pass over the 1080p frame's rays and one fused
render() per table, each held against its plain version on one 64-row band
through the knot, and the frames held against each other.

Its `stream` phase runs the instances with streamed leaf rows (stream=True,
csrc/trace.cuh). On car_boxed's width-4, width-8 and bf16 pair tables,
padded as prepare pads streamed tables, every streamed instance is held
bit for bit against its resident twin and against the plain results, timed
beside the twin, and reached through a streamed pipeline's pass-based
render() and primary pass. On synthetic_600k (600,000 random triangles,
the smallest scene of scripts/bench_stream.py that JAX streams; its leaf
rows do not fit the L2) "auto" must stream; the 1080p primary pass runs
streamed and resident with equal hits, the streamed one is held against
its plain version on one 32-row band, and the "auto" and explicit fused
render() are timed. The dragon's tables, padded, render with stream="on"
by the pass-based path, with f32 and bf16 tables, and must give the
resident pass-based frame bit for bit.

Its `spheres` phase runs car_boxed_spheres: car_boxed with 8 spheres placed
from its bounding box with a seed (models/procgen.with_spheres; 4 mirrors,
4 diffuse). The sphere frame kernel (frame_kernel's SPH instances) at
widths 4 and 8, on f32 and bf16 pair rows, is held against
frame_plain(..., sph) on one 64-row band; the fused render() (one
`frame_sph<4>`) against the pass-based one (the spheres through
ops/spheres.wrap_tracer); an empty sphere table must give the sphere-free
frame bit for bit; every sphere must be seen and one must shadow a
triangle; the sphere frame is timed beside the sphere-free `frame<4>`.

Its `brute` phase runs the brute-force renderer (ops/trace_brute.py, torch
ops, no kernel): tests/test_spheres.py's sphere scene at 1080p with
use_bvh=False against the pass-based BVH render within atol 3e-5 and the
fused render, car_boxed on one 16-row band against the fused frame, and
`--no-bvh` through the command line on the scene as an asset folder.

Its `deep` phase runs models/procgen.chain_scene, whose 48-level tree needs
more stack than the standard tier holds at every arity: each DEEP instance
(arity 2, 4, 8; f32 and bf16 boxes; resident and streamed; the frame with
and without spheres) against its plain version at the frame's shapes, its
path with the counts from 0, and its time; then the DEEP tier forced on
car_boxed, timed in turns with the standard tier.

The phases above run with mxu_leaf=False (the FP32 leaf test). Its `mxu`
phase drives the main path with the defaults: prepare takes the MXU leaf
on car_boxed at width 4, as JAX's prepare does, and render() launches
frame_mxu<4> (csrc/trace.cuh, the tensor-core leaf of row 12). Every MXU
instance (closest, closest_full, occluded and the frame at widths 4 and 8
on f32 and bf16 pair rows, the sphere frame on car_boxed_spheres, the DEEP
instances on the chain scene) is held against its plain MXU version and
its FP32 twin, to the hit bounds of tests/test_kernel_variants.py's MXU
tests and the frame bounds of tests/test_fused.py, and reached through its
paths with the counts from 0; the fused and pass-based frames are held
against the reference BMP; the four-group table (pack_cmi4) must give the
(rows, 32) table's outputs bit for bit; the MXU kernels are timed in turns
with their FP32 twins, with the lanes served per mma batch and ptxas's
registers and spills.

Its `leaf4` phase runs every traversal kernel at leaf size 4 (each tier
unit compiled with -DRT_UNIT_LEAF=4): prepare(leaf_size=4) on car_boxed with the defaults
(the L = 4 MXU frame kernel, frame_mxu<4,l4>, as JAX's prepare takes it),
with the FP32 leaf, at widths 2, 4 and 8, on bf16 boxes, and with the MXU
leaf on each width-4 and width-8 table; each L = 4 kernel against its plain
version on one band (the plain L = 4 hits, themselves the plain L = 8 hits
through the slot maps; the frames against the band's L = 8 plain frames),
its paths with the counts from 0, its 1080p frame against phase 7's plain
frame on its tile spread, its L = 8 twin's frame and the reference BMP, its
time and work per ray (the two main frames in turns with their L = 8
twins); the streamed instances on the padded L = 4 tables, the sphere
frames on car_boxed_spheres and the DEEP instances on the chain scene.

Its `shadows` phase renders with reverse_shadows=False (shadow rays from the
hit point to the light): the fused frame with the FP32 and the MXU leaf
against its plain version on one band, the pass-based forward render and
the reference BMP, the sphere frame against the pass-based sphere render,
the forward and reversed frame kernels timed in turns; fast_light=False
(the closest-hit kernel finds the shadows on the pass-based path) and
presplit=0.125 against the reference BMP; and the command line with
--leaf-size 4 (with and without --no-mxu-leaf), --no-reverse-shadows,
--no-fast-light and --presplit 0.125, all at once, each BMP the in-process
frame of its configuration.

Its `leaf12` phase runs every FP32 traversal kernel at leaf sizes 2 and 1
(the tier units compiled with -DRT_UNIT_LEAF=2 and 1; the MXU units exist
at L = 8 and 4 only, where JAX takes its MXU leaf): prepare(leaf_size=L)
on car_boxed with the defaults, which takes the FP32 leaf at L = 2 and 1
as JAX's prepare does, at widths 4, 8 and 2 with f32 and bf16 boxes at the
command line's leaf threshold 8 (the L = 8 tree, its leaves cut into
groups), and at width 4 at RenderConfig's own threshold (leaves of at most
2 triangles); each kernel against its plain version on one band, its paths
with the counts from 0, its 1080p frame against phase 7's plain frame on
the tile spread, its L = 8 twin's frame and the reference BMP, its time and
work per ray; the streamed instances on the padded tables, the sphere
frames on car_boxed_spheres, the forward-shadow frames on the width-4
tables, the DEEP instances on the chain scene; make_tracer (the port's
pallas_trace.make_tracer) on the 160 stacked triangles of
tests/test_advice_fixes.py at widths 2 and 4, and on car_boxed's width-4
tables at L = 8 (FP32 and MXU), 4, 2 and 1, where a C-matrix table passed
at L = 2 or 1 must launch the FP32 instances; and frame<4>, frame<8> and
the width-2 pass-based render() at L = 8, 4, 2 and 1 timed in turns.

Its `microbench` phase runs the probes of rows 15a-15h
(parallel_ray_tracer_tpu_torch/microbench/, csrc/microbench_*.cu): each
probe kernel is held against its plain version at K = 3 iterations (the
FP32 modes bit for bit, the tensor-core modes to the MXU bounds of the
`mxu` phase (the overlap kernel's leaf steps, on the script's random C
rows, with a floor of 1e-6 under the largest relative t error of 1e-5),
the staged rows and the gather's chains exactly; the staging
sweep must launch every size up to the card's opt-in limit and be refused
past it), and the bf16 probes of rows 15e-15h (every f32 and bf16x2 chain
instance bit for bit, the slab pairs' loop index e exactly, on the
script's rays and on normal rays), and the inner-visit and branch probes
of rows 15i, 15j and 15l (every instance of microbench_inner.cu,
microbench_glue.cu and microbench_cond.cu on the full grid at K = 3 and
16: e, top and acc bit for bit, the tensor-core leaf's acc within K 1e-6 +
1e-5 |acc|), and the child-parallel and tensor-core visit probes of rows
15k and 15m (every instance of microbench_tiled.cu and
microbench_mxu_inner.cu on the full grid at K = 3 and 16, on the scripts'
tables and on grown boxes where the sums are finite: e, top and acc bit
for bit, the tensor-core bodies' acc within the same bound), then the
entry point (`python -m parallel_ray_tracer_tpu_torch.microbench`) runs
each of its nine commands with the launch counts from 0 (every bf16,
inner, glue, cond, tiled and mxu_inner instance must be launched), and
each probe's readings print as one JSON line; the inner record sets the
cost of one packet-1 inner visit (body A) times the width-4 frame kernel's
inner visits beside the frame's time.

Its `diff` phase runs differentiable rendering (ops/diff.py) and the
training step (parallel/sharded.make_train_step, variant "pallas") on
car_boxed with the MXU leaf (the defaults) and with the FP32 leaf, at
1920x1080 and at scripts/bench_train.py's 512x512 (2 bounces, lr 1e-4):
each step with the launch counts from 0 (exactly its closest-with-attributes
and any-hit launches, of the instances prepare chose), its peak memory,
the step, its forward and its backward timed with CUDA events, the forward
at lr = 0 against the pass-based render, at 1080p a profiler window, the
band gradients through the kernels against their plain versions and the
MXU's against the FP32's, and three SGD steps; at 512x512 a material
gradient against a finite difference. The traversal runs in the kernels;
the backward is torch ops, as JAX's is jnp.

Its `sharded` phase runs the sharded render and training step
(parallel/sharded.py, parallel/distributed.py), the checkpointed banded
render (Pipeline.render_band, utils/checkpoint.py) and the profiler trace
(utils/profiling.py) on car_boxed 1080p with the MXU and the FP32 table:
render_sharded over one card and over four shards on it, "fused" and
"pallas", against render() within 1e-6 with the launch counts from 0; a
one-rank NCCL group's frame bit for bit; the fused frames in turns with
render(); the training step over two shards against one device at 512x512;
the frame in 256-row bands through a checkpoint file, and a stopped run
resumed; a profiler trace that names the frame kernel.

Its `packet` phase runs the packet traversal in torch ops (ops/trace_bvh.py,
variant "jax"; no kernel) on the FP32 main path: a 256-row band, the 1080p
frame timed with its passes' steps (no kernel launched), the frame against
the pass-based render, a one-bounce frame under the profiler, the primary
pass's hits and the first bounce's shadow rays against the kernels',
render_sharded over four shards of cuda:0 at 480x270 against render(), the
512x512 training step against the FP32 pallas step, and the command line
with --variant jax and with --interpret (no traversal kernel in its trace).

Every prepare must take the native host builder (native/, built with g++
on the card's host): a prepare that fell back to the numpy builder fails,
and each record carries its builder and BVH build milliseconds
(synthetic_600k's and the dragon's beside the numpy builder's seconds).

The build phase records the build's seconds, the CPU seconds of its nvcc
processes, each unit's CPU and wall seconds, its units, the host's cores,
the CPUs the process may use and the nvcc processes run at once, and
ptxas's registers and spills of every kernel (by mangled name, so two
runs' tables compare key by key), and of every timed frame instance
(ops/cuda_trace.frame_info) its blocks per SM, registers, local bytes and
shared bytes per block at car_boxed's one light. Every kernel of
tests/goldens/ptxas_kernels.tsv must keep its registers, stack frame and
spills, or the phase fails; the run's own table goes to
DIR/ptxas_kernels.tsv, which renews the file when a change means to alter
a kernel.

Each phase prints one JSON line; all of them, and the rendered frames, also
go to DIR (default: chip_smoke_out/ beside this script). Any failed check
exits non-zero before the last line; the last line is
{"ok": true, "device": {...}}.

It needs a CUDA device and this repository's package beside it, and exits
non-zero without either.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import io
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, and HBM.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per unit of the work the function needs, counted in
# csrc/trace.cuh. The kernels' counting instances count the box tests of
# valid children only and the triangle tests of live slots only (a padding
# slot, n = 0, can never hit), up to an any-hit ray's first blocker. The
# near-first sort, the stack and the shading are not counted.
# A slab test (rt_slab) is 6 mul, 6 sub, 6 min/max per axis pair, 4 min/max
# to combine the axes and 3 compares = 25; a triangle test (rt_mt) is
# 6 (det) + 1 (div) + 3 (ao) + 9 (ao x d) + 6 (u) + 7 (v) + 6 (t)
# + 8 (sign, abs, compares, select) + 1 (t < best) = 47.
OPS_BOX_TEST = 25
OPS_TRI_TEST = 47
# A ray-sphere test (rt_sphere_t, csrc/trace.cuh) is 3 (o - c) + 5 (half_b)
# + 7 (c_sp) + 3 (disc) + 2 (max, sqrt) + 2 (a_safe compare, select) + 3
# (t0: negate, subtract, divide) + 2 (t1) + 2 (t0 > EPS, select) + 3 (the
# hit compares) + 1 (select) + 1 (ts < t, or ts * ts < window: 2) = 34; the
# frame tests every sphere after every traversal, so the tests are
# S x the counted traversals.
OPS_SPHERE_TEST = 34
# Floats of one triangle slot in a tri row (v0, e1, e2, normal) and in an
# attr row (kd, ks, kr): ops/pack's TRI_STRIDE and ATTR_STRIDE.
TRI_FLOATS, ATTR_FLOATS = 12, 9
# An MXU instance's triangle test is the tensor-core product (below) and
# an epilogue on the FP32 pipe (csrc/trace.cuh). rt_mxu_closest_tile:
# 1 (1/det) + 3 (t, u, v) + 1 (abs) + 1 (u + v) + 5 (compares) + 1 (select)
# + 1 (det < 0) + 1 (t < best) = 14. rt_mxu_occluded_tile: 3 (det^2,
# u_num det, v_num det) + 2 (t_num det, EPS det^2) + 1 (u + v) + 2 (t_num^2,
# window det^2) + 6 (compares) = 14.
OPS_MXU_EPILOGUE = 14
WARMUP, TIMED = 10, 50
# The arity phase times its tables (none of them the main path's) with
# fewer repeats, and so do the stream, deep, spheres and mxu phases (the
# streamed, DEEP, sphere and MXU instances, synthetic_600k and the turns
# against the FP32 twins) and the leaf4 phase's tables other than the main
# path's, to make room for the microbench, leaf4, shadows and packet
# phases: 3 warm-ups and 10 timed calls (5 and 20 before the packet phase).
ARITY_WARMUP, ARITY_TIMED = 3, 10
BANDS = (384, 704)          # 64-row bands: sky + geometry, car body
BAND_ROWS = 64
# Phase 7's plain frame, which the 1080p frames of the arity, leaf4 and
# leaf12 phases are held against too: every FRAME_TILE_STRIDE-th 32x32 tile
# of the frame in tile-major order (7 does not divide the 60 tiles of a
# tile row, so the spread moves across the columns: 292 of 2,040 tiles).
FRAME_TILE_STRIDE = 7
# The main path with the defaults (MXU_CFG: prepare takes the MXU leaf, as
# JAX's prepare does for car_boxed) and with mxu_leaf=False (CFG: the FP32
# leaf), which the phases before `mxu` drive.
MXU_CFG = dict(scene="car_boxed", width=1920, height=1080, bounces=4,
               bvh_heuristic=6, tile_rows=32, tile_cols=32)
CFG = dict(MXU_CFG, mxu_leaf=False)
REFERENCE_BMP = os.path.join(HERE, "tests", "goldens", "reference",
                             "car_boxed_1080p.bmp.gz")
# The arity phase: the other node tables, and the single-pop schedule
# (which reaches the width-4 kernels, on the width-4 tables).
ARITY_CASES = {"w2": dict(bvh_width=2), "w8": dict(bvh_width=8),
               "w4_single": dict(dual_pop=False),
               "w4_bf16": dict(bf16_bvh=True),
               "w2_bf16": dict(bvh_width=2, bf16_bvh=True),
               "w8_bf16": dict(bvh_width=8, bf16_bvh=True)}
# Each bf16 case, and the f32 tables of its width.
F32_TWIN = {"w4_bf16": "w4", "w2_bf16": "w2", "w8_bf16": "w8"}
# Bytes one node visit loads in rt_visit (csrc/trace.cuh), by (arity, bf16):
# the box row (16-byte loads: 3 per pair of f32 children, 3 per quad of
# pair-row children, 2 per bf16 binary row) and the cmeta row.
VISIT_BYTES = {(2, False): (48, 16), (4, False): (96, 32), (8, False): (192, 64),
               (2, True): (32, 16), (4, True): (48, 32), (8, True): (96, 64)}
# The dragon phase: bench.py's second metric (primary rays/s), one 64-row
# band through the knot for the plain versions.
DRAGON = dict(CFG, scene="dragon")
DRAGON_BAND = 320
# The stream phase: the tables whose streamed instances it runs, and the
# scene past the L2, with its band for the plain version.
STREAM_CASES = ("w4", "w8", "w4_bf16", "w8_bf16")
# What a streamed instance's two extra counts mean (csrc/trace.cuh), in
# every record of its timings.
STREAM_COUNT_MEANING = {
    "block_fills": "prefetches sent: none, since a streamed instance asks for nothing ahead",
    "sync_fetches": "leaf visits whose row no prefetch asked for: every leaf visit"}
SYNTHETIC_600K = dict(synthetic_triangles=600000, width=1920, height=1080,
                      bvh_heuristic=6, tile_rows=32, tile_cols=32)
SYNTHETIC_BAND, SYNTHETIC_BAND_ROWS = 512, 32
# The spheres phase: car_boxed with 8 spheres (models/procgen.with_spheres),
# its band for the plain sphere frame. The brute phase: the sphere scene of
# tests/test_spheres.py (a floor, a red and a mirror sphere, one light), and
# a 16-row band of car_boxed. The deep phase: models/procgen.chain_scene,
# whose 48-level tree passes the standard stack tier at every arity.
SPHERE_BAND = 384
SPHERE_SCENE = dict(
    verts=[[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]], faces=[[0, 1, 2], [0, 2, 3]],
    mat_idx=[0, 0], mats_kd=[[0.7, 0.7, 0.7], [0.7, 0.2, 0.2], [0.1, 0.1, 0.1]],
    mats_ks=[[0.0, 0.0, 0.0], [0.4, 0.4, 0.4], [0.2, 0.2, 0.2]],
    mats_kr=[[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.8, 0.8, 0.8]],
    lights_pos=[[0.0, -5.0, 7.0]], lights_kl=[[40.0, 40.0, 40.0]],
    spheres_center=[[-1.2, 0.5, 1.0], [1.4, 1.0, 1.2]], spheres_radius=[1.0, 1.2],
    spheres_mat=[1, 2])
BRUTE_BAND, BRUTE_BAND_ROWS = 512, 16
DEEP_CFG = dict(width=1920, height=1080, bounces=1, bvh_heuristic=1, bvh_max_depth=64,
                tile_rows=32, tile_cols=32, mxu_leaf=False)
DEEP_CASES = {"w2": dict(bvh_width=2), "w4": {}, "w8": dict(bvh_width=8),
              "w2_bf16": dict(bvh_width=2, bf16_bvh=True), "w4_bf16": dict(bf16_bvh=True),
              "w8_bf16": dict(bvh_width=8, bf16_bvh=True)}
# Two spheres in front of the camera for the DEEP tier's sphere frames.
DEEP_SPHERES = [[-1.5, 2.0, 0.3, 0.7, 0.7, 0.2, 0.2, 0.3, 0.3, 0.3, 0.0, 0.0, 0.0],
                [1.6, 3.0, 0.8, 0.9, 0.05, 0.05, 0.05, 0.3, 0.3, 0.3, 0.8, 0.8, 0.8]]
# The mxu phase: the tables whose MXU instances it holds and times (w8_bf16:
# pack_bvh8(bf16=True) pair rows, as in the arity phase), the kernels timed
# in turns with their FP32 twins, the tensor-core work one ray's leaf visit
# needs (its feature row against the group's 32 C rows, K = 10: R's six
# zero columns are padding; three bf16 products: 3 * 2 * 32 * 10
# operations) and the work a warp issues per served group (24 m16n8k16
# products of 2 * 16 * 8 * 16 operations, whatever the lanes served and
# the padding), and the lines of the TPU kernels the MXU
# instances replace (pallas_trace.py: _mxu_leaf_closest_n,
# _mxu_leaf_occluded_n, the fused frame with mxu=True).
MXU_CASES = {"w4": {}, "w8": dict(bvh_width=8), "w4_bf16": dict(bf16_bvh=True),
             "w8_bf16": dict(bvh_width=8, bf16_bvh=True)}
MXU_TURNS = ("frame", "closest", "closest_full", "occluded")
# The leaf4 phase: car_boxed's tables at leaf size 4, as (MXU leaf, config):
# the main path with the defaults (the MXU leaf, as JAX's prepare takes it
# at L = 4), the FP32 leaf at widths 4, 8 and 2 and on bf16 boxes, and the
# MXU leaf on each other width-4 and width-8 table. Each takes the command
# line's leaf threshold, 8 (RenderConfig's is 2, which builds leaves of up
# to L = 4 triangles): the tree is the L = 8 tree with each leaf cut into
# groups of 4, and the frames are those of `--leaf-size 4`.
L4_LEAF_THRESHOLD = 8
L4_CASES = {"w4_mxu": (True, {}), "w4": (False, {}), "w8": (False, dict(bvh_width=8)),
            "w2": (False, dict(bvh_width=2)), "w4_bf16": (False, dict(bf16_bvh=True)),
            "w8_bf16": (False, dict(bvh_width=8, bf16_bvh=True)),
            "w2_bf16": (False, dict(bvh_width=2, bf16_bvh=True)),
            "w8_mxu": (True, dict(bvh_width=8)), "w4_bf16_mxu": (True, dict(bf16_bvh=True)),
            "w8_bf16_mxu": (True, dict(bvh_width=8, bf16_bvh=True))}

# The leaf12 phase: car_boxed's tables at leaf sizes 2 and 1 with the
# defaults (prepare takes the FP32 leaf there, as JAX's does), at the
# command line's leaf threshold (L4_LEAF_THRESHOLD: the L = 8 tree, its
# leaves cut into groups of L) at each width and box format, and at width 4
# at RenderConfig's own threshold (2: another tree, leaves of at most 2
# triangles, held against the plain hits through the slot maps); the
# tables of its streamed instances, sphere frames and forward-shadow frames;
# the stacked triangles of tests/test_advice_fixes.py (make_tracer).
L12_SIZES = (2, 1)
L12_CASES = {"w4": {}, "w8": dict(bvh_width=8), "w2": dict(bvh_width=2),
             "w4_bf16": dict(bf16_bvh=True), "w8_bf16": dict(bvh_width=8, bf16_bvh=True),
             "w2_bf16": dict(bvh_width=2, bf16_bvh=True), "w4_own_threshold": {}}
L12_STREAM = ("w4", "w8", "w4_bf16", "w8_bf16")
L12_FORWARD = ("w4", "w4_bf16")
STACKED_TRIANGLES = 160


def stacked_triangles(n: int = STACKED_TRIANGLES) -> np.ndarray:
    """tests/test_advice_fixes.py's deep, skinny scene: n unit right
    triangles stacked along z, (n, 3, 3) vertices."""
    z = np.arange(n, dtype=np.float32)[:, None]
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    return base[None, :, :] + np.concatenate([np.zeros((n, 1, 2), np.float32),
                                              z[:, :, None]], axis=2)


def mma_ops_per_lane(leaf: int) -> int:
    """Products one served lane needs: bf16x3 (3 products) of its ray's 10
    live features with the group's 4L C-matrix rows, 2 operations each."""
    return 3 * 2 * 4 * leaf * 10


def mma_ops_per_batch(leaf: int) -> int:
    """Products one warp batch issues: 3 x (L / 2) n-tiles x 2 m-tiles
    m16n8k16 mma (24 at L = 8, 12 at L = 4), 2 x 16 x 8 x 16 each."""
    return 3 * (leaf // 2) * 2 * 2 * 16 * 8 * 16


PEAK_BF16_OPS = 989e12
# Packed bf16 outside the tensor cores: twice the FP32 rate on paper (H100
# SXM), in element operations.
PEAK_BF16X2_OPS = 134e12
MXU_LINES = {"closest": 1443, "closest_full": 1443, "occluded": 1457, "frame": 2536,
             "frame_sph": 2536}
# The kernels line: (instance, the tables it runs on, kernel, line of the
# TPU kernel it replaces in parallel_ray_tracer_tpu/ops/pallas_trace.py).
KERNEL_ROWS = (
    ("frame_kernel<4>", "w4", "frame", 2536),
    ("closest_kernel<4, false>", "w4", "closest", 1774),
    ("closest_kernel<4, true>", "w4", "closest_full", 1774),
    ("occluded_kernel<4>", "w4", "occluded", 1835),
    ("frame_kernel<8>", "w8", "frame", 2536),
    ("closest_kernel<8, false>", "w8", "closest", 1774),
    ("closest_kernel<8, true>", "w8", "closest_full", 1774),
    ("occluded_kernel<8>", "w8", "occluded", 1835),
    ("closest_kernel<4, false>, single pop", "w4_single", "closest", 825),
    ("occluded_kernel<4>, single pop", "w4_single", "occluded", 886),
    ("closest_kernel<4, true>, single pop", "w4_single", "closest_full", 2437),
    ("closest_kernel<2, true>", "w2", "closest_full", 2437),
    ("closest_kernel<2, false>", "w2", "closest", 610),
    ("occluded_kernel<2>", "w2", "occluded", 676),
    ("frame_kernel<4, PAIRS>", "w4_bf16", "frame", 2536),
    ("closest_kernel<4, PAIRS, false>", "w4_bf16", "closest", 1774),
    ("closest_kernel<4, PAIRS, true>", "w4_bf16", "closest_full", 1774),
    ("occluded_kernel<4, PAIRS>", "w4_bf16", "occluded", 1835),
    ("frame_kernel<8, PAIRS>", "w8_bf16", "frame", 2536),
    ("closest_kernel<8, PAIRS, false>", "w8_bf16", "closest", 1774),
    ("closest_kernel<8, PAIRS, true>", "w8_bf16", "closest_full", 1774),
    ("occluded_kernel<8, PAIRS>", "w8_bf16", "occluded", 1835),
    ("closest_kernel<2, BF16, false>", "w2_bf16", "closest", 610),
    ("closest_kernel<2, BF16, true>", "w2_bf16", "closest_full", 2437),
    ("occluded_kernel<2, BF16>", "w2_bf16", "occluded", 676),
    ("closest_kernel<4, false, STREAM>", "w4", "closest_stream", 2070),
    ("closest_kernel<4, true, STREAM>", "w4", "closest_full_stream", 2070),
    ("occluded_kernel<4, STREAM>", "w4", "occluded_stream", 2253),
    ("closest_kernel<8, false, STREAM>", "w8", "closest_stream", 2070),
    ("closest_kernel<8, true, STREAM>", "w8", "closest_full_stream", 2070),
    ("occluded_kernel<8, STREAM>", "w8", "occluded_stream", 2253),
    ("closest_kernel<4, PAIRS, false, STREAM>", "w4_bf16", "closest_stream", 2070),
    ("closest_kernel<4, PAIRS, true, STREAM>", "w4_bf16", "closest_full_stream", 2070),
    ("occluded_kernel<4, PAIRS, STREAM>", "w4_bf16", "occluded_stream", 2253),
    ("closest_kernel<8, PAIRS, false, STREAM>", "w8_bf16", "closest_stream", 2070),
    ("closest_kernel<8, PAIRS, true, STREAM>", "w8_bf16", "closest_full_stream", 2070),
    ("occluded_kernel<8, PAIRS, STREAM>", "w8_bf16", "occluded_stream", 2253),
)

# The microbench phase: iterations of the kernel-vs-plain checks; for the
# kernels line, the gather's table and steps (64 MiB, past the L2) and the
# overlap kernel's iterations (its plain version loops in Python); each
# probe's kernel, source and the TPU kernel it replaces.
MB_ITERS = 3
MB_GATHER_MB, MB_GATHER_STEPS = 64, 32
MB_OVERLAP_ITERS = 64
MB_KERNELS = {
    "leaf": ("mb_leaf_kernel<BF16X3, FULL>", "microbench_leaf.cu",
             "scripts/microbench_mxu_leaf.py:162"),
    "stage": ("mb_stage_kernel", "microbench_probes.cu", "scripts/microbench_mxu_leaf.py:523"),
    "gather": ("mb_gather_kernel", "microbench_probes.cu", "scripts/microbench_mxu_leaf.py:554"),
    "overlap": ("mb_overlap_kernel<both_closest>", "microbench_overlap.cu",
                "scripts/microbench_overlap.py:168"),
}
MB_COMMANDS = {"mxu_leaf": ("leaf",), "probes": ("stage", "gather"), "overlap": ("overlap",),
               "bf16": ("chain", "slab"), "inner": ("inner",), "glue": ("glue",),
               "cond": ("cond",), "tiled": ("tiled",), "mxu_inner": ("mxu_inner",)}
# The bf16 probes (rows 15e-15h): the iterations at which the kernels line
# times each instance and its plain version (the plain chains loop in
# Python), and the iterations of the slab's e check on the overlap
# script's normal rays, where e branches (the script's rays lie on one line).
MB_BF16_ROW_ITERS = 64
MB_SLAB_CHECK_ITERS = (MB_ITERS, 64)
# The inner-visit probes (rows 15i, 15j) and the branch probe (15l): the
# iterations of the kernel-vs-plain checks and of the kernels-line rows
# (kernel and plain version alike) and the glue rows' npop. The tensor-core
# leaf's acc (its products sum in the tensor cores' order) is held to the
# overlap kernel's bound on one leaf step's t, |dt| <= 1e-6 + 1e-5 |t|,
# summed over the K steps whose packet minima acc adds up:
# |d acc| <= K 1e-6 + 1e-5 |acc| (every t > EPS > 0).
MB_INNER_CHECK_ITERS = (MB_ITERS, 16)
MB_INNER_ROW_ITERS = 64
MB_GLUE_ROW_NPOP = 4

# The diff phase: the training step of scripts/bench_train.py (car_boxed, 2
# bounces, lr 1e-4, target zeros) at the resolution users render and at the
# script's own; the 64-row band of its kernel-against-plain gradients; the
# finite-difference step of tests/test_diff.py's material check; the timing
# repeats (median of 5 after 2 warm-ups; 10 after 3 before the packet
# phase); the SGD steps at 1080p.
DIFF_SIZES = ((1920, 1080), (512, 512))
DIFF_BOUNCES, DIFF_LR = 2, 1e-4
DIFF_BAND = 384
DIFF_FD_H = 1e-3
DIFF_WARMUP, DIFF_TIMED = 2, 5
DIFF_SGD_STEPS = 3
# The training forward against the pass-based render of the same camera,
# tiles and flags, at lr = 0 (the loss is a mean square over the frame's
# colours): on the FP32 table below 1e-10, since the recompute's t is the
# kernel's; on the MXU table below 1e-4, since the render shades at the
# kernel's t, which carries the bf16x3 error, and the forward at the
# recomputed t (as in JAX), so a bounce past a silhouette can flip: 1.6e-5
# at 1080p and 2.3e-5 at 512x512 on the H100, with 99.956% and 99.944% of
# pixels within 1e-3 (PERF.md section 6). On either table at least
# DIFF_FORWARD_SHARE of the pixels lie within 1e-3 of the render.
DIFF_FORWARD_LOSS = {"fp32": 1e-10, "mxu": 1e-4}
DIFF_FORWARD_SHARE = 0.999

# The numpy builder's seconds on the card's host before the native builder
# (PERF.md section 4-5): synthetic_600k's prepare and BVH build, the
# dragon's BVH build; printed beside this run's.
NUMPY_PREPARE_S = {"synthetic_600k": 51.1}
NUMPY_BUILD_S = {"synthetic_600k": 50.9, "dragon": 13.08}

RECORDS = []
FAILURES = []
T_START = time.perf_counter()


def emit(rec: dict) -> None:
    """Print and keep one phase record, with the script's time so far
    (elapsed_s) and the seconds since the previous record (phase_s)."""
    rec["elapsed_s"] = time.perf_counter() - T_START
    rec["phase_s"] = rec["elapsed_s"] - (RECORDS[-1]["elapsed_s"] if RECORDS else 0.0)
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def check(phase: str, ok: bool, what: str) -> None:
    if not ok:
        FAILURES.append(f"{phase}: {what}")
        print(f"CHECK FAILED {phase}: {what}", file=sys.stderr, flush=True)


def time_ms(fn, warmup=WARMUP, timed=TIMED):
    """Per-call device times (ms) from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(timed):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in pairs]
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "runs": len(ms)}


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def leaf_bytes(T, tri=True, attr=False) -> int:
    """The bytes of tables T's f32 leaf rows that a kernel can read: of each
    128-lane row, the TRI_FLOATS of tri (with `tri`) and the ATTR_FLOATS
    of attr (with `attr`) of each of its T.leaf_size slots, not the padding
    lanes past them (at L = 1 a tri row holds 12 used floats of 128)."""
    L = T.leaf_size
    return 4 * ((T.tri.shape[0] * min(TRI_FLOATS * L, T.tri.shape[1]) if tri else 0)
                + (T.attr.shape[0] * min(ATTR_FLOATS * L, T.attr.shape[1]) if attr else 0))


def bound(counts, names, in_bytes, out_bytes, spheres=0, leaf=8):
    """Least time for the work the function needs on these inputs: the
    counted box tests and triangle tests, and with `spheres` rows the
    sphere tests of the frame (spheres x traversals), over the FP32 rate;
    or each input read once and each output written once over the memory
    rate, the larger (a leaf table's bytes are the lanes its slots use:
    leaf_bytes). An MXU instance (counts with mma_batches) does a
    triangle test as a product on the tensor cores and an epilogue on the
    FP32 pipe: its FP32 work charges each counted triangle test
    OPS_MXU_EPILOGUE, and its tensor-core work is the products its served
    leaf visits need (lanes served x mma_ops_per_lane(leaf), leaf the
    tables' leaf size; the products a warp issues for idle lanes and padding
    are not needed, and are recorded as mma_ops_issued) over the bf16 rate. The two pipes run side by side, so
    its operations take the larger of the two times. counts are the
    kernel's work counters, named by names."""
    c = dict(zip(names, (int(v) for v in counts)))
    if spheres:
        c["sphere_tests"] = spheres * c["traversals"]
    mxu = "mma_batches" in c
    ops = (c["box_tests"] * OPS_BOX_TEST
           + c["tri_tests"] * (OPS_MXU_EPILOGUE if mxu else OPS_TRI_TEST)
           + c.get("sphere_tests", 0) * OPS_SPHERE_TEST)
    t_ops = ops / PEAK_FP32_OPS * 1e3
    if mxu:
        c["mma_ops"] = c["lanes_served"] * mma_ops_per_lane(leaf)
        c["mma_ops_issued"] = c["mma_batches"] * mma_ops_per_batch(leaf)
        c["lanes_per_batch"] = c["lanes_served"] / max(c["mma_batches"], 1)
        c["batches_per_ray"] = c["mma_batches"] / max(c["traversals"], 1)
        if c.get("leaf_steps"):  # an MXU pass's warp leaf steps over its rays
            c["leaf_steps_per_ray"] = c["leaf_steps"] / max(c["traversals"], 1)
        c["fp32_pipe_ms"] = t_ops
        c["tensor_pipe_ms"] = c["mma_ops"] / PEAK_BF16_OPS * 1e3
        t_ops = max(t_ops, c["tensor_pipe_ms"])
    if c.get("inner_steps"):  # a pass's warp steps (ops/cuda_trace.STEP_COUNTS)
        c["lanes_per_inner_step"] = c["inner_visits"] / c["inner_steps"]
        c["lanes_per_leaf_step"] = c["leaf_visits"] / max(c["leaf_steps"], 1)
        c["rows_per_leaf_step"] = c["leaf_rows"] / max(c["leaf_steps"], 1)
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": in_bytes + out_bytes, **c}


def count_names(kernel: str, mxu: bool) -> tuple:
    """The names of a kernel's counts (ops/cuda_trace.count_names): a pass
    (closest, closest_full, occluded) keeps its warp steps, a frame none."""
    from parallel_ray_tracer_tpu_torch.ops.cuda_trace import count_names as names
    return names(mxu=mxu, steps=not kernel.startswith("frame"))


# What the mxu phase records of each MXU pass instance (bound()).
MXU_STEP_SHARES = ("lanes_per_batch", "batches_per_ray", "leaf_steps_per_ray",
                   "lanes_per_leaf_step", "rows_per_leaf_step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=os.path.join(HERE, "chip_smoke_out"),
                    help="where the JSON records and the frames' BMPs go")
    args = ap.parse_args()
    out_dir = args.out_dir
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from parallel_ray_tracer_tpu_torch import _build, pipeline
        from parallel_ray_tracer_tpu_torch.config import RenderConfig
        from parallel_ray_tracer_tpu_torch.convert import packed_from_numpy
        from parallel_ray_tracer_tpu_torch.models.camera import ray_basis
        from parallel_ray_tracer_tpu_torch.models.procgen import chain_scene, with_spheres
        from parallel_ray_tracer_tpu_torch.models.scene import Scene, load_scene_npz
        from parallel_ray_tracer_tpu_torch.native import builder as native
        from parallel_ray_tracer_tpu_torch.ops.bvh import build_bvh
        from parallel_ray_tracer_tpu_torch.ops.bvh_flat import flatten_bvh
        from parallel_ray_tracer_tpu_torch.ops.pack import (pack_bvh, pack_bvh4, pack_bvh8,
                                                            pack_cmi4, pad_stream_rows,
                                                            split_cmat, stack_need)
        from parallel_ray_tracer_tpu_torch.ops import cuda_trace as ct
        from parallel_ray_tracer_tpu_torch.ops import render as R
        from parallel_ray_tracer_tpu_torch.ops import trace_brute
        from parallel_ray_tracer_tpu_torch.ops import trace_plain as tp
        from parallel_ray_tracer_tpu_torch.ops.spheres import wrap_tracer
        from parallel_ray_tracer_tpu_torch.ops.intersect import EPSILON, T_MAX
        from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3
        from parallel_ray_tracer_tpu_torch.utils.bmp import bmp_bytes, read_bmp
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    os.makedirs(out_dir, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    builds = []

    def prepare_native(cfg, **kw):
        """pipeline.prepare, held to the native builder: g++ is on the card's
        host, so a prepare that fell back to the numpy builder fails (the
        set-up time it saves must not vanish unseen). Each BVH build is
        recorded with its builder and milliseconds."""
        p = pipeline.prepare(cfg, **kw)
        if cfg.use_bvh:
            what = cfg.scene if not cfg.synthetic_triangles else f"synthetic_{cfg.synthetic_triangles}"
            builds.append({"scene": what if kw.get("scene") is None else "given",
                           "triangles": p.scene.num_triangles, "bvh_width": cfg.bvh_width,
                           "builder": p.builder, "build_ms": p.build_ms})
            check("prepare", p.builder == "native",
                  f"{what}: the {p.builder} builder ran ({native.BUILD_INFO})")
        return p

    # ---- 1. build -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = os.path.join(os.path.dirname(_build.library_path()), "build.log")
    ptxas_table = read_ptxas(log if os.path.exists(log) else None)
    spills = [k for k, v in ptxas_table.items() if v.get("spill_stores") or v.get("spill_loads")]
    # every kernel of the committed table keeps its registers, stack frame
    # and spills; the run's own table goes beside the records
    kept = load_ptxas(PTXAS_BASELINE)
    changed = sorted(k for k, v in kept.items() if ptxas_table.get(k) != v)
    write_ptxas(ptxas_table, os.path.join(out_dir, os.path.basename(PTXAS_BASELINE)))
    check("build", bool(kept), f"no kernels in {os.path.relpath(PTXAS_BASELINE, HERE)}")
    check("build", not changed,
          f"{len(changed)} of the {len(kept)} kernels of "
          f"{os.path.relpath(PTXAS_BASELINE, HERE)} changed their ptxas registers, stack "
          f"or spills, or are gone: {changed[:3]}")
    # every timed frame instance's occupancy and resources at car_boxed's
    # one light (spheres: 8 rows), by key
    frame_res = {}
    for mxu, leaves in ((False, ct.LEAF_SIZES), (True, ct.MXU_LEAF_SIZES)):
        for a in ct.ARITIES["frame"]:
            for bf, deep, leaf, fwd, sph in itertools.product(
                    (False, True), (False, True), leaves, (False, True), (0, 8)):
                key = ct._instance("frame_sph" if sph else "frame", a,
                                   ct.BOX_PAIRS if bf else ct.BOX_F32, deep=deep, mxu=mxu,
                                   leaf_size=leaf) + (",fwd" if fwd else "")
                frame_res[key] = ct.frame_info(a, leaf_size=leaf, bf16=bf, deep=deep, mxu=mxu,
                                               reverse_shadows=not fwd, spheres=sph)
    build = {k: _build.BUILD_INFO.get(k)
             for k in ("units", "cores", "cpus", "jobs", "cpu_seconds", "unit_cpu_seconds",
                       "unit_wall_seconds", "cached")}
    emit({"phase": "build", "seconds": build_s, "card": card, **build,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas_table, "spilling_kernels": len(spills),
          "ptxas_kept": {"kernels": len(kept), "unchanged": len(kept) - len(changed),
                         "changed": {k: [kept[k], ptxas_table.get(k)] for k in changed[:20]},
                         "not_in_table": len(set(ptxas_table) - set(kept))},
          "instances_by_leaf": {leaf: sum(entry_leaf(k) == leaf for k in ptxas_table)
                                for leaf in (1, 2, 4, 8)},
          "frame_instances": frame_res})

    # ---- 2. prepare -----------------------------------------------------
    t0 = time.perf_counter()
    cfg = RenderConfig(**CFG)
    pipe = prepare_native(cfg)
    torch.cuda.synchronize()
    T = pipe.tables
    L = T.leaf_size
    emit({"phase": "prepare", "seconds": time.perf_counter() - t0,
          "builder": pipe.builder, "native_build": dict(native.BUILD_INFO),
          "bvh_build_ms": pipe.build_ms, "triangles": pipe.scene.num_triangles,
          "cbox": list(T.cbox.shape), "tri": list(T.tri.shape),
          "tree_depth": pipe.flat.depth, "stack_need": T.stack_depth,
          "stack_size": ct.STACK_SIZE[T.arity]})
    W, H, TR, TC = cfg.width, cfg.height, cfg.tile_rows, cfg.tile_cols
    o, d = R._tiled_planes(pipe.camera(), W, H, TR, TC, pipe.device)
    tiles_x = -(-W // TC)
    rows_per_tile_row = tiles_x * TR * TC // 128

    def band(planes, y0, rows=BAND_ROWS):
        r0 = (y0 // TR) * rows_per_tile_row
        r1 = r0 + (rows // TR) * rows_per_tile_row
        return Vec3(*(p[r0:r1] for p in planes))

    tile_rows_of = torch.arange(o.x.shape[0], device=pipe.device).reshape(-1, TR * TC // 128)
    spread_rows = tile_rows_of[::FRAME_TILE_STRIDE].reshape(-1)

    def spread(planes):
        """The rows of every FRAME_TILE_STRIDE-th tile of the frame's planes."""
        return Vec3(*(p[spread_rows] for p in planes))

    def spread_out(out):
        """spread() of a kernel's output: a plane, a Vec3, or a hit of them."""
        if isinstance(out, torch.Tensor):
            return out[spread_rows]
        if isinstance(out, Vec3):
            return spread(out)
        return type(out)(*(spread_out(x) for x in out))

    def shadow_rays(o, d, hit, lamb=None):
        """Reversed shadow rays to light 0 (of lamb, by default the main
        path's), as the renderer traces them."""
        lp = (T.lamb if lamb is None else lamb)[0, :3]
        ok = hit.idx >= 0
        ts = torch.where(ok, hit.t, 1.0)
        p = o + d * ts
        lv = Vec3(lp[0] - p.x, lp[1] - p.y, lp[2] - p.z)
        mag = torch.sqrt(lv.mag2())
        far = torch.full_like(mag, 1e30)
        so = Vec3(*(torch.where(ok, c.expand_as(mag), far) for c in lp))
        sd = Vec3(*(torch.where(ok, -c / mag, 0.0) for c in lv))
        m2 = (mag - EPSILON).clamp(min=0.0) ** 2
        return so.contiguous(), sd.contiguous(), m2.contiguous()

    kw = dict(leaf_size=L, stack_depth=T.stack_depth)

    # ---- 3. kernels vs plain versions, on two bands ---------------------
    def cmp_hits(name, hk, hp, full):
        t_k, t_p = hk.t, hp.t
        mk, mp = t_k >= T_MAX, t_p >= T_MAX
        check(name, torch.equal(mk, mp), "miss masks differ")
        both = ~mk & ~mp
        err = (t_k[both] - t_p[both]).abs()
        tol = 1e-4 + 1e-5 * t_p[both].abs()
        check(name, bool((err <= tol).all()), "t beyond atol 1e-4, rtol 1e-5")
        same = hk.idx == hp.idx
        agree = same.float().mean().item()
        check(name, agree >= 0.999, f"idx agreement {agree}")
        check(name, torch.equal(t_k[same], t_p[same]), "t differs where idx agrees")
        check(name, torch.equal(hk.norm_dir[same], hp.norm_dir[same]),
              "norm_dir differs where idx agrees")
        max_err = err.max().item() if err.numel() else 0.0
        if full:
            for vk, vp in zip((*hk.n, *hk.kd, *hk.ks, *hk.kr),
                              (*hp.n, *hp.kd, *hp.ks, *hp.kr)):
                check(name, torch.equal(vk[same], vp[same]),
                      "attributes differ where idx agrees")
                max_err = max(max_err, (vk[same] - vp[same]).abs().max().item())
        return {"max_abs_err": max_err, "idx_agree": agree,
                "hit_frac": both.float().mean().item()}

    def cmp_frame(name, fk, fp, min_within=0.9999):
        """Colours, unclamped: at least 99.99% of pixels within 1e-3 (the
        sound runs had all of them within 2e-4), median < 1e-5. Frames with
        spheres are held to the frame bounds of tests/test_fused.py (more
        than 99%): a ray reflected by a curved mirror may flip a
        silhouette where the kernel's and the plain version's shading
        round apart."""
        diff = (fk.stack(-1) - fp.stack(-1)).abs()
        within = (diff.amax(-1) < 1e-3).float().mean().item()
        med = diff.median().item()
        check(name, within >= min_within, f"{within} of pixels within 1e-3")
        check(name, med < 1e-5, f"median {med}")
        return {"max_abs_err": diff.max().item(), "within_1e-3": within,
                "median": med}

    def cmp_blocked(name, bk, bp, min_agree=0.999):
        agree = (bk == bp).float().mean().item()
        check(name, agree >= min_agree, f"blocked agreement {agree}")
        return {"max_abs_err": float((bk != bp).any()), "agree": agree,
                "blocked_frac": bp.float().mean().item()}

    def timed_once(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    cmp = {k: {"max_abs_err": 0.0, "band_plain_ms": None, "band_ms": None}
           for k in ("closest", "closest_full", "occluded", "frame")}

    def note(key, res, plain_ms, band_ms):
        # band_plain_ms / band_ms: the first band's primary rays (or its
        # shadow rays for the any-hit kernel), plain and kernel on one input
        c = cmp[key]
        c["max_abs_err"] = max(c["max_abs_err"], res.pop("max_abs_err"))
        if c["band_ms"] is None:
            c["band_plain_ms"], c["band_ms"] = plain_ms, band_ms
        c.setdefault("bands", []).append(res)

    # The bands' inputs and plain results, kept for the arity phase.
    band_ref = {}
    for y0 in BANDS:
        bo, bd = band(o, y0), band(d, y0)
        rays = {"primary": (bo, bd)}
        hp, _ = timed_once(lambda: tp.closest_full_plain(T.tri, T.attr, bo, bd, L))
        rays["shadow"] = shadow_rays(bo, bd, hp)[:2]
        ref = band_ref[y0] = {"rays": rays}
        for kind, (ro, rd) in rays.items():
            hk = ct.closest_tiles(T.cbox, T.cmeta, T.tri, ro, rd, **kw)
            hpp, pms = timed_once(lambda: tp.closest_plain(T.tri, ro, rd, L))
            ref["closest", kind] = hpp
            res = cmp_hits(f"closest/{kind}@{y0}", hk, hpp, False)
            bms = time_ms(lambda: ct.closest_tiles(T.cbox, T.cmeta, T.tri, ro, rd, **kw), 2, 5)
            note("closest", dict(res, rays=kind, y0=y0), pms, bms["median"])

            hk = ct.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, ro, rd, **kw)
            hpp, pms = timed_once(
                lambda: tp.closest_full_plain(T.tri, T.attr, ro, rd, L))
            ref["closest_full", kind] = hpp
            res = cmp_hits(f"closest_full/{kind}@{y0}", hk, hpp, True)
            bms = time_ms(lambda: ct.closest_tiles_full(
                T.cbox, T.cmeta, T.tri, T.attr, ro, rd, **kw), 2, 5)
            note("closest_full", dict(res, rays=kind, y0=y0), pms, bms["median"])

        so, sd, m2 = ref["shadow_rays"] = shadow_rays(bo, bd, hp)
        bk = ct.occluded_tiles(T.cbox, T.cmeta, T.tri, so, sd, m2, **kw)
        bp, pms = timed_once(lambda: tp.occluded_plain(T.tri, so, sd, m2, L))
        ref["occluded"] = bp
        res = cmp_blocked(f"occluded@{y0}", bk, bp)
        bms = time_ms(lambda: ct.occluded_tiles(T.cbox, T.cmeta, T.tri, so, sd, m2, **kw), 2, 5)
        note("occluded", dict(res, y0=y0), pms, bms["median"])

        fk = ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, bo, bd,
                            bounces=cfg.bounces, **kw)
        fp, pms = timed_once(lambda: ct.frame_plain(
            T.tri, T.attr, T.lamb, bo, bd, bounces=cfg.bounces, leaf_size=L))
        ref["frame"] = fp
        res = cmp_frame(f"frame@{y0}", fk, fp)
        bms = time_ms(lambda: ct.frame_tiles(
            T.cbox, T.cmeta, T.tri, T.attr, T.lamb, bo, bd, bounces=cfg.bounces,
            **kw), 2, 5)
        note("frame", dict(res, y0=y0), pms, bms["median"])
    emit({"phase": "kernel_vs_plain", "band_rays": BAND_ROWS * W,
          "kernels": cmp})

    # ---- 4+5. the main paths: each with its counts from 0 ----------------
    def on_path(name, fn, expect):
        """Run one path with the launch counts from 0; they must be expect."""
        ct.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(ct.LAUNCHES)
        want = {k: expect.get(k, 0) for k in counts}
        check(name, counts == want, f"launches {counts}, expected {want}")
        emit({"phase": "launches", "path": name, "seconds": seconds,
              "launches": {k: n for k, n in counts.items() if n}})
        return out, counts

    nl = T.lamb.shape[0] - 1
    img, on_fused = on_path("render_fused", pipe.render,  # "auto" -> fused
                            {"frame<4>": 1})
    img_pass, on_pass = on_path(
        "render_pass_based", lambda: pipe.render(variant="pallas"),
        {"closest_full<4>": cfg.bounces, "occluded<4>": cfg.bounces * nl})
    prim, on_prim = on_path(
        "primary_closest_pass",
        lambda: ct.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, **kw),
        {"closest<4>": 1})
    launches = {"w4": {"frame": on_fused["frame<4>"],
                       "closest_full": on_pass["closest_full<4>"],
                       "occluded": on_pass["occluded<4>"],
                       "closest": on_prim["closest<4>"]}}
    for k, n in launches["w4"].items():
        check("main_path", n > 0, f"{k} kernel not launched")

    ref_bmp = read_reference(read_bmp)

    def save_frame(name, data: bytes):
        """A frame's BMP bytes as DIR/name.bmp.gz (a 1080p BMP is 6 MB; the
        frames together must stay small)."""
        with gzip.open(os.path.join(out_dir, f"{name}.bmp.gz"), "wb") as f:
            f.write(data)

    def hold_reference(name, img, save=True):
        """The frame against the reference binary's BMP, within the bounds
        of tests/test_reference_parity.py::_assert_parity; with `save`, its
        BMP goes to DIR."""
        ours = (img.clamp(0, 1) * 255.0).to(torch.uint8).cpu().numpy()
        if save:
            save_frame(name, bmp_bytes(ours))
        check(name, ours.shape == ref_bmp.shape, f"shape {ours.shape}")
        dd = np.abs(ours.astype(np.int32) - ref_bmp.astype(np.int32)).max(axis=-1)
        parity = {"frac_any": float((dd > 0).mean()),
                  "frac_big": float((dd > 2).mean()), "mean": float(dd.mean())}
        check(name, parity["frac_any"] < 5e-3, f"frac_any {parity['frac_any']}")
        check(name, parity["frac_big"] < 2e-3, f"frac_big {parity['frac_big']}")
        check(name, parity["mean"] < 0.1, f"mean {parity['mean']}")
        check(name, bool(torch.isfinite(img).all()), "non-finite pixels")
        return parity

    def hold_frames(name, a, b, min_within=0.9999):
        """Two renders of one frame: >= 99.99% of pixels within 1e-3 (with
        spheres: more than 99%, see cmp_frame), median < 1e-5."""
        diff = (a - b).abs()
        within = (diff.amax(-1) < 1e-3).float().mean().item()
        med = diff.median().item()
        check(name, within >= min_within, f"{within} of pixels within 1e-3")
        check(name, med < 1e-5, f"median {med}")
        check(name, a.std().item() > 0.01, "flat image")
        return {"within_1e-3": within, "median": med, "max": diff.max().item()}

    parity = hold_reference("car_boxed_1080p", img)
    emit({"phase": "reference_image", "shape": list(img.shape), **parity})
    emit({"phase": "fused_vs_pass", **hold_frames("fused_vs_pass", img, img_pass),
          "hit_frac": (prim.idx >= 0).float().mean().item()})

    # ---- 6. timing at the main path's shapes -----------------------------
    hf = ct.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, o, d, **kw)
    so, sd, m2 = shadow_rays(o, d, hf)
    n_rays = o.x.numel()
    ray_b = nbytes(*o, *d)
    out_plane = n_rays * 4

    def kernel_runs(A, o=o, d=d, so=so, sd=sd, m2=m2, bounces=cfg.bounces, cmat=None):
        """Each kernel of tables A at the main path's shapes (or on the rays
        given): the timed call, the counting call, input bytes, output
        bytes. With `cmat`, the MXU instances."""
        akw = dict(leaf_size=A.leaf_size, stack_depth=A.stack_depth,
                   compressed=A.compressed, cmat=cmat)
        scene_b = nbytes(A.cbox, A.cmeta, *(() if cmat is None else (cmat,))) + leaf_bytes(A)
        runs = {
            "closest": (lambda: ct.closest_tiles(A.cbox, A.cmeta, A.tri, o, d, **akw),
                        lambda: ct.closest_tiles(A.cbox, A.cmeta, A.tri, o, d,
                                                 counters=True, **akw)[1],
                        ray_b + scene_b, 3 * out_plane),
            "closest_full": (
                lambda: ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, o, d, **akw),
                lambda: ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, o, d,
                                              counters=True, **akw)[1],
                ray_b + scene_b + leaf_bytes(A, False, True), 15 * out_plane),
            "occluded": (
                lambda: ct.occluded_tiles(A.cbox, A.cmeta, A.tri, so, sd, m2, **akw),
                lambda: ct.occluded_tiles(A.cbox, A.cmeta, A.tri, so, sd, m2,
                                          counters=True, **akw)[1],
                ray_b + out_plane + scene_b, out_plane),
        }
        if A.arity in ct.ARITIES["frame"]:
            runs["frame"] = (
                lambda: ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d,
                                       bounces=bounces, **akw),
                lambda: ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d,
                                       bounces=bounces, counters=True, **akw)[1],
                ray_b + scene_b + leaf_bytes(A, False, True) + nbytes(A.lamb), 3 * out_plane)
            if A.sph is not None:
                runs["frame_sph"] = (
                    lambda: ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d,
                                           bounces=bounces, sph=A.sph, **akw),
                    lambda: ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d,
                                           bounces=bounces, sph=A.sph, counters=True,
                                           **akw)[1],
                    ray_b + scene_b + leaf_bytes(A, False, True) + nbytes(A.lamb, A.sph),
                    3 * out_plane)
        return runs

    def time_kernels(A, warmup=WARMUP, timed=TIMED, **rays):
        """Times, work counts and bounds of every kernel of tables A, and the
        node-table bytes a ray loads (node visits x VISIT_BYTES)."""
        visit_b = sum(VISIT_BYTES[A.arity, A.compressed or A.cbox.dtype == torch.bfloat16])
        timing = {}
        for name, (fn, counted, in_b, out_b) in kernel_runs(A, **rays).items():
            t = time_ms(fn, warmup, timed)
            b = bound(counted().cpu().tolist(),
                      ct.COUNTS if name.startswith("frame") else ct.count_names(), in_b, out_b,
                      spheres=A.sph.shape[0] if name == "frame_sph" else 0)
            timing[name] = dict(t, rays=n_rays, rays_per_s=n_rays / (t["median"] * 1e-3),
                                node_bytes_per_ray=b["inner_visits"] * visit_b / n_rays, **b)
        return timing

    timing = {"w4": time_kernels(T)}
    for variant in ("fused", "pallas"):
        e2e = time_ms(lambda: pipe.render(variant=variant))
        timing["w4"][f"render_{variant}_end_to_end"] = dict(
            e2e, pixels=W * H, pixels_per_s=W * H / (e2e["median"] * 1e-3))
    emit({"phase": "timing", "card": card, "timing": timing["w4"]})
    emit({"phase": "profile", "card": card,
          "fused": profile(lambda: pipe.render()),
          "pallas": profile(lambda: pipe.render(variant="pallas"))})

    # ---- 7. plain versions at the main path's shapes, one run each -------
    # Each kernel on the full frame's inputs, and its plain version on the
    # rows of every FRAME_TILE_STRIDE-th tile of them (on the whole frame
    # the four plain versions took about 170 s): the plain time beside the
    # kernel's, and one more comparison, of the kernel's output on those
    # rows. The plain results are kept for the arity and stream phases.
    o_s, d_s = spread(o), spread(d)
    so_s, sd_s, m2_s = spread(so), spread(sd), m2[spread_rows]
    n_spread = o_s.x.numel()
    plain = {}
    hk = ct.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, **kw)
    plain["closest"], pms = timed_once(lambda: tp.closest_plain(T.tri, o_s, d_s, L))
    full = {"closest": dict(cmp_hits("closest/frame", spread_out(hk), plain["closest"],
                                     False), plain_ms=pms)}
    del hk
    plain["closest_full"], pms = timed_once(
        lambda: tp.closest_full_plain(T.tri, T.attr, o_s, d_s, L))
    full["closest_full"] = dict(
        cmp_hits("closest_full/frame", spread_out(hf), plain["closest_full"], True),
        plain_ms=pms)
    bk = ct.occluded_tiles(T.cbox, T.cmeta, T.tri, so, sd, m2, **kw)
    plain["occluded"], pms = timed_once(
        lambda: tp.occluded_plain(T.tri, so_s, sd_s, m2_s, L))
    full["occluded"] = dict(cmp_blocked("occluded/frame", spread_out(bk), plain["occluded"]),
                            plain_ms=pms)
    fk = ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, o, d,
                        bounces=cfg.bounces, **kw)
    plain["frame"], pms = timed_once(lambda: ct.frame_plain(
        T.tri, T.attr, T.lamb, o_s, d_s, bounces=cfg.bounces, leaf_size=L))
    full["frame"] = dict(cmp_frame("frame/frame", spread(fk), plain["frame"]), plain_ms=pms)
    for k in full:
        full[k].update(rays=n_spread, tile_stride=FRAME_TILE_STRIDE)
    del bk, fk, o_s, d_s, so_s, sd_s, m2_s
    emit({"phase": "plain_at_frame_shapes", "rays": n_rays, "kernels": full})
    max_err = {"w4": {k: max(cmp[k]["max_abs_err"], full[k]["max_abs_err"])
                      for k in full}}

    # ---- 8. the other node tables: arities, single pop, bf16 boxes --------
    # The plain versions brute-force every triangle slot and read no node
    # table, so the width-4 plain results above hold for every table once
    # tri and attr are the same.
    frames = {}
    stream_src = {"w4": pipe}   # the pipelines whose tables the stream phase pads

    def streamed(p):
        """p streaming, its tri and attr padded to whole blocks as prepare
        pads streamed tables (ops/pack.pad_stream_rows)."""
        t = p.tables

        def pad(a):
            return torch.as_tensor(pad_stream_rows(a.cpu().numpy()), device=a.device)

        return dataclasses.replace(p, tables=t._replace(tri=pad(t.tri), attr=pad(t.attr)),
                                   stream=True)

    def pair_rows_w8(p):
        """The width-8 pipeline with its node table repacked as bf16 pair
        rows (pack_bvh8(bf16=True)) and carried across with compressed=True:
        the pipeline, like JAX's prepare, packs width 8 in f32. An MXU
        pipeline keeps its C-matrix table."""
        check("w8_bf16", p.tables.cbox.dtype == torch.float32 and not p.tables.compressed,
              "the pipeline's bf16 width-8 tables are not f32, as JAX packs them")
        packed = pack_bvh8(p.flat, p.scene.triangle_vertices(), bf16=True)
        t = p.tables
        tables = packed_from_numpy(
            packed.cbox, packed.cmeta, packed.tri, t.attr.cpu().numpy(),
            t.lamb.cpu().numpy(), device=p.device, leaf_size=t.leaf_size,
            compressed=True, sph=None if t.sph is None else t.sph.cpu().numpy())
        return dataclasses.replace(p, tables=tables._replace(cmat=t.cmat))

    for key, extra in ARITY_CASES.items():
        t0 = time.perf_counter()
        acfg = RenderConfig(**CFG, **extra)
        apipe = prepare_native(acfg)
        if key == "w8_bf16":
            apipe = pair_rows_w8(apipe)
        torch.cuda.synchronize()
        A = apipe.tables
        a = A.arity
        bf16 = A.compressed or A.cbox.dtype == torch.bfloat16
        sfx = ",bf16" if bf16 else ""
        akw = dict(leaf_size=A.leaf_size, stack_depth=A.stack_depth,
                   compressed=A.compressed)
        check(key, a == acfg.bvh_width, f"arity {a}")
        check(key, bf16 == acfg.bf16_bvh, f"bf16 tables {bf16}")
        # At width 2 the native builder's own leaf rows are kept, as JAX's
        # native prepare keeps them: the width-4 rows' slots, with each
        # triangle's normal (lanes 9-11 of its 12) rounded in another order.
        # The kernels are held to the plain results on the width-4 rows of
        # the same slots; the pipeline renders with its own.
        normals = (torch.arange(A.tri.shape[1], device=A.tri.device) % 12) >= 9
        tri_diff = (A.tri - T.tri).abs()
        check(key, np.array_equal(apipe.flat.slot_map, pipe.flat.slot_map)
              and torch.equal(A.attr, T.attr) and not bool(tri_diff[:, ~normals].any()),
              "slots, attr or tri beyond the normals differ from the width-4 tables")
        tri_normals_diff = tri_diff.max().item()
        A = A._replace(tri=T.tri)
        box_b, meta_b = VISIT_BYTES[a, bf16]
        rec = {"phase": "arity", "case": key, **extra,
               "prepare_s": time.perf_counter() - t0, "cbox": list(A.cbox.shape),
               "cbox_dtype": str(A.cbox.dtype), "compressed": A.compressed,
               "cbox_bytes": nbytes(A.cbox), "cmeta": list(A.cmeta.shape),
               "visit_bytes": {"box": box_b, "meta": meta_b},
               "stack_need": A.stack_depth, "stack_size": ct.STACK_SIZE[a],
               "builder": apipe.builder, "tri_normals_max_abs_diff": tri_normals_diff}

        # each instance against the plain results: the bands, the frame
        errs = {k: 0.0 for k in ("closest", "closest_full", "occluded", "frame")}
        if a not in ct.ARITIES["frame"]:
            del errs["frame"]

        def keep(k, res):
            errs[k] = max(errs[k], res["max_abs_err"])

        for y0, ref in band_ref.items():
            for kind, (ro, rd) in ref["rays"].items():
                keep("closest", cmp_hits(
                    f"{key}/closest/{kind}@{y0}",
                    ct.closest_tiles(A.cbox, A.cmeta, A.tri, ro, rd, **akw),
                    ref["closest", kind], False))
                keep("closest_full", cmp_hits(
                    f"{key}/closest_full/{kind}@{y0}",
                    ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, ro, rd, **akw),
                    ref["closest_full", kind], True))
            bso, bsd, bm2 = ref["shadow_rays"]
            keep("occluded", cmp_blocked(
                f"{key}/occluded@{y0}",
                ct.occluded_tiles(A.cbox, A.cmeta, A.tri, bso, bsd, bm2, **akw),
                ref["occluded"]))
            if "frame" in errs:
                bo, bd = ref["rays"]["primary"]
                keep("frame", cmp_frame(
                    f"{key}/frame@{y0}",
                    ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, bo, bd,
                                   bounces=cfg.bounces, **akw),
                    ref["frame"]))
        keep("closest", cmp_hits(
            f"{key}/closest/frame",
            spread_out(ct.closest_tiles(A.cbox, A.cmeta, A.tri, o, d, **akw)),
            plain["closest"], False))
        keep("closest_full", cmp_hits(
            f"{key}/closest_full/frame",
            spread_out(ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, o, d, **akw)),
            plain["closest_full"], True))
        keep("occluded", cmp_blocked(
            f"{key}/occluded/frame",
            spread_out(ct.occluded_tiles(A.cbox, A.cmeta, A.tri, so, sd, m2, **akw)),
            plain["occluded"]))
        if "frame" in errs:
            keep("frame", cmp_frame(
                f"{key}/frame/frame",
                spread(ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d,
                                      bounces=cfg.bounces, **akw)),
                plain["frame"]))
        max_err[key] = errs

        # each path with its counts from 0: exactly its table's kernels
        auto = apipe.resolved_variant()
        check(key, auto == ("fused" if a >= 4 else "pallas"), f"auto -> {auto}")
        pass_counts = {f"closest_full<{a}{sfx}>": cfg.bounces,
                       f"occluded<{a}{sfx}>": cfg.bounces * nl}
        aimg, on_auto = on_path(f"{key}/render_auto", apipe.render,
                                {f"frame<{a}{sfx}>": 1} if auto == "fused" else pass_counts)
        if auto == "fused":
            aimg_pass, on_apass = on_path(
                f"{key}/render_pass_based", lambda: apipe.render(variant="pallas"),
                pass_counts)
        else:
            aimg_pass, on_apass = aimg, on_auto
        _, on_aprim = on_path(
            f"{key}/primary_closest_pass",
            lambda: ct.closest_tiles(A.cbox, A.cmeta, A.tri, o, d, **akw),
            {f"closest<{a}{sfx}>": 1})
        launches[key] = {"closest": on_aprim[f"closest<{a}{sfx}>"],
                         "closest_full": on_apass[f"closest_full<{a}{sfx}>"],
                         "occluded": on_apass[f"occluded<{a}{sfx}>"]}
        if auto == "fused":
            launches[key]["frame"] = on_auto[f"frame<{a}{sfx}>"]

        # the frames: the reference BMP, and the width-4 fused frame
        rec["reference_image"] = hold_reference(f"car_boxed_1080p_{key}", aimg)
        rec["vs_width4_fused"] = hold_frames(f"{key}/vs_width4_fused", aimg, img)
        if auto == "fused":
            rec["pass_based_vs_width4_fused"] = hold_frames(
                f"{key}/pass_based_vs_width4_fused", aimg_pass, img)
        frames[key] = aimg

        # timing: every kernel of these tables, and render()
        timing[key] = time_kernels(A, ARITY_WARMUP, ARITY_TIMED)
        for variant in ("auto", "pallas") if auto == "fused" else ("auto",):
            e2e = time_ms(lambda: apipe.render(variant=variant), ARITY_WARMUP, ARITY_TIMED)
            timing[key][f"render_{variant}_end_to_end"] = dict(
                e2e, pixels=W * H, pixels_per_s=W * H / (e2e["median"] * 1e-3))
        # bf16 boxes beside the f32 table of the same width: work and time
        # ratios from the counting instances (recorded, not checked: looser
        # boxes add work in aggregate, but a ray's visit order changes)
        twin = F32_TWIN.get(key)
        if twin:
            tw = timing[twin]
            rec["vs_f32_" + twin] = {k: ratios(t, tw[k]) for k, t in timing[key].items()
                                     if k in ct.ARITIES}
        rec.update(max_abs_err=errs, launches=launches[key], timing=timing[key])
        emit(rec)
        if key in STREAM_CASES:
            stream_src[key] = apipe
        del apipe, A, aimg, aimg_pass

    # ---- 9. the dragon: bench.py's primary rays/s scene --------------------
    dragon = {}
    dplain = {}
    dimg = {}
    for bf16 in (False, True):
        tag = "dragon_bf16" if bf16 else "dragon"
        t0 = time.perf_counter()
        dcfg = RenderConfig(**DRAGON, bf16_bvh=bf16)
        dpipe = prepare_native(dcfg)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        D = dpipe.tables
        sfx = ",bf16" if bf16 else ""
        check(tag, D.compressed == bf16 and D.arity == 4, "not the width-4 tables")
        dkw = dict(leaf_size=D.leaf_size, stack_depth=D.stack_depth,
                   compressed=D.compressed)
        rec = {"phase": "dragon", "case": tag, "prepare_s": prep_s,
               "bvh_build_ms": dpipe.build_ms, "builder": dpipe.builder,
               "numpy_build_s": NUMPY_BUILD_S["dragon"],
               "triangles": dpipe.scene.num_triangles, "cbox": list(D.cbox.shape),
               "tri": list(D.tri.shape), "stack_need": D.stack_depth,
               "stack_size": ct.STACK_SIZE[D.arity],
               "table_bytes": {"cbox": nbytes(D.cbox), "cmeta": nbytes(D.cmeta),
                               "tri": nbytes(D.tri), "attr": nbytes(D.attr)}}
        do, dd = R._tiled_planes(dpipe.camera(), W, H, TR, TC, dpipe.device)
        bo, bd = band(do, DRAGON_BAND), band(dd, DRAGON_BAND)
        dn = do.x.numel()

        # the primary pass over the frame's rays, and the fused render,
        # each with its counts from 0
        dhit, _ = on_path(f"{tag}/primary_closest_pass",
                          lambda: ct.closest_tiles(D.cbox, D.cmeta, D.tri, do, dd, **dkw),
                          {f"closest<4{sfx}>": 1})
        dimg[tag], _ = on_path(f"{tag}/render_fused", dpipe.render,
                               {f"frame<4{sfx}>": 1})

        # the kernels against their plain versions on the band (the plain
        # results read no node table, so one set serves both tables)
        if "closest" not in dplain:
            dplain["closest"], dplain["closest_ms"] = timed_once(
                lambda: tp.closest_plain(D.tri, bo, bd, D.leaf_size))
        rec["band"] = dict(cmp_hits(
            f"{tag}/closest@{DRAGON_BAND}",
            ct.closest_tiles(D.cbox, D.cmeta, D.tri, bo, bd, **dkw),
            dplain["closest"], False), y0=DRAGON_BAND, plain_ms=dplain["closest_ms"])
        if not bf16:
            fp, fms = timed_once(lambda: ct.frame_plain(
                D.tri, D.attr, D.lamb, bo, bd, bounces=dcfg.bounces,
                leaf_size=D.leaf_size))
            rec["frame_band"] = dict(cmp_frame(
                f"{tag}/frame@{DRAGON_BAND}",
                ct.frame_tiles(D.cbox, D.cmeta, D.tri, D.attr, D.lamb, bo, bd,
                               bounces=dcfg.bounces, **dkw), fp),
                y0=DRAGON_BAND, plain_ms=fms)
            del fp
            img_pass_d, _ = on_path(f"{tag}/render_pass_based",
                                    lambda: dpipe.render(variant="pallas"),
                                    {"closest_full<4>": dcfg.bounces,
                                     "occluded<4>": dcfg.bounces * (D.lamb.shape[0] - 1)})
            rec["fused_vs_pass"] = hold_frames(f"{tag}/fused_vs_pass", dimg[tag], img_pass_d)
            del img_pass_d
        check(tag, bool(torch.isfinite(dimg[tag]).all()), "non-finite pixels")
        save_frame(f"{tag}_1080p", bmp_bytes(dimg[tag].cpu().numpy()))

        # stream="on" on these tables: "auto" renders pass-based on the
        # streamed instances only, and gives the resident pass-based frame
        spipe = streamed(dpipe)
        check(f"{tag}/stream", spipe.resolved_variant() == "pallas",
              "a streamed pipeline's auto is not the pass-based path")
        simg, _ = on_path(f"{tag}/stream_render_auto", spipe.render,
                          {f"closest_full_stream<4{sfx}>": dcfg.bounces,
                           f"occluded_stream<4{sfx}>": dcfg.bounces * (D.lamb.shape[0] - 1)})
        rimg = dataclasses.replace(spipe, stream=False).render(variant="pallas")
        same = torch.equal(simg, rimg)
        check(f"{tag}/stream", same, "the streamed frame is not the resident pass-based frame")
        emit({"phase": "stream", "case": f"{tag}_stream_on", "equal_resident_pass_based": same,
              "max_abs_diff": (simg - rimg).abs().max().item(),
              "tri_rows": [D.tri.shape[0], spipe.tables.tri.shape[0]]})
        del spipe, simg, rimg

        # timing: the primary pass (bench.py's metric) and render()
        t = time_ms(lambda: ct.closest_tiles(D.cbox, D.cmeta, D.tri, do, dd, **dkw),
                      ARITY_WARMUP, ARITY_TIMED)
        counts = ct.closest_tiles(D.cbox, D.cmeta, D.tri, do, dd, counters=True,
                                  **dkw)[1].cpu().tolist()
        b = bound(counts, ct.COUNTS, nbytes(*do, *dd, D.cbox, D.cmeta) + leaf_bytes(D),
                  3 * dn * 4)
        box_b, meta_b = VISIT_BYTES[4, bf16]
        rec["primary_pass"] = dict(
            t, rays=dn, rays_per_s=dn / (t["median"] * 1e-3),
            bound_rays_per_s=dn / (b["bound_ms"] * 1e-3),
            hit_frac=(dhit.idx >= 0).float().mean().item(),
            node_bytes_per_ray=b["inner_visits"] * (box_b + meta_b) / dn, **b)
        e2e = time_ms(dpipe.render, ARITY_WARMUP, ARITY_TIMED)
        rec["render_fused_end_to_end"] = dict(
            e2e, pixels=W * H, pixels_per_s=W * H / (e2e["median"] * 1e-3))
        dragon[tag] = rec
        emit(rec)
        del dpipe, D, do, dd, bo, bd, dhit
    dr = {"phase": "dragon_compare",
          "bf16_vs_f32_fused": hold_frames("dragon/bf16_vs_f32_fused",
                                           dimg["dragon_bf16"], dimg["dragon"])}
    dr["bf16_vs_f32_primary"] = ratios(dragon["dragon_bf16"]["primary_pass"],
                                       dragon["dragon"]["primary_pass"])
    emit(dr)
    del dimg, dplain

    # ---- 10. streamed leaf rows --------------------------------------------
    def planes(h, full=False):
        """A hit's output planes, for a comparison bit for bit."""
        return [h.t, h.idx, h.norm_dir] + ([*h.n, *h.kd, *h.ks, *h.kr] if full else [])

    def same_bits(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # car_boxed: each streamed instance on the padded tables of its width and
    # box format, against its resident twin (bit for bit) and the plain
    # results, timed beside the twin, and reached through the paths of a
    # streamed pipeline with the counts from 0
    out_planes = {"closest": 3, "closest_full": 15, "occluded": 1}
    sph_src = {}   # the resident tables of these cases, for the spheres phase
    for key in STREAM_CASES:
        src = stream_src.pop(key)
        sph_src[key] = src.tables
        sp = streamed(src)
        A = sp.tables
        a, sfx = A.arity, ",bf16" if A.compressed else ""
        akw = dict(leaf_size=A.leaf_size, stack_depth=A.stack_depth, compressed=A.compressed)

        def call(k, s, *rays, **extra):
            if k == "occluded":
                return ct.occluded_tiles(A.cbox, A.cmeta, A.tri, *rays, stream=s, **akw, **extra)
            if k == "closest_full":
                return ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, *rays,
                                             stream=s, **akw, **extra)
            return ct.closest_tiles(A.cbox, A.cmeta, A.tri, *rays, stream=s, **akw, **extra)

        def outputs(k, h):
            return [h] if k == "occluded" else planes(h, k == "closest_full")

        def against_plain(name, k, h, ref):
            if k == "occluded":
                return cmp_blocked(name, h, ref)["max_abs_err"]
            return cmp_hits(name, h, ref, k == "closest_full")["max_abs_err"]

        errs = {k: 0.0 for k in out_planes}
        for y0, ref in band_ref.items():
            cases = [(k, kind, rays, ref[k, kind]) for kind, rays in ref["rays"].items()
                     for k in ("closest", "closest_full")]
            cases.append(("occluded", "shadow", ref["shadow_rays"], ref["occluded"]))
            for k, kind, rays, want in cases:
                name = f"{key}/{k}_stream/{kind}@{y0}"
                h = call(k, True, *rays)
                check(name, same_bits(outputs(k, h), outputs(k, call(k, False, *rays))),
                      "differs from the resident twin")
                errs[k] = max(errs[k], against_plain(name, k, h, want))
        res = {}
        for k, rays in (("closest", (o, d)), ("closest_full", (o, d)),
                        ("occluded", (so, sd, m2))):
            name = f"{key}/{k}_stream/frame"
            h = call(k, True, *rays)
            check(name, same_bits(outputs(k, h), outputs(k, call(k, False, *rays))),
                  "differs from the resident twin")
            errs[k] = max(errs[k], against_plain(name, k, spread_out(h), plain[k]))
            del h
            t_res = time_ms(lambda: call(k, False, *rays), ARITY_WARMUP, ARITY_TIMED)
            t_str = time_ms(lambda: call(k, True, *rays), ARITY_WARMUP, ARITY_TIMED)
            in_b = (ray_b + nbytes(A.cbox, A.cmeta) + leaf_bytes(A, attr=k == "closest_full")
                    + (out_plane if k == "occluded" else 0))
            b = bound(call(k, True, *rays, counters=True)[1].cpu().tolist(),
                      ct.STREAM_COUNTS, in_b, out_planes[k] * out_plane)
            res[k + "_stream"] = dict(
                t_str, rays=n_rays, rays_per_s=n_rays / (t_str["median"] * 1e-3),
                resident=t_res, vs_resident=t_str["median"] / t_res["median"],
                fills_per_leaf=b["block_fills"] / max(b["leaf_visits"], 1),
                syncs_per_leaf=b["sync_fetches"] / max(b["leaf_visits"], 1), **b)
        check(key, sp.resolved_variant() == "pallas",
              "a streamed pipeline's auto is not the pass-based path")
        simg, on_s = on_path(f"{key}/stream_render_auto", sp.render,
                             {f"closest_full_stream<{a}{sfx}>": cfg.bounces,
                              f"occluded_stream<{a}{sfx}>": cfg.bounces * nl})
        rimg = dataclasses.replace(sp, stream=False).render(variant="pallas")
        frame_equal = torch.equal(simg, rimg)
        check(f"{key}/stream_render_auto", frame_equal,
              "the streamed frame is not the resident pass-based frame")
        _, on_p = on_path(f"{key}/stream_primary_closest_pass",
                          lambda: call("closest", True, o, d), {f"closest_stream<{a}{sfx}>": 1})
        launches[key].update(closest_stream=on_p[f"closest_stream<{a}{sfx}>"],
                             closest_full_stream=on_s[f"closest_full_stream<{a}{sfx}>"],
                             occluded_stream=on_s[f"occluded_stream<{a}{sfx}>"])
        e2e = time_ms(sp.render, ARITY_WARMUP, ARITY_TIMED)
        res["render_stream_end_to_end"] = dict(e2e, pixels=W * H,
                                               pixels_per_s=W * H / (e2e["median"] * 1e-3))
        timing[key].update(res)
        max_err[key].update({k + "_stream": v for k, v in errs.items()})
        emit({"phase": "stream", "case": key, "card": card,
              "tri_rows": [src.tables.tri.shape[0], A.tri.shape[0]], "max_abs_err": errs,
              "launches": {k: n for k, n in launches[key].items() if "stream" in k},
              "frame_equal_resident_pass_based": frame_equal, "timing": res,
              "count_meaning": STREAM_COUNT_MEANING})
        del src, sp, A, simg, rimg

    # synthetic_600k: the smallest scene of scripts/bench_stream.py that JAX
    # streams; "auto" must stream here too, and render pass-based
    t0 = time.perf_counter()
    scfg = RenderConfig(**SYNTHETIC_600K)
    spipe = prepare_native(scfg)
    torch.cuda.synchronize()
    S = spipe.tables
    g_rows = spipe.flat.n_slots // S.leaf_size + 1     # tri rows before padding
    row_model = 512 * (S.cbox.shape[0] + S.cmeta.shape[0] + 2 * g_rows)
    name = "synthetic_600k"
    check(name, spipe.stream, "auto did not stream, as JAX would")
    check(name, spipe.resolved_variant() == "pallas", "auto is not the pass-based path")
    check(name, S.tri.shape[0] % 4 == 0 and S.attr.shape == S.tri.shape,
          "tri and attr are not padded to whole blocks")
    rec = {"phase": "stream", "case": name, "card": card,
           "prepare_s": time.perf_counter() - t0, "bvh_build_ms": spipe.build_ms,
           "builder": spipe.builder, "numpy_prepare_s": NUMPY_PREPARE_S["synthetic_600k"],
           "numpy_build_s": NUMPY_BUILD_S["synthetic_600k"],
           "triangles": spipe.scene.num_triangles, "cbox": list(S.cbox.shape),
           "cmeta": list(S.cmeta.shape), "tri": list(S.tri.shape), "tri_rows_unpadded": g_rows,
           "table_bytes": {"cbox": nbytes(S.cbox), "cmeta": nbytes(S.cmeta),
                           "tri": nbytes(S.tri), "attr": nbytes(S.attr)},
           "row_model_bytes": row_model, "row_model_mib": row_model / 2 ** 20,
           "stream": spipe.stream, "auto_variant": spipe.resolved_variant(),
           "stack_need": S.stack_depth, "stack_size": ct.STACK_SIZE[S.arity],
           "count_meaning": STREAM_COUNT_MEANING}
    o6, d6 = R._tiled_planes(spipe.camera(), W, H, TR, TC, spipe.device)
    skw = dict(leaf_size=S.leaf_size, stack_depth=S.stack_depth)

    def primary(s, counters=False):
        return ct.closest_tiles(S.cbox, S.cmeta, S.tri, o6, d6, stream=s,
                                counters=counters, **skw)

    h_res, h_str = primary(False), primary(True)
    check(name, same_bits(planes(h_res), planes(h_str)),
          "streamed and resident primary hits differ")
    rec["hit_frac"] = (h_res.idx >= 0).float().mean().item()
    del h_res, h_str
    # in turns: resident, streamed, streamed, resident
    turns = [time_ms(lambda: primary(s), ARITY_WARMUP, ARITY_TIMED)
             for s in (False, True, True, False)]
    n6, in_b = o6.x.numel(), nbytes(*o6, *d6, S.cbox, S.cmeta) + leaf_bytes(S)
    for s, label, names, ts in ((False, "resident", ct.count_names(False), (turns[0], turns[3])),
                                (True, "streamed", ct.count_names(True), (turns[1], turns[2]))):
        b = bound(primary(s, True)[1].cpu().tolist(), names, in_b, 3 * n6 * 4)
        med = statistics.median([ts[0]["median"], ts[1]["median"]])
        rec[f"primary_{label}"] = dict(
            runs=list(ts), median=med, rays=n6, rays_per_s=n6 / (med * 1e-3),
            leaf_visits_per_ray=b["leaf_visits"] / n6,
            inner_visits_per_ray=b["inner_visits"] / n6, **b)
    st = rec["primary_streamed"]
    st["fills_per_leaf"] = st["block_fills"] / max(st["leaf_visits"], 1)
    st["syncs_per_leaf"] = st["sync_fetches"] / max(st["leaf_visits"], 1)
    st["vs_resident"] = st["median"] / rec["primary_resident"]["median"]
    # the streamed pass against its plain version on one band
    bo6 = band(o6, SYNTHETIC_BAND, SYNTHETIC_BAND_ROWS)
    bd6 = band(d6, SYNTHETIC_BAND, SYNTHETIC_BAND_ROWS)
    hp6, pms = timed_once(lambda: tp.closest_plain(S.tri, bo6, bd6, S.leaf_size))
    rec["band"] = dict(cmp_hits(f"{name}/closest_stream@{SYNTHETIC_BAND}",
                                ct.closest_tiles(S.cbox, S.cmeta, S.tri, bo6, bd6,
                                                 stream=True, **skw), hp6, False),
                       y0=SYNTHETIC_BAND, rows=SYNTHETIC_BAND_ROWS, plain_ms=pms)
    del hp6
    # the paths, each with its counts from 0
    simg, _ = on_path(f"{name}/render_auto", spipe.render,
                      {"closest_full_stream<4>": scfg.bounces})
    on_path(f"{name}/primary_closest_stream", lambda: primary(True), {"closest_stream<4>": 1})
    on_path(f"{name}/primary_closest_resident", lambda: primary(False), {"closest<4>": 1})
    fimg, _ = on_path(f"{name}/render_fused", lambda: spipe.render(variant="fused"),
                      {"frame<4>": 1})
    diff = (simg - fimg).abs()
    within = (diff.amax(-1) < 1e-3).float().mean().item()
    check(name, within >= 0.9999, f"fused and auto frames: {within} of pixels within 1e-3")
    check(name, bool(torch.isfinite(simg).all()), "non-finite pixels")
    rec["fused_vs_auto"] = {"within_1e-3": within, "max": diff.max().item()}
    save_frame(f"{name}_1080p", bmp_bytes(simg.cpu().numpy()))
    for variant in ("auto", "fused"):
        e2e = time_ms(lambda: spipe.render(variant=variant), 3, 10)
        rec[f"render_{variant}_end_to_end"] = dict(
            e2e, pixels=W * H, pixels_per_s=W * H / (e2e["median"] * 1e-3))
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(rec)
    del spipe, S, o6, d6, bo6, bd6, simg, fimg, diff

    def row(name, tables, launches, err, t, plain_ms, plain_of, line):
        """One entry of the kernels line."""
        return {"name": name, "route": "cuda",
                "source": "parallel_ray_tracer_tpu_torch/csrc/trace.cuh",
                "replaces": f"parallel_ray_tracer_tpu/ops/pallas_trace.py:{line}",
                "tables": tables, "launches": launches, "max_abs_err": err,
                "ms": t["median"], "plain_ms": plain_ms, "plain_of": plain_of,
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None, "rays": n_rays}

    def time_one(A, kernel, cmat=None, **rays):
        """Time, work counts and bound of one kernel of tables A (with
        `cmat`, its MXU instance)."""
        fn, counted, in_b, out_b = kernel_runs(A, cmat=cmat, **rays)[kernel]
        t = time_ms(fn, ARITY_WARMUP, ARITY_TIMED)
        return dict(t, rays=n_rays, **bound(
            counted().cpu().tolist(), count_names(kernel, cmat is not None), in_b, out_b,
            spheres=A.sph.shape[0] if kernel == "frame_sph" else 0, leaf=A.leaf_size))

    def box_name(A):
        return ", PAIRS" if A.compressed else (", BF16" if A.cbox.dtype == torch.bfloat16 else "")

    extra_rows = []

    # ---- 11. spheres: car_boxed_spheres (row 14) -----------------------------
    # car_boxed plus 8 spheres placed from its bounding box with a seed
    # (models/procgen.with_spheres): the triangle tables are car_boxed's, so
    # each table of the earlier phases takes the sphere table as it is.
    t0 = time.perf_counter()
    ssc = with_spheres(load_scene_npz(os.path.join(HERE, "assets", "car_boxed.npz")))
    spipe = prepare_native(cfg, scene=ssc)
    torch.cuda.synchronize()
    name = "car_boxed_spheres"
    sph = spipe.tables.sph
    ns = sph.shape[0]
    mats = ssc.spheres_mat
    kr = ssc.mats_kr[mats].max(axis=1)
    rec = {"phase": "spheres", "case": name, "card": card,
           "prepare_s": time.perf_counter() - t0,
           "spheres": {"center": ssc.spheres_center.tolist(),
                       "radius": ssc.spheres_radius.tolist(),
                       "kd": ssc.mats_kd[mats].tolist(), "ks": ssc.mats_ks[mats].tolist(),
                       "kr": ssc.mats_kr[mats].tolist()}}
    check(name, ns == 8 and (kr >= 0.5).sum() >= 2 and (kr == 0).sum() >= 2,
          "not 8 spheres with at least 2 mirrors and 2 diffuse ones")
    check(name, all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))  # bits: NaN boxes
                    for a, b in zip(spipe.tables[:4], T[:4])),
          "its tables are not car_boxed's")
    check(name, spipe.resolved_variant() == "fused", "auto is not the fused frame")
    sph_cases = {k: A._replace(sph=sph) for k, A in
                 {"w4": T, **{k: sph_src[k] for k in ("w8", "w4_bf16", "w8_bf16")}}.items()}
    del sph_src

    # the sphere frame kernel at each table against its plain version, on
    # one band (the plain version reads no node table)
    bo, bd = band(o, SPHERE_BAND), band(d, SPHERE_BAND)
    sph_fp, sph_plain_ms = timed_once(lambda: ct.frame_plain(
        T.tri, T.attr, T.lamb, bo, bd, bounces=cfg.bounces, leaf_size=L, sph=sph))
    rec["band_plain_ms"] = sph_plain_ms
    rec["band_changed_by_spheres"] = (
        sph_fp.stack(-1) - band_ref[SPHERE_BAND]["frame"].stack(-1)).abs().max().item()
    sph_err, rec["band"] = {}, {}
    for key, A in sph_cases.items():
        akw = dict(leaf_size=L, stack_depth=A.stack_depth, compressed=A.compressed)
        res = cmp_frame(f"{name}/{key}/frame_sph@{SPHERE_BAND}", ct.frame_tiles(
            A.cbox, A.cmeta, A.tri, A.attr, A.lamb, bo, bd, bounces=cfg.bounces,
            sph=sph, **akw), sph_fp, 0.99)
        sph_err[key] = res["max_abs_err"]
        rec["band"][key] = res

    # the paths, each with its counts from 0
    simg, on_f = on_path(f"{name}/render_fused", spipe.render, {"frame_sph<4>": 1})
    simg_pass, _ = on_path(f"{name}/render_pass_based", lambda: spipe.render(variant="pallas"),
                           {"closest_full<4>": cfg.bounces, "occluded<4>": cfg.bounces * nl})
    sph_launches = {"w4": on_f["frame_sph<4>"]}
    for key in ("w8", "w4_bf16", "w8_bf16"):
        A = sph_cases[key]
        k = f"frame_sph<{A.arity}{',bf16' if A.compressed else ''}>"
        _, on_a = on_path(f"{name}/{key}/render_fused",
                          dataclasses.replace(spipe, tables=A).render, {k: 1})
        sph_launches[key] = on_a[k]
    rec["fused_vs_pass"] = hold_frames(f"{name}/fused_vs_pass", simg, simg_pass, 0.99)
    rec["changed_by_spheres"] = (simg - img).abs().max().item()
    check(name, rec["changed_by_spheres"] > 0.05, "the spheres do not change the image")
    f_free = ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, o, d,
                            bounces=cfg.bounces, **kw)
    f_empty = ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, o, d,
                             bounces=cfg.bounces, sph=sph[:0], **kw)
    rec["empty_table_bit_equal"] = (all(torch.equal(a, b) for a, b in zip(f_empty, f_free))
                                    and torch.equal(R._to_image(f_empty, W, H, TR, TC), img))
    check(name, rec["empty_table_bit_equal"],
          "an empty sphere table does not give the sphere-free frame bit for bit")
    del f_free, f_empty
    save_frame(f"{name}_1080p", bmp_bytes(simg.cpu().numpy()))

    # every sphere is seen by a primary ray, and one shadows a triangle
    nt = spipe.ds.num_triangles

    def t_occluded(o_, d_, m2_):
        return ct.occluded_tiles(T.cbox, T.cmeta, T.tri, o_, d_, m2_, **kw)

    w_closest, w_occluded = wrap_tracer(
        spipe.ds, lambda o_, d_: ct.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr,
                                                       o_, d_, **kw), t_occluded)
    hw = w_closest(o, d)
    rec["visible_spheres"] = sorted(set((hw.idx[hw.idx >= nt] - nt).tolist()))
    check(name, rec["visible_spheres"] == list(range(ns)),
          f"spheres seen by primary rays: {rec['visible_spheres']}")
    wso, wsd, wm2 = shadow_rays(o, d, hw)
    by_sphere = (w_occluded(wso, wsd, wm2) & ~t_occluded(wso, wsd, wm2)
                 & (hw.idx >= 0) & (hw.idx < nt))
    rec["pixels_shadowed_by_spheres_on_triangles"] = int(by_sphere.sum())
    check(name, rec["pixels_shadowed_by_spheres_on_triangles"] > 0,
          "no sphere casts a shadow on a triangle")
    del hw, wso, wsd, wm2, by_sphere

    # timing: the sphere frame at each table, the sphere-free frame<4>
    # beside it in this call, and both render()s
    sph_t = {key: time_one(A, "frame_sph") for key, A in sph_cases.items()}
    rec["timing"] = {"frame_sph": sph_t, "frame_free_w4": time_one(T, "frame")}
    for variant in ("fused", "pallas"):
        e2e = time_ms(lambda: spipe.render(variant=variant), ARITY_WARMUP, ARITY_TIMED)
        rec["timing"][f"render_{variant}_end_to_end"] = dict(
            e2e, pixels=W * H, pixels_per_s=W * H / (e2e["median"] * 1e-3))
    rec["profile"] = {"fused": profile(spipe.render),
                      "pallas": profile(lambda: spipe.render(variant="pallas"))}
    rec.update(max_abs_err=sph_err, launches=sph_launches)
    emit(rec)
    for key, A in sph_cases.items():
        extra_rows.append(row(
            f"frame_kernel<{A.arity}{box_name(A)}, SPH>", f"{key}+spheres",
            sph_launches[key], sph_err[key], sph_t[key], sph_plain_ms,
            f"one {BAND_ROWS}-row band (y {SPHERE_BAND}), the same rays", 2536))
    sph_pipe = spipe    # kept for the shadows phase
    del spipe, sph_cases, simg, simg_pass

    # ---- 12. brute force: the oracle ------------------------------------------
    # tests/test_spheres.py's scene at 1080p, 2 bounces: by brute force
    # (use_bvh=False) against the pass-based BVH render within atol 3e-5
    # (as tests/test_spheres.py holds it) and the fused render within the
    # frame bounds; car_boxed by brute force on a band against the fused
    # frame; --no-bvh through the command line.
    t0 = time.perf_counter()
    small = Scene(**{k: np.asarray(v, np.int32 if k in ("faces", "mat_idx", "spheres_mat")
                                   else np.float32) for k, v in SPHERE_SCENE.items()})
    bcfg = RenderConfig(**dict(CFG, bounces=2))
    bpipe = prepare_native(bcfg, scene=small)
    npipe = prepare_native(dataclasses.replace(bcfg, use_bvh=False), scene=small)
    rec = {"phase": "brute", "case": "sphere_scene_1080p", "card": card,
           "prepare_s": time.perf_counter() - t0}
    check("brute", npipe.tables is None and npipe.resolved_variant() == "bruteforce",
          "use_bvh=False built tables or does not resolve to bruteforce")
    bimg, _ = on_path("brute/render_no_bvh", npipe.render, {})
    pimg = bpipe.render(variant="pallas")
    diff = (pimg - bimg).abs()
    rec["vs_pass_based_max"] = diff.max().item()
    check("brute/vs_pass_based", bool((diff <= 3e-5 + 1e-7 * bimg.abs()).all()),
          f"max {rec['vs_pass_based_max']} beyond atol 3e-5")
    rec["vs_fused"] = hold_frames("brute/vs_fused", bpipe.render(), bimg, 0.99)
    red = (bimg[..., 0] > bimg[..., 1] + 0.1) & (bimg[..., 0] > bimg[..., 2] + 0.1)
    rec["red_pixels"] = int(red.sum())
    check("brute", rec["red_pixels"] > 1000, "the red sphere is not in the frame")
    rec["render_bruteforce"] = dict(time_ms(npipe.render, 2, 10), pixels=W * H)
    rec["render_pass_based"] = dict(time_ms(lambda: bpipe.render(variant="pallas"), 2, 10))
    del pimg, diff, bpipe

    # car_boxed by brute force on one band, against the fused frame
    cf, of = trace_brute.make_tracer(pipe.ds)
    bb, bb_ms = timed_once(lambda: R.render_band(
        pipe.ds, cf, of, ray_basis(pipe.camera(), W, H), W, H, BRUTE_BAND,
        BRUTE_BAND_ROWS, cfg.bounces))
    rec["car_boxed_band"] = dict(
        hold_frames("brute/car_boxed_band", bb,
                    img[BRUTE_BAND:BRUTE_BAND + BRUTE_BAND_ROWS], 0.99),
        y0=BRUTE_BAND, rows=BRUTE_BAND_ROWS, ms=bb_ms)
    del bb

    # --no-bvh through the command line, on the scene as an asset folder
    with tempfile.TemporaryDirectory() as tmp:
        write_sphere_folder(os.path.join(tmp, "spheres"))
        cli_bmp = os.path.join(out_dir, "cli_no_bvh.bmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "parallel_ray_tracer_tpu_torch", "--scene", "spheres",
             "--asset-root", tmp, "--no-bvh", "--resolution", "1080p", "--bounces", "2",
             "--warmup", "1", "--iterations", "3", "--output", cli_bmp],
            capture_output=True, text=True, cwd=HERE, timeout=300)
    rec["cli_no_bvh"] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                         "stdout_tail": proc.stdout[-1200:], "stderr_tail": proc.stderr[-1200:]}
    check("brute/cli_no_bvh", proc.returncode == 0, f"exit {proc.returncode}")
    if proc.returncode == 0:
        with open(cli_bmp, "rb") as f:
            data = f.read()
        os.remove(cli_bmp)
        save_frame("cli_no_bvh", data)
        rec["cli_no_bvh"]["bmp_equal"] = data == bmp_bytes(bimg.cpu().numpy())
        check("brute/cli_no_bvh", rec["cli_no_bvh"]["bmp_equal"],
              "its BMP is not the in-process brute-force frame")
    save_frame("sphere_scene_brute_1080p", bmp_bytes(bimg.cpu().numpy()))
    emit(rec)
    del bimg, npipe

    # ---- 13. the DEEP stack tier: a tree deeper than the standard stacks ---
    # models/procgen.chain_scene: 48 binary levels, so its stack need passes
    # the standard tier at every arity and every launch on it takes the DEEP
    # instances. 1080p, 1 bounce, the main path's rays. Each DEEP instance
    # (every box format, resident and streamed, with and without spheres)
    # against its plain version at the frame's shapes (56 triangles: the
    # plain versions are cheap here), through its path with the counts
    # from 0, and timed. Then the DEEP tier forced on car_boxed's width-4
    # tables, in turns with the standard tier.
    chain = chain_scene()
    dsph = torch.tensor(np.pad(np.asarray(DEEP_SPHERES, np.float32), ((0, 0), (0, 3))),
                        device=pipe.device)

    def deep_cases(leaf):
        """Each DEEP instance of leaf size `leaf` on the chain scene (the
        cases of DEEP_CASES): against its plain version at the frame's
        shapes, through its paths with the counts from 0, timed; its
        kernels-line rows go to extra_rows."""
        tag = ct._leaf_tag(leaf)
        lname, ltab = (f", L={leaf}", f"_l{leaf}") if tag else ("", "")
        dref = {}
        for key, extra in DEEP_CASES.items():
            t0 = time.perf_counter()
            dp = prepare_native(RenderConfig(**DEEP_CFG, leaf_size=leaf, **extra), scene=chain)
            if key == "w8_bf16":
                dp = pair_rows_w8(dp)
            D = dp.tables
            a = D.arity
            bf = D.compressed or D.cbox.dtype == torch.bfloat16
            sfx = ",bf16" if bf else ""
            need = D.stack_depth
            rec = {"phase": "deep", "case": key, "leaf_size": leaf, "card": card,
                   "prepare_s": time.perf_counter() - t0,
                   "tree_depth": dp.flat.depth, "stack_need": need,
                   "standard_stack": ct.STACK_SIZE[a],
                   "standard_tier_refuses": need > ct.STACK_SIZE[a]}
            check(f"deep{ltab}/{key}", need > ct.STACK_SIZE[a] and ct.use_deep_tier(need, a)
                  and bf == bool(extra.get("bf16_bvh")),
                  f"stack need {need} does not pass the standard tier's {ct.STACK_SIZE[a]}")
            check(f"deep{ltab}/{key}", D.leaf_size == leaf, f"leaf size {D.leaf_size}")
            dkw = dict(leaf_size=leaf, stack_depth=need, compressed=D.compressed)
            if not dref:   # the plain results (they read no node table)
                hp, ms_cf = timed_once(lambda: tp.closest_full_plain(D.tri, D.attr, o, d, leaf))
                dso, dsd, dm2 = shadow_rays(o, d, hp, D.lamb)
                dref.update({"closest_full": (hp, ms_cf), "shadow": (dso, dsd, dm2),
                             "closest": timed_once(lambda: tp.closest_plain(D.tri, o, d, leaf)),
                             "occluded": timed_once(lambda: tp.occluded_plain(
                                 D.tri, dso, dsd, dm2, leaf)),
                             "frame": timed_once(lambda: ct.frame_plain(
                                 D.tri, D.attr, D.lamb, o, d, bounces=1, leaf_size=leaf)),
                             "frame_sph": timed_once(lambda: ct.frame_plain(
                                 D.tri, D.attr, D.lamb, o, d, bounces=1, leaf_size=leaf,
                                 sph=dsph))})
                rec["hit_frac"] = (hp.idx >= 0).float().mean().item()
            dso, dsd, dm2 = dref["shadow"]
            Ds = D._replace(sph=dsph)
            errs = {
                "closest": cmp_hits(f"deep{ltab}/{key}/closest", ct.closest_tiles(
                    D.cbox, D.cmeta, D.tri, o, d, **dkw), dref["closest"][0], False),
                "closest_full": cmp_hits(f"deep{ltab}/{key}/closest_full", ct.closest_tiles_full(
                    D.cbox, D.cmeta, D.tri, D.attr, o, d, **dkw), dref["closest_full"][0], True),
                "occluded": cmp_blocked(f"deep{ltab}/{key}/occluded", ct.occluded_tiles(
                    D.cbox, D.cmeta, D.tri, dso, dsd, dm2, **dkw), dref["occluded"][0])}
            if a >= 4:
                errs["frame"] = cmp_frame(f"deep{ltab}/{key}/frame", ct.frame_tiles(
                    D.cbox, D.cmeta, D.tri, D.attr, D.lamb, o, d, bounces=1, **dkw),
                    dref["frame"][0])
                errs["frame_sph"] = cmp_frame(f"deep{ltab}/{key}/frame_sph", ct.frame_tiles(
                    D.cbox, D.cmeta, D.tri, D.attr, D.lamb, o, d, bounces=1, sph=dsph, **dkw),
                    dref["frame_sph"][0], 0.99)

            # the paths, each with its counts from 0
            dl = {}
            pass_counts = {f"closest_full<{a}{sfx},deep{tag}>": 1, f"occluded<{a}{sfx},deep{tag}>": 1}
            if a >= 4:
                _, on_a = on_path(f"deep{ltab}/{key}/render_auto", dp.render, {f"frame<{a}{sfx},deep{tag}>": 1})
                dl["frame"] = on_a[f"frame<{a}{sfx},deep{tag}>"]
                _, on_s = on_path(f"deep{ltab}/{key}/render_fused_spheres",
                                  dataclasses.replace(dp, tables=Ds).render,
                                  {f"frame_sph<{a}{sfx},deep{tag}>": 1})
                dl["frame_sph"] = on_s[f"frame_sph<{a}{sfx},deep{tag}>"]
                _, on_p = on_path(f"deep{ltab}/{key}/render_pass_based",
                                  lambda: dp.render(variant="pallas"), pass_counts)
            else:
                _, on_p = on_path(f"deep{ltab}/{key}/render_auto", dp.render, pass_counts)
            dl["closest_full"] = on_p[f"closest_full<{a}{sfx},deep{tag}>"]
            dl["occluded"] = on_p[f"occluded<{a}{sfx},deep{tag}>"]
            _, on_c = on_path(f"deep{ltab}/{key}/primary_closest_pass",
                              lambda: ct.closest_tiles(D.cbox, D.cmeta, D.tri, o, d, **dkw),
                              {f"closest<{a}{sfx},deep{tag}>": 1})
            dl["closest"] = on_c[f"closest<{a}{sfx},deep{tag}>"]

            # timing, and the kernels line
            drays = dict(so=dso, sd=dsd, m2=dm2, bounces=1)
            dt = {k: time_one(Ds if k == "frame_sph" else D, k, **drays) for k in errs}
            bn = box_name(D)
            names = {"closest": f"closest_kernel<{a}{bn}, false, DEEP{lname}>",
                     "closest_full": f"closest_kernel<{a}{bn}, true, DEEP{lname}>",
                     "occluded": f"occluded_kernel<{a}{bn}, DEEP{lname}>",
                     "frame": f"frame_kernel<{a}{bn}, DEEP{lname}>",
                     "frame_sph": f"frame_kernel<{a}{bn}, SPH, DEEP{lname}>"}
            lines = {"closest": 610 if a == 2 else 1774, "closest_full": 2437 if a == 2 else 1774,
                     "occluded": 676 if a == 2 else 1835, "frame": 2536, "frame_sph": 2536}
            for k in errs:
                extra_rows.append(row(names[k], f"deep_{key}{ltab}", dl[k], errs[k]["max_abs_err"],
                                      dt[k], dref[k][1], "the chain scene, the same rays",
                                      lines[k]))

            # streamed leaf rows (arity 4 and 8): bit for bit against the
            # resident DEEP twin, through a streamed pipeline's paths
            if a >= 4:
                sdp = streamed(dp)
                S_ = sdp.tables
                skw = dict(dkw, stream=True)
                outs = {"closest": (lambda s_: planes(ct.closest_tiles(
                                        S_.cbox, S_.cmeta, S_.tri, o, d, stream=s_, **dkw))),
                        "closest_full": (lambda s_: planes(ct.closest_tiles_full(
                                        S_.cbox, S_.cmeta, S_.tri, S_.attr, o, d, stream=s_, **dkw),
                                        True)),
                        "occluded": (lambda s_: [ct.occluded_tiles(
                                        S_.cbox, S_.cmeta, S_.tri, dso, dsd, dm2, stream=s_, **dkw)])}
                for k, fn in outs.items():
                    check(f"deep{ltab}/{key}/{k}_stream", same_bits(fn(True), fn(False)),
                          "differs from the resident DEEP twin")
                _, on_ss = on_path(f"deep{ltab}/{key}/stream_render_auto", sdp.render,
                                   {f"closest_full_stream<{a}{sfx},deep{tag}>": 1,
                                    f"occluded_stream<{a}{sfx},deep{tag}>": 1})
                _, on_sc = on_path(f"deep{ltab}/{key}/stream_primary_closest_pass",
                                   lambda: ct.closest_tiles(S_.cbox, S_.cmeta, S_.tri, o, d, **skw),
                                   {f"closest_stream<{a}{sfx},deep{tag}>": 1})
                st_launch = {"closest": on_sc[f"closest_stream<{a}{sfx},deep{tag}>"],
                             "closest_full": on_ss[f"closest_full_stream<{a}{sfx},deep{tag}>"],
                             "occluded": on_ss[f"occluded_stream<{a}{sfx},deep{tag}>"]}
                st_calls = {"closest": lambda c=False: ct.closest_tiles(
                                S_.cbox, S_.cmeta, S_.tri, o, d, counters=c, **skw),
                            "closest_full": lambda c=False: ct.closest_tiles_full(
                                S_.cbox, S_.cmeta, S_.tri, S_.attr, o, d, counters=c, **skw),
                            "occluded": lambda c=False: ct.occluded_tiles(
                                S_.cbox, S_.cmeta, S_.tri, dso, dsd, dm2, counters=c, **skw)}
                st_out = {"closest": 3, "closest_full": 15, "occluded": 1}
                for k, fn in st_calls.items():
                    tt = time_ms(fn, ARITY_WARMUP, ARITY_TIMED)
                    in_b = (ray_b + nbytes(S_.cbox, S_.cmeta)
                            + leaf_bytes(S_, attr=k == "closest_full")
                            + (out_plane if k == "occluded" else 0))
                    tt.update(bound(fn(True)[1].cpu().tolist(), ct.STREAM_COUNTS, in_b,
                                    st_out[k] * out_plane))
                    dt[k + "_stream"] = tt
                    extra_rows.append(row(
                        names[k].replace(", DEEP", ", STREAM, DEEP"), f"deep_{key}_stream{ltab}",
                        st_launch[k], errs[k]["max_abs_err"], tt, dref[k][1],
                        "the chain scene, the same rays", 2253 if k == "occluded" else 2070))
                del sdp, S_
            rec.update(max_abs_err={k: v["max_abs_err"] for k, v in errs.items()},
                       launches=dl, timing=dt)
            emit(rec)
            del dp, D, Ds

    deep_cases(L)

    # the DEEP tier forced on car_boxed's width-4 tables (a stack depth past
    # the standard tier's), in turns with the standard tier: same hits, and
    # the cost of the global stack
    fkw = dict(leaf_size=L, stack_depth=ct.STACK_SIZE[4] + 1)
    rec = {"phase": "deep", "case": "car_boxed_w4_forced", "card": card,
           "stack_depth": fkw["stack_depth"], "stack_need": T.stack_depth}
    for k, call in (("closest", lambda **k_: ct.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, **k_)),
                    ("frame", lambda **k_: ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr,
                                                          T.lamb, o, d, bounces=cfg.bounces,
                                                          **k_))):
        eq = same_bits(list(call(**fkw)), list(call(**kw)))
        check(f"deep/forced/{k}", eq, "the DEEP tier's output differs from the standard tier's")
        turns = [time_ms(lambda: call(**(fkw if deep else kw)), ARITY_WARMUP, ARITY_TIMED)
                 for deep in (False, True, True, False)]
        std = statistics.median([turns[0]["median"], turns[3]["median"]])
        dpt = statistics.median([turns[1]["median"], turns[2]["median"]])
        rec[k] = {"bit_equal": eq, "turns": turns, "standard_ms": std, "deep_ms": dpt,
                  "deep_vs_standard": dpt / std}
    emit(rec)


    # ---- 14. the MXU leaf (row 12): the main path with the defaults --------
    # prepare with the default config takes the MXU leaf on car_boxed at
    # width 4, as JAX's prepare does (its 88 MiB budget holds the table), so
    # render() launches frame_mxu<4>. Every MXU instance is held against its
    # plain MXU version (ops/trace_plain.*_mxu_plain: every ray against
    # every slot's C rows, the bf16 halves' products as f32 matmuls) and
    # against its FP32 twin. Against the FP32 twin, whose leaf test rounds
    # otherwise, the bounds are those of tests/test_kernel_variants.py
    # (TestMXULeaf): miss agreement > 0.999, idx agreement > 0.99 where
    # both hit, mean relative t error < 2e-4 and max < 2e-2, blocked
    # agreement >= 0.999; frames to tests/test_fused.py's (more than 99% of
    # pixels within 1e-3, median < 1e-5). Against the plain MXU version,
    # which computes the same bf16x3 products, they are set from the sound
    # runs (miss and idx equal, relative t error under 5e-7, blocked equal,
    # 99.998% of frame pixels within 1e-3): miss, idx and blocked agreement
    # >= 0.9999, mean relative t error < 1e-6 and max < 1e-5, and frames
    # without spheres to cmp_frame's 99.99% (with spheres to the 99% the
    # FP32 sphere frames are held to). The tensor cores sum in their own
    # order, so no MXU output is held to the bit, except the four-group
    # table's against the (rows, 32) table's.
    def cmp_hits_mxu(name, hk, hp, full, plain=True):
        if plain:
            ok_miss, ok_idx = (lambda v: v >= 0.9999), (lambda v: v >= 0.9999)
            max_mean, max_rel = 1e-6, 1e-5
        else:
            ok_miss, ok_idx = (lambda v: v > 0.999), (lambda v: v > 0.99)
            max_mean, max_rel = 2e-4, 2e-2
        mk, mp = hk.t >= T_MAX, hp.t >= T_MAX
        miss = (mk == mp).float().mean().item()
        check(name, ok_miss(miss), f"miss agreement {miss}")
        both = ~mk & ~mp
        idx_agree = (hk.idx[both] == hp.idx[both]).float().mean().item()
        check(name, ok_idx(idx_agree), f"idx agreement {idx_agree} where both hit")
        same = both & (hk.idx == hp.idx)
        err = (hk.t[same] - hp.t[same]).abs()
        rel = err / hp.t[same].abs().clamp(min=1e-9)
        rel_mean = rel.mean().item() if rel.numel() else 0.0
        rel_max = rel.max().item() if rel.numel() else 0.0
        check(name, rel_mean < max_mean and rel_max < max_rel,
              f"relative t error mean {rel_mean}, max {rel_max}")
        max_err = err.max().item() if err.numel() else 0.0
        if full:
            for vk, vp in zip((*hk.n, *hk.kd, *hk.ks, *hk.kr),
                              (*hp.n, *hp.kd, *hp.ks, *hp.kr)):
                check(name, torch.equal(vk[same], vp[same]),
                      "attributes differ where idx agrees")
        return {"max_abs_err": max_err, "miss_agree": miss, "idx_agree": idx_agree,
                "rel_t_mean": rel_mean, "rel_t_max": rel_max,
                "hit_frac": both.float().mean().item()}

    t0 = time.perf_counter()
    mcfg = RenderConfig(**MXU_CFG)
    mpipe = prepare_native(mcfg)
    torch.cuda.synchronize()
    M = mpipe.tables
    check("mxu", mpipe.mxu and M.cmat is not None, "the default prepare did not take the MXU leaf")
    check("mxu", all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                     for a, b in zip(M[:5], T[:5])), "its tables are not car_boxed's")
    rec = {"phase": "mxu", "case": "car_boxed_w4", "card": card,
           "prepare_s": time.perf_counter() - t0, "mxu": mpipe.mxu,
           "cmat": list(M.cmat.shape), "cmat_bytes": nbytes(M.cmat),
           "other_table_bytes": nbytes(M.cbox, M.cmeta, M.tri, M.attr)}
    mcmp = {}

    # the band: the plain MXU results (they read no node table)
    y0 = BANDS[0]
    bref = band_ref[y0]
    bo, bd = bref["rays"]["primary"]
    bso, bsd, bm2 = bref["shadow_rays"]
    mplain = {}
    mplain["closest"], mplain["closest_ms"] = timed_once(
        lambda: tp.closest_mxu_plain(M.cmat, M.tri, bo, bd, L))
    mplain["closest_full"], mplain["closest_full_ms"] = timed_once(
        lambda: tp.closest_full_mxu_plain(M.cmat, M.tri, M.attr, bo, bd, L))
    mplain["shadow"] = tp.closest_mxu_plain(M.cmat, M.tri, *bref["rays"]["shadow"], L)
    mplain["occluded"], mplain["occluded_ms"] = timed_once(
        lambda: tp.occluded_mxu_plain(M.cmat, M.tri, bso, bsd, bm2, L))
    mplain["frame"], mplain["frame_ms"] = timed_once(lambda: ct.frame_plain(
        M.tri, M.attr, M.lamb, bo, bd, bounces=cfg.bounces, leaf_size=L, cmat=M.cmat))
    rec["band"] = {"y0": y0, "rays": BAND_ROWS * W,
                   "plain_ms": {k: mplain[k + "_ms"] for k in MXU_TURNS}}

    def mxu_tables(key):
        if key == "w4":
            return mpipe
        p = prepare_native(RenderConfig(**MXU_CFG, **MXU_CASES[key]))
        if key == "w8_bf16":
            p = pair_rows_w8(p)
        check(f"mxu/{key}", p.mxu and p.tables.cmat is not None, "not the MXU leaf")
        return p

    mxu_t, mxu_launch, mxu_err = {}, {}, {}
    for key in MXU_CASES:
        p = mxu_tables(key)
        A = p.tables
        a, sfx = A.arity, ",bf16" if A.compressed else ""
        akw = dict(leaf_size=L, stack_depth=A.stack_depth, compressed=A.compressed)
        errs = {}

        def both(k, res_p, res_f):
            errs[k] = max(errs.get(k, 0.0), res_p["max_abs_err"])
            mcmp.setdefault(key, {}).setdefault(k, []).append(
                {"vs_plain": res_p, "vs_fp32": res_f})

        for kind, (ro, rd) in bref["rays"].items():
            want = mplain["closest"] if kind == "primary" else mplain["shadow"]
            hk = ct.closest_tiles(A.cbox, A.cmeta, A.tri, ro, rd, cmat=A.cmat, **akw)
            hf = ct.closest_tiles(A.cbox, A.cmeta, A.tri, ro, rd, **akw)
            both("closest", cmp_hits_mxu(f"mxu/{key}/closest/{kind}", hk, want, False),
                 cmp_hits_mxu(f"mxu/{key}/closest/{kind}/fp32", hk, hf, False, plain=False))
        hk = ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, bo, bd, cmat=A.cmat, **akw)
        hf = ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, bo, bd, **akw)
        both("closest_full", cmp_hits_mxu(f"mxu/{key}/closest_full", hk, mplain["closest_full"], True),
             cmp_hits_mxu(f"mxu/{key}/closest_full/fp32", hk, hf, True, plain=False))
        bk = ct.occluded_tiles(A.cbox, A.cmeta, A.tri, bso, bsd, bm2, cmat=A.cmat, **akw)
        bf = ct.occluded_tiles(A.cbox, A.cmeta, A.tri, bso, bsd, bm2, **akw)
        both("occluded", cmp_blocked(f"mxu/{key}/occluded", bk, mplain["occluded"], 0.9999),
             cmp_blocked(f"mxu/{key}/occluded/fp32", bk, bf))
        fk = ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, bo, bd,
                            bounces=cfg.bounces, cmat=A.cmat, **akw)
        ff = ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, bo, bd,
                            bounces=cfg.bounces, **akw)
        both("frame", cmp_frame(f"mxu/{key}/frame@{y0}", fk, mplain["frame"]),
             cmp_frame(f"mxu/{key}/frame@{y0}/fp32", fk, ff, 0.99))
        del hk, hf, bk, bf, fk, ff

        # the paths, each with its counts from 0
        pass_counts = {f"closest_full_mxu<{a}{sfx}>": cfg.bounces,
                       f"occluded_mxu<{a}{sfx}>": cfg.bounces * nl}
        check(f"mxu/{key}", p.resolved_variant() == "fused", "auto is not the fused frame")
        pimg, on_f = on_path(f"mxu/{key}/render_fused", p.render, {f"frame_mxu<{a}{sfx}>": 1})
        pimg_pass, on_p = on_path(f"mxu/{key}/render_pass_based",
                                  lambda: p.render(variant="pallas"), pass_counts)
        _, on_c = on_path(f"mxu/{key}/primary_closest_pass",
                          lambda: ct.closest_tiles(A.cbox, A.cmeta, A.tri, o, d, cmat=A.cmat,
                                                   **akw),
                          {f"closest_mxu<{a}{sfx}>": 1})
        mxu_launch[key] = {"frame": on_f[f"frame_mxu<{a}{sfx}>"],
                           "closest_full": on_p[f"closest_full_mxu<{a}{sfx}>"],
                           "occluded": on_p[f"occluded_mxu<{a}{sfx}>"],
                           "closest": on_c[f"closest_mxu<{a}{sfx}>"]}
        res = {"reference_image": hold_reference(f"car_boxed_1080p_mxu_{key}", pimg),
               "fused_vs_pass": hold_frames(f"mxu/{key}/fused_vs_pass", pimg, pimg_pass),
               "vs_fp32_fused": hold_frames(f"mxu/{key}/vs_fp32_fused", pimg,
                                            img if key == "w4" else frames.get(key, img), 0.99)}
        if key == "w4":
            mimg = pimg
        del pimg_pass

        # timing: each MXU instance at the main path's shapes; the listed
        # kernels in turns with their FP32 twins (FP32, MXU, MXU, FP32)
        runs, runs_m = kernel_runs(A), kernel_runs(A, cmat=A.cmat)
        tm = {}
        for k in MXU_TURNS:
            fn_f = runs[k][0]
            fn_m, counted, in_b, out_b = runs_m[k]
            if key in ("w4", "w8") and (key == "w4" or k == "frame"):
                turns = [time_ms(fn_m if i in (1, 2) else fn_f, ARITY_WARMUP, ARITY_TIMED) for i in range(4)]
                t_m = dict(turns[1], median=statistics.median(
                    [turns[1]["median"], turns[2]["median"]]))
                fp32_ms = statistics.median([turns[0]["median"], turns[3]["median"]])
            else:
                t_m, fp32_ms, turns = time_ms(fn_m, ARITY_WARMUP, ARITY_TIMED), None, None
            b = bound(counted().cpu().tolist(), count_names(k, True), in_b, out_b)
            tm[k] = dict(t_m, rays=n_rays, fp32_ms=fp32_ms, turns=turns,
                         vs_fp32=t_m["median"] / fp32_ms if fp32_ms else None, **b)
        # each MXU pass instance's lanes served an mma batch, batches a ray
        # and warp leaf steps a ray (the while-while loop's leaf steps)
        res["mxu_pass_steps"] = {k: {x: tm[k].get(x) for x in MXU_STEP_SHARES}
                                 for k in MXU_TURNS if k != "frame"}
        # lanes served per mma batch at bounce 0 (a 1-bounce frame) and
        # over the whole frame
        c1 = dict(zip(ct.MXU_COUNTS, ct.frame_tiles(
            A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d, bounces=1, cmat=A.cmat,
            counters=True, **akw)[1].cpu().tolist()))
        res["lanes_per_batch"] = {"bounce0": c1["lanes_served"] / max(c1["mma_batches"], 1),
                                  "frame": tm["frame"]["lanes_per_batch"]}
        if key == "w4":   # render() of the defaults and of mxu_leaf=False, in turns
            for variant in ("fused", "pallas"):
                turns = [time_ms(lambda: (mpipe if i in (1, 2) else pipe).render(variant=variant),
                                 ARITY_WARMUP, ARITY_TIMED) for i in range(4)]
                res[f"render_{variant}_end_to_end"] = {
                    "mxu_ms": statistics.median([turns[1]["median"], turns[2]["median"]]),
                    "fp32_ms": statistics.median([turns[0]["median"], turns[3]["median"]]),
                    "turns": turns}
        mxu_t[key], mxu_err[key] = tm, errs
        emit({"phase": "mxu", "case": key, "card": card, "launches": mxu_launch[key],
              "max_abs_err": errs, "compare": mcmp[key], "timing": tm, **res})
        if key != "w4":
            del p, A

    # the four-group table (pack_cmi4): the same outputs bit for bit
    f32_cmat = pack_bvh4(mpipe.flat, mpipe.scene.triangle_vertices()).cmat
    check("mxu/cmi4", np.array_equal(split_cmat(f32_cmat).view(np.int16),
                                     M.cmat.view(torch.int16).cpu().numpy()),
          "the uploaded table is not split_cmat of the packer's")
    c4 = torch.as_tensor(pack_cmi4(f32_cmat, L).view(np.int16),
                         device=mpipe.device).view(torch.bfloat16)
    mkw = dict(leaf_size=L, stack_depth=M.stack_depth)
    cmi4 = {}
    for k, fn in (("closest_full", lambda c: planes(ct.closest_tiles_full(
                      M.cbox, M.cmeta, M.tri, M.attr, o, d, cmat=c, **mkw), True)),
                  ("occluded", lambda c: [ct.occluded_tiles(M.cbox, M.cmeta, M.tri, so, sd, m2,
                                                            cmat=c, **mkw)]),
                  ("frame", lambda c: list(ct.frame_tiles(M.cbox, M.cmeta, M.tri, M.attr, M.lamb,
                                                          o, d, bounces=cfg.bounces, cmat=c,
                                                          **mkw)))):
        cmi4[k] = same_bits(fn(c4), fn(M.cmat))
        check(f"mxu/cmi4/{k}", cmi4[k], "the four-group table's outputs differ")
    emit({"phase": "mxu", "case": "cmi4", "cmat4": list(c4.shape), "bit_equal": cmi4})
    del c4

    # frame_sph_mxu<4>: car_boxed_spheres with the defaults
    ssc = with_spheres(load_scene_npz(os.path.join(HERE, "assets", "car_boxed.npz")))
    sp = prepare_native(mcfg, scene=ssc)
    S_ = sp.tables
    check("mxu/spheres", sp.mxu and S_.sph is not None, "not the MXU sphere tables")
    sph_mxu_plain, sph_mxu_plain_ms = timed_once(lambda: ct.frame_plain(
        S_.tri, S_.attr, S_.lamb, bo, bd, bounces=cfg.bounces, leaf_size=L, sph=S_.sph,
        cmat=S_.cmat))
    skw = dict(leaf_size=L, stack_depth=S_.stack_depth)
    sres = {"band": cmp_frame("mxu/spheres/frame_sph", ct.frame_tiles(
        S_.cbox, S_.cmeta, S_.tri, S_.attr, S_.lamb, bo, bd, bounces=cfg.bounces,
        sph=S_.sph, cmat=S_.cmat, **skw), sph_mxu_plain, 0.99)}
    simg, on_s = on_path("mxu/spheres/render_fused", sp.render, {"frame_sph_mxu<4>": 1})
    simg_pass, _ = on_path("mxu/spheres/render_pass_based", lambda: sp.render(variant="pallas"),
                           {"closest_full_mxu<4>": cfg.bounces, "occluded_mxu<4>": cfg.bounces * nl})
    sres["fused_vs_pass"] = hold_frames("mxu/spheres/fused_vs_pass", simg, simg_pass, 0.99)
    del simg, simg_pass
    fn_s = lambda c=False: ct.frame_tiles(S_.cbox, S_.cmeta, S_.tri, S_.attr, S_.lamb, o, d,
                                          bounces=cfg.bounces, sph=S_.sph, cmat=S_.cmat,
                                          counters=c, **skw)
    ts = time_ms(fn_s, ARITY_WARMUP, ARITY_TIMED)
    ts.update(bound(fn_s(True)[1].cpu().tolist(), ct.MXU_COUNTS,
                    ray_b + nbytes(S_.cbox, S_.cmeta, S_.lamb, S_.sph, S_.cmat)
                    + leaf_bytes(S_, attr=True),
                    3 * out_plane, spheres=S_.sph.shape[0]))
    emit({"phase": "mxu", "case": "car_boxed_spheres", "card": card,
          "plain_ms": sph_mxu_plain_ms,
          "launches": on_s["frame_sph_mxu<4>"], "timing": ts, **sres})
    extra_rows.append(dict(row("frame_kernel<4, SPH, MXU>", "w4+spheres, mxu",
                               on_s["frame_sph_mxu<4>"], sres["band"]["max_abs_err"], ts,
                               sph_mxu_plain_ms,
                               f"one {BAND_ROWS}-row band (y {y0}), the same rays",
                               MXU_LINES["frame_sph"])))
    del sp, S_

    # the DEEP MXU instances on the chain scene, against their plain versions
    def mxu_deep_cases(leaf):
        """The DEEP MXU instances of leaf size `leaf` on the chain scene (the
        tables of MXU_CASES), against their plain versions, through their
        paths with the counts from 0, timed; rows to extra_rows."""
        tag, lname, ltab = (",l4", ", L=4", "_l4") if leaf == 4 else ("", "", "")
        dref_m = {}
        for key in MXU_CASES:
            dp = prepare_native(RenderConfig(**dict(DEEP_CFG, mxu_leaf=True), leaf_size=leaf,
                                             **MXU_CASES[key]), scene=chain)
            if key == "w8_bf16":
                dp = pair_rows_w8(dp)
            D = dp.tables
            a, sfx = D.arity, ",bf16" if D.compressed else ""
            check(f"mxu/deep{ltab}/{key}", dp.mxu and ct.use_deep_tier(D.stack_depth, a)
                  and D.leaf_size == leaf, "not the DEEP MXU instances")
            dkw = dict(leaf_size=leaf, stack_depth=D.stack_depth, compressed=D.compressed)
            if not dref_m:
                hp, ms_cf = timed_once(lambda: tp.closest_full_mxu_plain(
                    D.cmat, D.tri, D.attr, o, d, leaf))
                dso_m, dsd_m, dm2_m = shadow_rays(o, d, hp, D.lamb)
                dref_m.update({
                    "closest_full": (hp, ms_cf), "shadow": (dso_m, dsd_m, dm2_m),
                    "closest": timed_once(lambda: tp.closest_mxu_plain(D.cmat, D.tri, o, d, leaf)),
                    "occluded": timed_once(lambda: tp.occluded_mxu_plain(
                        D.cmat, D.tri, dso_m, dsd_m, dm2_m, leaf)),
                    "frame": timed_once(lambda: ct.frame_plain(
                        D.tri, D.attr, D.lamb, o, d, bounces=1, leaf_size=leaf, cmat=D.cmat)),
                    "frame_sph": timed_once(lambda: ct.frame_plain(
                        D.tri, D.attr, D.lamb, o, d, bounces=1, leaf_size=leaf, sph=dsph,
                        cmat=D.cmat))})
            dso_m, dsd_m, dm2_m = dref_m["shadow"]
            Ds = D._replace(sph=dsph)
            calls = {
                "closest": lambda c=False: ct.closest_tiles(D.cbox, D.cmeta, D.tri, o, d,
                                                            cmat=D.cmat, counters=c, **dkw),
                "closest_full": lambda c=False: ct.closest_tiles_full(
                    D.cbox, D.cmeta, D.tri, D.attr, o, d, cmat=D.cmat, counters=c, **dkw),
                "occluded": lambda c=False: ct.occluded_tiles(D.cbox, D.cmeta, D.tri, dso_m, dsd_m,
                                                              dm2_m, cmat=D.cmat, counters=c, **dkw),
                "frame": lambda c=False: ct.frame_tiles(D.cbox, D.cmeta, D.tri, D.attr, D.lamb, o, d,
                                                        bounces=1, cmat=D.cmat, counters=c, **dkw),
                "frame_sph": lambda c=False: ct.frame_tiles(D.cbox, D.cmeta, D.tri, D.attr, D.lamb,
                                                            o, d, bounces=1, sph=dsph, cmat=D.cmat,
                                                            counters=c, **dkw)}
            errs = {"closest": cmp_hits_mxu(f"mxu/deep{ltab}/{key}/closest", calls["closest"](),
                                            dref_m["closest"][0], False),
                    "closest_full": cmp_hits_mxu(f"mxu/deep{ltab}/{key}/closest_full",
                                                 calls["closest_full"](), dref_m["closest_full"][0],
                                                 True),
                    "occluded": cmp_blocked(f"mxu/deep{ltab}/{key}/occluded", calls["occluded"](),
                                            dref_m["occluded"][0], 0.9999),
                    "frame": cmp_frame(f"mxu/deep{ltab}/{key}/frame", calls["frame"](),
                                       dref_m["frame"][0]),
                    "frame_sph": cmp_frame(f"mxu/deep{ltab}/{key}/frame_sph", calls["frame_sph"](),
                                           dref_m["frame_sph"][0], 0.99)}
            dl = {}
            _, on_a = on_path(f"mxu/deep{ltab}/{key}/render_auto", dp.render,
                              {f"frame_mxu<{a}{sfx},deep{tag}>": 1})
            _, on_s2 = on_path(f"mxu/deep{ltab}/{key}/render_fused_spheres",
                               dataclasses.replace(dp, tables=Ds).render,
                               {f"frame_sph_mxu<{a}{sfx},deep{tag}>": 1})
            _, on_p = on_path(f"mxu/deep{ltab}/{key}/render_pass_based", lambda: dp.render(variant="pallas"),
                              {f"closest_full_mxu<{a}{sfx},deep{tag}>": 1, f"occluded_mxu<{a}{sfx},deep{tag}>": 1})
            _, on_c = on_path(f"mxu/deep{ltab}/{key}/primary_closest_pass", calls["closest"],
                              {f"closest_mxu<{a}{sfx},deep{tag}>": 1})
            dl = {"frame": on_a[f"frame_mxu<{a}{sfx},deep{tag}>"],
                  "frame_sph": on_s2[f"frame_sph_mxu<{a}{sfx},deep{tag}>"],
                  "closest_full": on_p[f"closest_full_mxu<{a}{sfx},deep{tag}>"],
                  "occluded": on_p[f"occluded_mxu<{a}{sfx},deep{tag}>"],
                  "closest": on_c[f"closest_mxu<{a}{sfx},deep{tag}>"]}
            dt = {}
            bn = box_name(D)
            for k, fn in calls.items():
                tt = time_ms(fn, ARITY_WARMUP, ARITY_TIMED)
                with_attr = k.startswith("frame") or k == "closest_full"
                in_b = (ray_b + nbytes(D.cbox, D.cmeta, D.cmat) + leaf_bytes(D, attr=with_attr)
                        + (nbytes(D.lamb) if k.startswith("frame") else 0)
                        + (out_plane if k == "occluded" else 0))
                out_n = {"closest": 3, "closest_full": 15, "occluded": 1, "frame": 3, "frame_sph": 3}[k]
                tt.update(bound(fn(True)[1].cpu().tolist(), count_names(k, True), in_b,
                                out_n * out_plane,
                                spheres=dsph.shape[0] if k == "frame_sph" else 0,
                                leaf=D.leaf_size))
                dt[k] = tt
                name = {"closest": f"closest_kernel<{a}{bn}, false, DEEP, MXU{lname}>",
                        "closest_full": f"closest_kernel<{a}{bn}, true, DEEP, MXU{lname}>",
                        "occluded": f"occluded_kernel<{a}{bn}, DEEP, MXU{lname}>",
                        "frame": f"frame_kernel<{a}{bn}, DEEP, MXU{lname}>",
                        "frame_sph": f"frame_kernel<{a}{bn}, SPH, DEEP, MXU{lname}>"}[k]
                extra_rows.append(row(name, f"deep_{key}{ltab}, mxu", dl[k],
                                      errs[k]["max_abs_err"], tt,
                                      dref_m[k][1], "the chain scene, the same rays", MXU_LINES[k]))
            emit({"phase": "mxu", "case": f"deep_{key}{ltab}", "leaf_size": leaf, "card": card,
                  "stack_need": D.stack_depth,
                  "launches": dl, "max_abs_err": {k: v["max_abs_err"] for k, v in errs.items()},
                  "compare": errs, "timing": dt})
            del dp, D, Ds

    mxu_deep_cases(L)

    # registers and spills of the MXU instances (ptxas, from the build log)
    emit({"phase": "mxu", "case": "ptxas",
          "instances": {k: v for k, v in ptxas_table.items() if entry_mxu(k)}})
    for key in MXU_CASES:
        for k in MXU_TURNS:
            t = mxu_t[key][k]
            bn = {"w4": "", "w8": "", "w4_bf16": ", PAIRS", "w8_bf16": ", PAIRS"}[key]
            a = 8 if key.startswith("w8") else 4
            name = {"closest": f"closest_kernel<{a}{bn}, false, MXU>",
                    "closest_full": f"closest_kernel<{a}{bn}, true, MXU>",
                    "occluded": f"occluded_kernel<{a}{bn}, MXU>",
                    "frame": f"frame_kernel<{a}{bn}, MXU>"}[k]
            extra_rows.append(row(name, f"{key}, mxu", mxu_launch[key][k], mxu_err[key][k], t,
                                  mplain[k + "_ms"],
                                  f"one {BAND_ROWS}-row band (y {y0}) of the same rays "
                                  "(the plain MXU version reads no node table)", MXU_LINES[k]))
    # ---- 15. leaf size 4: every traversal kernel at L = 4 --------------------
    # prepare(leaf_size=4) packs 4 triangles a leaf group (the same binary
    # tree: each leaf of up to 8 triangles becomes groups of 4), and every
    # launch takes the L = 4 instances (keys "...,l4>"). Per table (L4_CASES:
    # the main path's MXU frame, the FP32 leaf, widths 2, 4 and 8, bf16 boxes,
    # the MXU leaf on each width-4 and width-8 table), each L = 4 kernel is
    # held against its plain version on one band with the bounds of the
    # L = 8 phases: the hits against the plain L = 4 hits (slots g * 4 + j;
    # MXU: the plain MXU versions), the frames against the band's L = 8
    # plain frames (a frame does not depend on how slots are grouped, and
    # the plain versions test every slot whatever L is). The plain L = 4
    # hits are also the plain L = 8 hits, triangle for triangle through the
    # slot maps. Each table's paths run with the counts from 0; its 1080p
    # frame is held against phase 7's plain frame on the tile spread (the
    # FP32 leaf to cmp_frame's bound, the MXU leaf to the 99% of
    # tests/test_fused.py, JAX's L = 4 against L = 8 bound), its L = 8
    # twin's frame and the
    # reference BMP; its kernels are timed (the main path's frames in turns
    # with their L = 8 twins), with leaf visits and triangle tests per ray.
    # Then the streamed instances on the padded L = 4 tables, the sphere
    # frames on car_boxed_spheres, and the DEEP instances on the chain scene.
    t0 = time.perf_counter()
    L4 = 4
    y4 = BANDS[0]
    bref4 = band_ref[y4]
    b4o, b4d = bref4["rays"]["primary"]
    b4so, b4sd, b4m2 = bref4["shadow_rays"]
    l4_t, l4_tables = {}, {}

    def tri_ids(h, flat):
        """A hit's triangle ids (slot_map of its slots), -1 on a miss."""
        sm = torch.as_tensor(flat.slot_map, device=h.idx.device).long()
        return torch.where(h.idx >= 0, sm[h.idx.long().clamp(min=0)], -1)

    def leaf_streamed(phase, name, key, p, A, leaf, refs):
        """The streamed instances of tables A (the FP32 leaf, arity 4 or 8)
        at leaf size `leaf`: bit for bit against the resident twin and
        against the plain hits `refs` on the band of y4, through a streamed
        pipeline's paths with the counts from 0, timed with their work;
        emits the record, returns the kernels-line rows."""
        lt, lname = ct._leaf_tag(leaf), f", L={leaf}"
        a, sfx, bn = A.arity, ",bf16" if A.compressed else "", box_name(A)
        sp = streamed(dataclasses.replace(p, tables=A))
        S = sp.tables
        skw = dict(leaf_size=leaf, stack_depth=S.stack_depth, compressed=S.compressed)
        scalls = {"closest": lambda s_, ro=b4o, rd=b4d, **x: ct.closest_tiles(
                      S.cbox, S.cmeta, S.tri, ro, rd, stream=s_, **skw, **x),
                  "closest_full": lambda s_, ro=b4o, rd=b4d, **x: ct.closest_tiles_full(
                      S.cbox, S.cmeta, S.tri, S.attr, ro, rd, stream=s_, **skw, **x),
                  "occluded": lambda s_, ro=b4so, rd=b4sd, m=b4m2, **x: ct.occluded_tiles(
                      S.cbox, S.cmeta, S.tri, ro, rd, m, stream=s_, **skw, **x)}
        serr = {}
        for k, fn in scalls.items():
            hs = fn(True)
            outs = ((lambda h: [h]) if k == "occluded"
                    else (lambda h: planes(h, k == "closest_full")))
            check(f"{name}/{k}_stream", same_bits(outs(hs), outs(fn(False))),
                  "differs from the resident twin")
            serr[k] = (cmp_blocked(f"{name}/{k}_stream@{y4}", hs, refs["occluded"][0])
                       if k == "occluded" else
                       cmp_hits(f"{name}/{k}_stream@{y4}", hs, refs[k][0],
                                k == "closest_full"))["max_abs_err"]
        _, on_s = on_path(f"{name}/stream_render_auto", sp.render,
                          {f"closest_full_stream<{a}{sfx}{lt}>": cfg.bounces,
                           f"occluded_stream<{a}{sfx}{lt}>": cfg.bounces * nl})
        _, on_sc = on_path(f"{name}/stream_primary_closest_pass",
                           lambda: scalls["closest"](True, o, d),
                           {f"closest_stream<{a}{sfx}{lt}>": 1})
        slaunch = {"closest": on_sc[f"closest_stream<{a}{sfx}{lt}>"],
                   "closest_full": on_s[f"closest_full_stream<{a}{sfx}{lt}>"],
                   "occluded": on_s[f"occluded_stream<{a}{sfx}{lt}>"]}
        st, rows = {}, []
        for k, rays in (("closest", (o, d)), ("closest_full", (o, d)),
                        ("occluded", (so, sd, m2))):
            fn = scalls[k]
            t = time_ms(lambda: fn(True, *rays), 2, 5)
            in_b = (ray_b + nbytes(S.cbox, S.cmeta) + leaf_bytes(S, attr=k == "closest_full")
                    + (out_plane if k == "occluded" else 0))
            t.update(bound(fn(True, *rays, counters=True)[1].cpu().tolist(),
                           ct.STREAM_COUNTS, in_b,
                           {"closest": 3, "closest_full": 15, "occluded": 1}[k] * out_plane))
            t["fills_per_leaf"] = t["block_fills"] / max(t["leaf_visits"], 1)
            st[k] = t
            kname = {"closest": f"closest_kernel<{a}{bn}, false, STREAM{lname}>",
                     "closest_full": f"closest_kernel<{a}{bn}, true, STREAM{lname}>",
                     "occluded": f"occluded_kernel<{a}{bn}, STREAM{lname}>"}[k]
            rows.append(row(kname, f"{key}{lname}, streamed", slaunch[k], serr[k], t,
                            refs[k][1], f"one {BAND_ROWS}-row band (y {y4}), the same rays",
                            2253 if k == "occluded" else 2070))
        emit({"phase": phase, "leaf_size": leaf, "case": f"{key}_stream", "card": card,
              "tri_rows": [A.tri.shape[0], S.tri.shape[0]], "max_abs_err": serr,
              "launches": slaunch, "timing": st, "count_meaning": STREAM_COUNT_MEANING})
        return rows

    def leaf_spheres(phase, name, key, p, A, leaf, mxu=False):
        """The sphere frame of tables A at leaf size `leaf` with
        car_boxed_spheres' sphere table (car_boxed's triangles, so the
        tables take it as it is) against the spheres phase's plain sphere
        frame on its band (MXU: the mxu phase's, on the band of y4), its
        fused render() with the counts from 0, timed; emits the record,
        returns the kernels-line row."""
        a, bn = A.arity, box_name(A)
        sfx, mode = ",bf16" if A.compressed else "", "_mxu" if mxu else ""
        y_s = y4 if mxu else SPHERE_BAND
        ref_s, ms_s = (sph_mxu_plain, sph_mxu_plain_ms) if mxu else (sph_fp, sph_plain_ms)
        As = A._replace(sph=sph)
        akw = dict(leaf_size=leaf, stack_depth=A.stack_depth, compressed=A.compressed,
                   cmat=A.cmat)
        es = cmp_frame(f"{name}/frame_sph", ct.frame_tiles(
            As.cbox, As.cmeta, As.tri, As.attr, As.lamb, band(o, y_s), band(d, y_s),
            bounces=cfg.bounces, sph=sph, **akw), ref_s, 0.99)
        ks = f"frame_sph{mode}<{a}{sfx}{ct._leaf_tag(leaf)}>"
        _, on_f = on_path(f"{name}/render_fused_spheres",
                          dataclasses.replace(p, tables=As).render, {ks: 1})
        ts = time_one(As, "frame_sph", cmat=A.cmat)
        emit({"phase": phase, "leaf_size": leaf, "case": f"{key}_spheres", "card": card,
              "max_abs_err": es["max_abs_err"], "compare": es, "launches": on_f[ks],
              "timing": ts})
        return [row(f"frame_kernel<{a}{bn}, SPH{', MXU' if mxu else ''}, L={leaf}>",
                    f"{key}+spheres, L={leaf}", on_f[ks], es["max_abs_err"], ts, ms_s,
                    f"one {BAND_ROWS}-row band (y {y_s}), the same rays", 2536)]

    def leaf_case(phase, name, key, p, A, refs, twins, mxu=False, hits=None, l8=None,
                  save=False, note=""):
        """Tables A of pipeline p at leaf size A.leaf_size, against the plain
        results `refs` (hits, blocked and frame on the band of y4, each with
        its plain ms): each kernel on the band (hits by `hits`, by default
        cmp_hits, MXU cmp_hits_mxu), the paths with the counts from 0, the
        1080p frame against phase 7's plain frame on its tile spread, the
        pass-based frame, each of `twins` ((tag, L = 8 frame) pairs) and the
        reference BMP (saved with `save`), and each kernel timed at the
        main path's shapes with its work per ray (the frame in turns with
        the frame of tables `l8`: 8, L, L, 8). Emits the record; returns the
        frame, the timings and the kernels-line rows."""
        L, a = A.leaf_size, A.arity
        lt = ct._leaf_tag(L)
        sfx = ",bf16" if A.compressed or A.cbox.dtype == torch.bfloat16 else ""
        mode = "_mxu" if mxu else ""
        akw = dict(leaf_size=L, stack_depth=A.stack_depth, compressed=A.compressed, cmat=A.cmat)
        hits = hits or (cmp_hits_mxu if mxu else cmp_hits)
        res = {}
        for kind, (ro, rd) in bref4["rays"].items():
            res[f"closest_{kind}"] = hits(
                f"{name}/closest/{kind}@{y4}", ct.closest_tiles(A.cbox, A.cmeta, A.tri, ro, rd, **akw),
                refs["closest" if kind == "primary" else "shadow"][0], False)
        res["closest_full"] = hits(
            f"{name}/closest_full@{y4}",
            ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, b4o, b4d, **akw),
            refs["closest_full"][0], True)
        res["occluded"] = cmp_blocked(
            f"{name}/occluded@{y4}", ct.occluded_tiles(A.cbox, A.cmeta, A.tri, b4so, b4sd, b4m2,
                                                       **akw),
            refs["occluded"][0], 0.9999 if mxu else 0.999)
        errs = {"closest": max(res["closest_primary"]["max_abs_err"],
                               res["closest_shadow"]["max_abs_err"]),
                "closest_full": res["closest_full"]["max_abs_err"],
                "occluded": res["occluded"]["max_abs_err"]}
        if a >= 4:
            res["frame"] = cmp_frame(f"{name}/frame@{y4}", ct.frame_tiles(
                A.cbox, A.cmeta, A.tri, A.attr, A.lamb, b4o, b4d, bounces=cfg.bounces, **akw),
                refs["frame"][0])
            errs["frame"] = res["frame"]["max_abs_err"]

        # the paths, each with its counts from 0
        pass_counts = {f"closest_full{mode}<{a}{sfx}{lt}>": cfg.bounces,
                       f"occluded{mode}<{a}{sfx}{lt}>": cfg.bounces * nl}
        auto = p.resolved_variant()
        check(name, auto == ("fused" if a >= 4 else "pallas"), f"auto -> {auto}")
        frame_key = f"frame{mode}<{a}{sfx}{lt}>"
        pimg, on_a = on_path(f"{name}/render_auto", p.render,
                             {frame_key: 1} if a >= 4 else pass_counts)
        if a >= 4:
            pimg_pass, on_p = on_path(f"{name}/render_pass_based",
                                      lambda: p.render(variant="pallas"), pass_counts)
        else:
            pimg_pass, on_p = pimg, on_a
        _, on_c = on_path(f"{name}/primary_closest_pass",
                          lambda: ct.closest_tiles(A.cbox, A.cmeta, A.tri, o, d, **akw),
                          {f"closest{mode}<{a}{sfx}{lt}>": 1})
        launch = {"closest": on_c[f"closest{mode}<{a}{sfx}{lt}>"],
                  "closest_full": on_p[f"closest_full{mode}<{a}{sfx}{lt}>"],
                  "occluded": on_p[f"occluded{mode}<{a}{sfx}{lt}>"]}
        # the whole frame: phase 7's plain frame, the L = 8 twins, the reference
        if a >= 4:
            launch["frame"] = on_a[frame_key]
            fk = ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d,
                                bounces=cfg.bounces, **akw)
            res["frame_vs_plain_frame"] = cmp_frame(f"{name}/frame/frame", spread(fk),
                                                    plain["frame"], 0.99 if mxu else 0.9999)
            errs["frame"] = max(errs["frame"], res["frame_vs_plain_frame"]["max_abs_err"])
            del fk
            res["pass_based_vs_fused"] = hold_frames(f"{name}/fused_vs_pass", pimg, pimg_pass,
                                                     0.99 if mxu else 0.9999)
        del pimg_pass
        for tag, twin_img in twins:
            res[f"vs_l8_{tag}"] = hold_frames(f"{name}/vs_l8_{tag}", pimg, twin_img, 0.99)
        res["reference_image"] = hold_reference(f"car_boxed_1080p_l{L}_{key}", pimg, save=save)

        # timing: each kernel at the main path's shapes, with its work per ray
        tm = {}
        for k, (fn, counted, in_b, out_b) in kernel_runs(A, cmat=A.cmat).items():
            b = bound(counted().cpu().tolist(), count_names(k, mxu), in_b, out_b, leaf=L)
            if k == "frame" and l8 is not None:
                fn8, counted8, _, _ = kernel_runs(l8, cmat=l8.cmat)[k]
                turns = [time_ms(fn if i in (1, 2) else fn8) for i in range(4)]
                t = dict(turns[1], median=statistics.median([turns[1]["median"],
                                                             turns[2]["median"]]))
                c8 = dict(zip(names, counted8().cpu().tolist()))
                l8_ms = statistics.median([turns[0]["median"], turns[3]["median"]])
                t.update(turns=turns, l8_ms=l8_ms, vs_l8=t["median"] / l8_ms,
                         l8_leaf_visits_per_ray=c8["leaf_visits"] / n_rays,
                         l8_tri_tests_per_ray=c8["tri_tests"] / n_rays,
                         l8_inner_visits_per_ray=c8["inner_visits"] / n_rays)
            else:
                t = time_ms(fn) if k == "frame" else time_ms(fn, 2, 5)
            tm[k] = dict(t, rays=n_rays, leaf_visits_per_ray=b["leaf_visits"] / n_rays,
                         tri_tests_per_ray=b["tri_tests"] / n_rays,
                         inner_visits_per_ray=b["inner_visits"] / n_rays, **b)
        emit({"phase": phase, "leaf_size": L, "case": key, "card": card, "mxu": mxu,
              "cbox": list(A.cbox.shape), "tri": list(A.tri.shape),
              "cmat": None if A.cmat is None else list(A.cmat.shape),
              "stack_need": A.stack_depth, "builder": p.builder,
              "leaf_threshold": p.cfg.leaf_threshold, "compare": res, "max_abs_err": errs,
              "launches": launch, "timing": tm,
              "plain_vs_l8_same_triangle": refs["vs_l8_same_triangle"]})
        bn, mname = box_name(A), ", MXU" if mxu else ""
        rows = []
        for k, t in tm.items():
            kname = {"closest": f"closest_kernel<{a}{bn}, false{mname}, L={L}>",
                     "closest_full": f"closest_kernel<{a}{bn}, true{mname}, L={L}>",
                     "occluded": f"occluded_kernel<{a}{bn}{mname}, L={L}>",
                     "frame": f"frame_kernel<{a}{bn}{mname}, L={L}>"}[k]
            line = (MXU_LINES[k] if mxu else
                    {"closest": 610 if a == 2 else 1774, "closest_full": 2437 if a == 2 else 1774,
                     "occluded": 676 if a == 2 else 1835, "frame": 2536}[k])
            rows.append(row(kname, f"{key}, L={L}", launch[k], errs[k], t, refs[k][1],
                            f"one {BAND_ROWS}-row band (y {y4}), the same rays{note}", line))
        return pimg, tm, rows

    p4 = {}      # the plain L = 4 hits on the band, FP32 and MXU
    for key, (mxu, extra) in L4_CASES.items():
        p = prepare_native(RenderConfig(**(MXU_CFG if mxu else CFG), leaf_size=L4,
                                        leaf_threshold=L4_LEAF_THRESHOLD, **extra))
        if extra.get("bvh_width") == 8 and extra.get("bf16_bvh"):
            p = pair_rows_w8(p)
        A = p.tables
        a = A.arity
        bf = A.compressed or A.cbox.dtype == torch.bfloat16
        name = f"leaf4/{key}"
        check(name, p.leaf_size == A.leaf_size == L4 and p.mxu == mxu
              and (A.cmat is not None) == mxu and a == extra.get("bvh_width", 4)
              and bf == bool(extra.get("bf16_bvh")), "not this case's L = 4 tables")
        check(name, not bool(A.tri[:, 12 * L4:].any()), "tri rows hold more than 4 triangles")
        if "fp32" not in p4:
            # the plain L = 4 hits on the band (the first table's rows; every
            # table of the phase has the same slots and rows, checked below)
            first = p
            p4["fp32"] = {
                "closest": timed_once(lambda: tp.closest_plain(A.tri, b4o, b4d, L4)),
                "closest_full": timed_once(lambda: tp.closest_full_plain(
                    A.tri, A.attr, b4o, b4d, L4)),
                "shadow": (tp.closest_plain(A.tri, *bref4["rays"]["shadow"], L4), None),
                "occluded": timed_once(lambda: tp.occluded_plain(A.tri, b4so, b4sd, b4m2, L4)),
                "frame": (bref4["frame"], cmp["frame"]["band_plain_ms"])}
            h4, h8 = p4["fp32"]["closest"][0], bref4["closest", "primary"]
            same_tri = (tri_ids(h4, p.flat) == tri_ids(h8, pipe.flat)).float().mean().item()
            check("leaf4/plain", torch.equal(h4.t, h8.t) and same_tri >= 0.999,
                  f"the plain L = 4 hits are not the L = 8 hits (triangles {same_tri})")
            p4["fp32"]["vs_l8_same_triangle"] = same_tri
        # the same slots and rows as the first table (width 2 keeps the native
        # builder's own rows, whose normals round otherwise: held on the
        # first table's rows, as the arity phase holds width 2)
        F = first.tables
        normals = (torch.arange(A.tri.shape[1], device=A.tri.device) % 12) >= 9
        check(name, np.array_equal(p.flat.slot_map, first.flat.slot_map)
              and torch.equal(A.attr, F.attr)
              and not bool((A.tri - F.tri).abs()[:, ~normals].any()),
              "slots, attr or tri beyond the normals differ from the first L = 4 table")
        A = A._replace(tri=F.tri)
        if mxu and "mxu" not in p4:
            p4["mxu"] = {
                "closest": timed_once(lambda: tp.closest_mxu_plain(A.cmat, A.tri, b4o, b4d, L4)),
                "closest_full": timed_once(lambda: tp.closest_full_mxu_plain(
                    A.cmat, A.tri, A.attr, b4o, b4d, L4)),
                "shadow": (tp.closest_mxu_plain(A.cmat, A.tri, *bref4["rays"]["shadow"], L4),
                           None),
                "occluded": timed_once(lambda: tp.occluded_mxu_plain(
                    A.cmat, A.tri, b4so, b4sd, b4m2, L4)),
                "frame": (mplain["frame"], mplain["frame_ms"]),
                "vs_l8_same_triangle": p4["fp32"]["vs_l8_same_triangle"]}
            mcmat4 = A.cmat
        if mxu:
            check(name, torch.equal(A.cmat.view(torch.int16), mcmat4.view(torch.int16)),
                  "its C-matrix table is not the first MXU table's")
        refs = p4["mxu" if mxu else "fp32"]
        twin = key.replace("_mxu", "")
        twins = [(twin, img if twin == "w4" else frames[twin])]
        if key == "w4_mxu":
            twins.append(("mxu", mimg))
        pimg, l4_t[key], rows = leaf_case(
            "leaf4", name, key, p, A, refs, twins, mxu=mxu,
            l8=(M if mxu else T) if key in ("w4", "w4_mxu") else None, save=key == "w4_mxu")
        extra_rows += rows
        if key in ("w4", "w4_mxu"):
            l4_tables[key] = (p, A, pimg)
        del pimg

        if not mxu and a >= 4:
            extra_rows += leaf_streamed("leaf4", name, key, p, A, L4, refs)
        if a >= 4 and (not mxu or key == "w4_mxu"):
            extra_rows += leaf_spheres("leaf4", name, key, p, A, L4, mxu)
        del p, A
    emit({"phase": "leaf4", "case": "summary", "seconds": time.perf_counter() - t0,
          "frame_l4_vs_l8": {k: {kk: l4_t[k]["frame"].get(kk) for kk in (
              "median", "l8_ms", "vs_l8", "leaf_visits_per_ray", "l8_leaf_visits_per_ray",
              "tri_tests_per_ray", "l8_tri_tests_per_ray", "inner_visits_per_ray",
              "l8_inner_visits_per_ray", "lanes_per_batch")} for k in ("w4", "w4_mxu")}})
    # the DEEP instances at L = 4 on the chain scene
    deep_cases(L4)
    mxu_deep_cases(L4)
    del p4

    def run_clis(cases, wants, warmup=5, iterations=30):
        """Run the command line at car_boxed 1080p once per case (name ->
        flags), all cases at once, each writing its BMP and metrics record;
        each BMP must be the in-process frame wants[name], and the record
        must show the native builder, the iterations and the leaf size.
        Emits each record (phase `cli`) and returns them. The CLI's frame
        times are kept only from a run alone on the card: with more cases
        they shared it, and say nothing of a frame's time."""
        procs = {}
        t0 = time.perf_counter()
        for name, flags in cases.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "parallel_ray_tracer_tpu_torch", "--scene",
                 "car_boxed", "--resolution", "1080p", "--heuristic", "6", *flags,
                 "--warmup", str(warmup), "--iterations", str(iterations),
                 "--output", os.path.join(out_dir, f"{name}.bmp"),
                 "--metrics-json", os.path.join(out_dir, f"{name}.json")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE)
        recs = {}
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            rec = {"phase": "cli", "case": name, "flags": cases[name], "rc": proc.returncode,
                   "concurrent": len(cases), "seconds": time.perf_counter() - t0,
                   "stdout_tail": out[-1500:], "stderr_tail": err[-1500:]}
            check(name, proc.returncode == 0, f"exit {proc.returncode}")
            if proc.returncode == 0:
                cli_bmp = os.path.join(out_dir, f"{name}.bmp")
                with open(cli_bmp, "rb") as f:
                    data = f.read()
                os.remove(cli_bmp)
                save_frame(name, data)
                same = data == bmp_bytes(wants[name].cpu().numpy())
                check(name, same, "its BMP is not the in-process frame")
                with open(os.path.join(out_dir, f"{name}.json")) as f:
                    metrics = json.load(f)
                check(name, metrics.get("iterations") == iterations,
                      f"iterations {metrics.get('iterations')}")
                check(name, metrics.get("builder") == "native",
                      f"the {metrics.get('builder')} builder ran")
                leaf = 4 if "--leaf-size" in cases[name] else 8
                check(name, metrics.get("leaf_size") == leaf,
                      f"leaf size {metrics.get('leaf_size')}")
                rec.update(bmp_equal=same, iterations=metrics.get("iterations"),
                           backend=metrics.get("backend"), builder=metrics.get("builder"),
                           leaf_size=metrics.get("leaf_size"), mxu=metrics.get("mxu"),
                           device_name=metrics.get("device_name"))
                if len(cases) == 1:
                    rec.update({k: metrics.get(k) for k in ("median_ms", "mean_ms", "ci99_ms")})
            emit(rec)
            recs[name] = {k: v for k, v in rec.items() if k not in ("stdout_tail", "phase")}
        return recs

    # ---- 16. forward shadow rays, closest-hit shadows, the pre-split --------
    # reverse_shadows=False: the fused frame traces each shadow ray from the
    # hit point to the light (window dist^2), as JAX's frame kernel does,
    # and so does the pass-based render. The forward fused frame (FP32 and
    # MXU leaf) is held against its plain version on one band, against the
    # pass-based forward render and the reference BMP (the reference
    # traces hit -> light), with the counts from 0; the sphere frame's
    # forward pass against the pass-based sphere render; the forward and the
    # reversed frame kernel are timed in turns. fast_light=False finds
    # shadows with the closest-hit kernel on the pass-based path, and
    # presplit=0.125 splits car_boxed's large triangles before the build:
    # each frame against the reference BMP. The command line renders the
    # slice's flags (--leaf-size 4, with and without --no-mxu-leaf,
    # --no-reverse-shadows, --no-fast-light, --presplit 0.125), each BMP
    # the in-process frame of its configuration.
    t0 = time.perf_counter()
    rec = {"phase": "shadows", "card": card}
    fwd_cfg = RenderConfig(**CFG, reverse_shadows=False)
    fpipe = dataclasses.replace(pipe, cfg=fwd_cfg)
    fimg, on_ff = on_path("shadows/render_fused", fpipe.render, {"frame<4>": 1})
    fimg_pass, _ = on_path("shadows/render_pass_based", lambda: fpipe.render(variant="pallas"),
                           {"closest_full<4>": cfg.bounces, "occluded<4>": cfg.bounces * nl})
    rec["fused_vs_pass"] = hold_frames("shadows/fused_vs_pass", fimg, fimg_pass)
    rec["reference_image"] = hold_reference("car_boxed_1080p_forward_shadows", fimg)
    rec["vs_reversed"] = hold_frames("shadows/vs_reversed", fimg, img, 0.99)
    del fimg_pass
    # the kernels against their plain versions on one band
    fo, fd = band(o, BANDS[0]), band(d, BANDS[0])
    fkw = dict(bounces=cfg.bounces, reverse_shadows=False)
    fp_f, fwd_plain_ms = timed_once(lambda: ct.frame_plain(T.tri, T.attr, T.lamb, fo, fd,
                                                           leaf_size=L, **fkw))
    rec["band"] = cmp_frame(f"shadows/frame@{BANDS[0]}", ct.frame_tiles(
        T.cbox, T.cmeta, T.tri, T.attr, T.lamb, fo, fd, leaf_size=L,
        stack_depth=T.stack_depth, **fkw), fp_f)
    rec["band_plain_vs_reversed_plain"] = (
        fp_f.stack(-1) - band_ref[BANDS[0]]["frame"].stack(-1)).abs().max().item()
    mfp_f, mfwd_plain_ms = timed_once(lambda: ct.frame_plain(
        M.tri, M.attr, M.lamb, fo, fd, leaf_size=L, cmat=M.cmat, **fkw))
    mkw = dict(leaf_size=L, stack_depth=M.stack_depth, cmat=M.cmat)
    rec["band_mxu"] = cmp_frame(f"shadows/frame_mxu@{BANDS[0]}", ct.frame_tiles(
        M.cbox, M.cmeta, M.tri, M.attr, M.lamb, fo, fd, **mkw, **fkw), mfp_f)
    del mfp_f           # fp_f: kept for the leaf12 phase's forward frames
    mfpipe = dataclasses.replace(mpipe, cfg=RenderConfig(**MXU_CFG, reverse_shadows=False))
    mfimg, on_mf = on_path("shadows/mxu/render_fused", mfpipe.render, {"frame_mxu<4>": 1})
    mfimg_pass, _ = on_path("shadows/mxu/render_pass_based",
                            lambda: mfpipe.render(variant="pallas"),
                            {"closest_full_mxu<4>": cfg.bounces,
                             "occluded_mxu<4>": cfg.bounces * nl})
    rec["mxu_fused_vs_pass"] = hold_frames("shadows/mxu/fused_vs_pass", mfimg, mfimg_pass)
    rec["mxu_reference_image"] = hold_reference("car_boxed_1080p_mxu_forward_shadows", mfimg,
                                                save=False)
    del mfimg_pass
    # the sphere pass: car_boxed_spheres, fused forward against pass-based forward
    spf = dataclasses.replace(sph_pipe, cfg=RenderConfig(**CFG, reverse_shadows=False))
    simg_f, on_sf = on_path("shadows/spheres/render_fused", spf.render, {"frame_sph<4>": 1})
    simg_fp, _ = on_path("shadows/spheres/render_pass_based", lambda: spf.render(variant="pallas"),
                         {"closest_full<4>": cfg.bounces, "occluded<4>": cfg.bounces * nl})
    rec["spheres_fused_vs_pass"] = hold_frames("shadows/spheres/fused_vs_pass", simg_f, simg_fp,
                                               0.99)
    del simg_f, simg_fp
    # timing: the reversed and the forward frame kernel in turns, with work
    fwd_t, shadow_work = {}, {}
    for tag, tabs, ckw in (("fp32", T, {}), ("mxu", M, {"cmat": M.cmat})):
        kw_ = dict(leaf_size=L, stack_depth=tabs.stack_depth, **ckw)

        def frame_call(rev, counters=False):
            return ct.frame_tiles(tabs.cbox, tabs.cmeta, tabs.tri, tabs.attr, tabs.lamb, o, d,
                                  bounces=cfg.bounces, reverse_shadows=rev, counters=counters,
                                  **kw_)

        turns = [time_ms(lambda: frame_call(i in (0, 3))) for i in range(4)]
        names = ct.MXU_COUNTS if ckw else ct.COUNTS
        in_b = ray_b + nbytes(tabs.cbox, tabs.cmeta, tabs.lamb,
                              *((tabs.cmat,) if ckw else ())) + leaf_bytes(tabs, attr=True)
        b_f = bound(frame_call(False, True)[1].cpu().tolist(), names, in_b, 3 * out_plane,
                    leaf=tabs.leaf_size)
        b_r = bound(frame_call(True, True)[1].cpu().tolist(), names, in_b, 3 * out_plane,
                    leaf=tabs.leaf_size)
        fwd_ms = statistics.median([turns[1]["median"], turns[2]["median"]])
        rev_ms = statistics.median([turns[0]["median"], turns[3]["median"]])
        fwd_t[tag] = dict(turns[1], median=fwd_ms, rays=n_rays, turns=turns, reversed_ms=rev_ms,
                          vs_reversed=fwd_ms / rev_ms, **b_f)
        shadow_work[tag] = {k: {"forward": b_f[k], "reversed": b_r[k]}
                            for k in ("traversals", "inner_visits", "box_tests", "leaf_visits",
                                      "tri_tests")}
    rec.update(timing=fwd_t, work=shadow_work,
               launches={"frame<4>": on_ff["frame<4>"], "frame_mxu<4>": on_mf["frame_mxu<4>"],
                         "frame_sph<4>": on_sf["frame_sph<4>"]})
    extra_rows.append(row("frame_kernel<4>, forward shadows", "w4, reverse_shadows=False",
                          on_ff["frame<4>"], rec["band"]["max_abs_err"], fwd_t["fp32"],
                          fwd_plain_ms, f"one {BAND_ROWS}-row band (y {BANDS[0]}), the same rays",
                          2756))
    extra_rows.append(row("frame_kernel<4, MXU>, forward shadows",
                          "w4, mxu, reverse_shadows=False", on_mf["frame_mxu<4>"],
                          rec["band_mxu"]["max_abs_err"], fwd_t["mxu"], mfwd_plain_ms,
                          f"one {BAND_ROWS}-row band (y {BANDS[0]}), the same rays", 2756))

    # fast_light=False: shadows by the closest-hit kernel, forward, pass-based
    nf = dataclasses.replace(pipe, cfg=RenderConfig(**CFG, fast_light=False))
    check("shadows/no_fast_light", nf.resolved_variant() == "pallas", "auto is not pass-based")
    nfimg, _ = on_path("shadows/no_fast_light/render_auto", nf.render,
                       {"closest_full<4>": cfg.bounces * (1 + nl)})
    rec["no_fast_light"] = {"reference_image": hold_reference(
        "car_boxed_1080p_no_fast_light", nfimg, save=False),
        "vs_forward_fused": hold_frames("shadows/no_fast_light/vs_forward", nfimg, fimg, 0.99)}
    # presplit=0.125: the split scene's fused frame
    ps = prepare_native(RenderConfig(**CFG, presplit=0.125))
    psimg, _ = on_path("shadows/presplit/render_fused", ps.render, {"frame<4>": 1})
    rec["presplit"] = {"triangles": ps.scene.num_triangles, "bvh_build_ms": ps.build_ms,
                       "reference_image": hold_reference("car_boxed_1080p_presplit", psimg,
                                                         save=False),
                       "vs_unsplit": hold_frames("shadows/presplit/vs_unsplit", psimg, img, 0.99),
                       "frame": dict(time_ms(ps.render, 2, 10), pixels=W * H)}
    check("shadows/presplit", ps.scene.num_triangles > pipe.scene.num_triangles,
          "presplit did not split car_boxed")
    del nfimg, psimg, nf

    # the command line: the slice's flags, concurrently, each BMP the
    # in-process frame of the same configuration
    want = {"cli_leaf4": (["--leaf-size", "4"], l4_tables["w4_mxu"][2]),
            "cli_leaf4_fp32": (["--leaf-size", "4", "--no-mxu-leaf"], l4_tables["w4"][2]),
            "cli_no_reverse_shadows": (["--no-reverse-shadows"], mfimg),
            "cli_no_fast_light": (["--no-fast-light"], dataclasses.replace(
                mpipe, cfg=RenderConfig(**MXU_CFG, fast_light=False)).render()),
            "cli_presplit": (["--presplit", "0.125"], prepare_native(
                RenderConfig(**MXU_CFG, presplit=0.125)).render())}
    rec["cli"] = run_clis({k: v[0] for k, v in want.items()},
                          {k: v[1] for k, v in want.items()}, warmup=1, iterations=3)
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    del fimg, mfimg, want, fpipe, mfpipe, spf, sph_pipe

    # ---- 17. leaf sizes 2 and 1: every FP32 traversal kernel ----------------
    # prepare(leaf_size=L) for L = 2 and 1 takes the FP32 leaf (JAX takes
    # its MXU leaf at L = 4 and 8 only) and every launch the L = 2 or 1
    # instances (keys "...,l2>", "...,l1>"). Per table of L12_CASES each
    # kernel is held against its plain version on the band of the leaf4
    # phase (the plain L hits, themselves the plain L = 8 hits through the
    # slot maps; the frames against the band's L = 8 plain frame), its paths
    # run with the counts from 0, its 1080p frame is held against phase 7's
    # plain frame on the tile spread, its L = 8 twin's frame and the
    # reference BMP, and its kernels are timed with their work per ray. Then
    # the streamed instances on the padded tables, the sphere frames, the
    # forward-shadow frames against the shadows phase's plain band, the DEEP
    # instances on the chain scene, and make_tracer; at the end frame<4>,
    # frame<8> and the width-2 pass-based render() at L = 8, 4, 2 and 1 in
    # turns (8, 4, 2, 1, 1, 2, 4, 8).
    def leaf12_phase():
        rows_out = []
        t_phase = time.perf_counter()
        kept = {}          # (L, key) -> the pipeline, for the sweep
        tv = pipe.scene.triangle_vertices()
        flat_rays = (Vec3(*(p_.reshape(-1) for p_ in o)), Vec3(*(p_.reshape(-1) for p_ in d)))
        flat_shadow = (Vec3(*(p_.reshape(-1) for p_ in so)), Vec3(*(p_.reshape(-1) for p_ in sd)),
                       m2.reshape(-1))
        def cmp_hits_tri(name, hk, flat_k, hp, flat_p, full):
            """Hits of another tree against the plain hits through both
            slot maps: miss masks equal, t within the bounds, the same
            triangle for >= 99.9% of rays, and where it is, t, norm_dir and
            the attributes equal."""
            mk, mp = hk.t >= T_MAX, hp.t >= T_MAX
            check(name, torch.equal(mk, mp), "miss masks differ")
            both = ~mk & ~mp
            err = (hk.t[both] - hp.t[both]).abs()
            check(name, bool((err <= 1e-4 + 1e-5 * hp.t[both].abs()).all()),
                  "t beyond atol 1e-4, rtol 1e-5")
            same = tri_ids(hk, flat_k) == tri_ids(hp, flat_p)
            agree = same.float().mean().item()
            check(name, agree >= 0.999, f"triangle agreement {agree}")
            check(name, torch.equal(hk.t[same], hp.t[same])
                  and torch.equal(hk.norm_dir[same], hp.norm_dir[same]),
                  "t or norm_dir differs where the triangle agrees")
            if full:
                check(name, all(torch.equal(vk[same], vp[same]) for vk, vp in zip(
                    (*hk.n, *hk.kd, *hk.ks, *hk.kr), (*hp.n, *hp.kd, *hp.ks, *hp.kr))),
                    "attributes differ where the triangle agrees")
            return {"max_abs_err": err.max().item() if err.numel() else 0.0,
                    "triangle_agree": agree, "hit_frac": both.float().mean().item()}

        for Lx in L12_SIZES:
            lt, lname, ph = ct._leaf_tag(Lx), f", L={Lx}", f"leaf12/l{Lx}"
            first, refs = None, None
            for key, extra in L12_CASES.items():
                own = key == "w4_own_threshold"
                thr = {} if own else dict(leaf_threshold=L4_LEAF_THRESHOLD)
                p = prepare_native(RenderConfig(**MXU_CFG, leaf_size=Lx, **thr, **extra))
                if key == "w8_bf16":
                    p = pair_rows_w8(p)
                A = p.tables
                a = A.arity
                bf = A.compressed or A.cbox.dtype == torch.bfloat16
                sfx = ",bf16" if bf else ""
                name = f"{ph}/{key}"
                check(name, p.leaf_size == A.leaf_size == Lx and not p.mxu and A.cmat is None
                      and a == extra.get("bvh_width", 4) and bf == bool(extra.get("bf16_bvh")),
                      "not this case's tables with the FP32 leaf")
                check(name, not bool(A.tri[:, 12 * Lx:].any()),
                      f"tri rows hold more than {Lx} triangles")
                if first is None:
                    first = p
                    refs = {
                        "closest": timed_once(lambda: tp.closest_plain(A.tri, b4o, b4d, Lx)),
                        "closest_full": timed_once(lambda: tp.closest_full_plain(
                            A.tri, A.attr, b4o, b4d, Lx)),
                        "shadow": (tp.closest_plain(A.tri, *bref4["rays"]["shadow"], Lx), None),
                        "occluded": timed_once(lambda: tp.occluded_plain(
                            A.tri, b4so, b4sd, b4m2, Lx)),
                        "frame": (bref4["frame"], cmp["frame"]["band_plain_ms"])}
                    h_l, h8 = refs["closest"][0], bref4["closest", "primary"]
                    same_tri = (tri_ids(h_l, p.flat) == tri_ids(h8, pipe.flat)).float().mean().item()
                    check(f"{ph}/plain", torch.equal(h_l.t, h8.t) and same_tri >= 0.999,
                          f"the plain L = {Lx} hits are not the L = 8 hits (triangles {same_tri})")
                    refs["vs_l8_same_triangle"] = same_tri
                F = first.tables
                if not own:
                    # the first table's slots and rows (width 2: the native
                    # builder's rows, whose normals round otherwise, as in leaf4)
                    normals = (torch.arange(A.tri.shape[1], device=A.tri.device) % 12) >= 9
                    check(name, np.array_equal(p.flat.slot_map, first.flat.slot_map)
                          and torch.equal(A.attr, F.attr)
                          and not bool((A.tri - F.tri).abs()[:, ~normals].any()),
                          "slots, attr or tri beyond the normals differ from the first table")
                    A = A._replace(tri=F.tri)
                twin = "w4" if own else key
                pimg, _, rows = leaf_case(
                    "leaf12", name, key, p, A, refs, [(twin, img if twin == "w4" else frames[twin])],
                    hits=(lambda nm, hk, hp, full, p=p: cmp_hits_tri(nm, hk, p.flat, hp,
                                                                   first.flat, full))
                    if own else None, save=key == "w4", note=", the L = 8 tree" if own else "")
                rows_out += rows
                del pimg
                if key in ("w4", "w8", "w2"):
                    kept[Lx, key] = p

                if key in L12_STREAM:
                    rows_out += leaf_streamed("leaf12", name, key, p, A, Lx, refs)
                if a >= 4 and not own:
                    rows_out += leaf_spheres("leaf12", name, key, p, A, Lx)

                # forward shadow rays: against the shadows phase's plain band
                if key in L12_FORWARD:
                    akw = dict(leaf_size=Lx, stack_depth=A.stack_depth, compressed=A.compressed)
                    frame_key, bn = f"frame<{a}{sfx}{lt}>", box_name(A)
                    fres = cmp_frame(f"{name}/frame_forward@{BANDS[0]}", ct.frame_tiles(
                        A.cbox, A.cmeta, A.tri, A.attr, A.lamb, b4o, b4d, bounces=cfg.bounces,
                        reverse_shadows=False, **akw), fp_f)
                    fwd_p = dataclasses.replace(
                        p, cfg=dataclasses.replace(p.cfg, reverse_shadows=False))
                    fimg_l, on_fw = on_path(f"{name}/render_fused_forward", fwd_p.render,
                                            {frame_key: 1})
                    fres["reference_image"] = hold_reference(
                        f"car_boxed_1080p_l{Lx}_{key}_forward", fimg_l, save=False)
                    del fimg_l

                    def fwd_call(counters=False):
                        return ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d,
                                              bounces=cfg.bounces, reverse_shadows=False,
                                              counters=counters, **akw)

                    tf = time_ms(fwd_call, 2, 5)
                    tf.update(bound(fwd_call(True)[1].cpu().tolist(), ct.COUNTS,
                                    ray_b + nbytes(A.cbox, A.cmeta, A.lamb)
                                    + leaf_bytes(A, attr=True),
                                    3 * out_plane, leaf=Lx))
                    emit({"phase": "leaf12", "leaf_size": Lx, "case": f"{key}_forward",
                          "card": card, "compare": fres, "launches": on_fw[frame_key],
                          "timing": tf})
                    rows_out.append(row(f"frame_kernel<{a}{bn}{lname}>, forward shadows",
                                        f"{key}{lname}, reverse_shadows=False", on_fw[frame_key],
                                        fres["max_abs_err"], tf, fwd_plain_ms,
                                        f"one {BAND_ROWS}-row band (y {BANDS[0]}), the same rays",
                                        2756))
                del p, A

            # make_tracer at this L: the stacked triangles at widths 2 and 4
            # (t = 1 for every ray, the plain version's hits), and car_boxed's
            # width-4 tables with a C-matrix table passed (dual=True): the
            # FP32 instances run and give the FP32 outputs bit for bit
            stv = stacked_triangles()
            sflat = flatten_bvh(build_bvh(stv, heuristic=1, max_depth=64, leaf_threshold=1), stv,
                                leaf_size=Lx)
            R_ = pipeline.PACKET
            mo = Vec3(*(torch.full((R_,), v, device=pipe.device) for v in (0.3, 0.3, -1.0)))
            md = Vec3(*(torch.full((R_,), v, device=pipe.device) for v in (0.0, 0.0, 1.0)))
            mt = {"leaf_size": Lx}
            for w, packer in ((2, pack_bvh), (4, pack_bvh4)):
                pk = packer(sflat, stv)
                tabs = tuple(torch.as_tensor(x_, device=pipe.device)
                             for x_ in (pk.cbox, pk.cmeta, pk.tri))
                need = stack_need(pk.cmeta, w)
                closest_m, _ = ct.make_tracer(tabs, Lx)
                kname = ct._instance("closest", w, ct.BOX_F32, deep=ct.use_deep_tier(need, w),
                                     leaf_size=Lx)
                hm, _ = on_path(f"{ph}/make_tracer/stacked_w{w}", lambda: closest_m(mo, md),
                                {kname: 1})
                hp_ = tp.closest_plain(tabs[2], mo.reshape(8, 128), md.reshape(8, 128), Lx)
                ok = (bool(((hm.t - 1.0).abs() <= 1e-5).all())
                      and torch.equal(hm.t, hp_.t.reshape(-1))
                      and torch.equal(hm.idx, hp_.idx.reshape(-1)))
                check(f"{ph}/make_tracer/stacked_w{w}", ok,
                      "t is not 1 everywhere, or not the plain version's hits")
                mt[f"stacked_w{w}"] = {"instance": kname, "stack_need": need, "ok": ok,
                                       "t_max_err": (hm.t - 1.0).abs().max().item()}
            A = first.tables
            cm = torch.as_tensor(split_cmat(pack_bvh4(first.flat, tv).cmat).view(np.int16),
                                 device=pipe.device).view(torch.bfloat16)
            check(f"{ph}/make_tracer", cm.shape[0] == A.tri.shape[0] * 4 * Lx,
                  f"C-matrix rows {cm.shape[0]}")
            mkw = dict(stack_depth=A.stack_depth, compressed=A.compressed)
            with_c = ct.make_tracer((A.cbox, A.cmeta, A.tri, A.attr, cm), Lx, dual=True, **mkw)
            hm, _ = on_path(f"{ph}/make_tracer/car_boxed_cmat", lambda: with_c[0](*flat_rays),
                            {f"closest_full<4{lt}>": 1})
            hw = ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, o, d, leaf_size=Lx, **mkw)
            bm, _ = on_path(f"{ph}/make_tracer/car_boxed_cmat_occluded",
                            lambda: with_c[1](*flat_shadow), {f"occluded<4{lt}>": 1})
            bw = ct.occluded_tiles(A.cbox, A.cmeta, A.tri, so, sd, m2, leaf_size=Lx, **mkw)
            fc, _ = on_path(f"{ph}/frame_tiles_cmat", lambda: ct.frame_tiles(
                A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d, bounces=cfg.bounces, leaf_size=Lx,
                cmat=cm, **mkw), {f"frame<4{lt}>": 1})
            ff = ct.frame_tiles(A.cbox, A.cmeta, A.tri, A.attr, A.lamb, o, d, bounces=cfg.bounces,
                                leaf_size=Lx, **mkw)
            mt["car_boxed_cmat"] = {
                "closest_full": same_bits([x_.reshape(-1) for x_ in planes(hw, True)],
                                          planes(hm, True)),
                "occluded": torch.equal(bm, bw.reshape(-1)),
                "frame": same_bits(list(fc), list(ff)), "cmat": list(cm.shape)}
            check(f"{ph}/make_tracer/car_boxed_cmat", all(
                v for k_, v in mt["car_boxed_cmat"].items() if k_ != "cmat"),
                "a C-matrix table changed the FP32 outputs")
            emit({"phase": "leaf12", "leaf_size": Lx, "case": "make_tracer", "card": card, **mt})
            del hm, hw, bm, bw, fc, ff, cm, first, refs, A

            # the DEEP instances at this L on the chain scene
            deep_cases(Lx)

        # make_tracer at L = 8 (FP32, MXU) and 4 on car_boxed's width-4
        # tables: the wrappers' outputs bit for bit, their instances
        mt = {}
        for tag_, A, cm in (("l8", T, None), ("l8_mxu", M, M.cmat),
                            ("l4", l4_tables["w4"][1], None)):
            Lt = A.leaf_size
            mode = "_mxu" if cm is not None else ""
            lt = ct._leaf_tag(Lt)
            mkw = dict(stack_depth=A.stack_depth, compressed=A.compressed)
            closest_m, occluded_m = ct.make_tracer(
                (A.cbox, A.cmeta, A.tri, A.attr) + (() if cm is None else (cm,)), Lt,
                dual=True, **mkw)
            hm, _ = on_path(f"leaf12/make_tracer/{tag_}", lambda: closest_m(*flat_rays),
                            {f"closest_full{mode}<4{lt}>": 1})
            bm, _ = on_path(f"leaf12/make_tracer/{tag_}_occluded",
                            lambda: occluded_m(*flat_shadow), {f"occluded{mode}<4{lt}>": 1})
            hw = ct.closest_tiles_full(A.cbox, A.cmeta, A.tri, A.attr, o, d, leaf_size=Lt,
                                       cmat=cm, **mkw)
            bw = ct.occluded_tiles(A.cbox, A.cmeta, A.tri, so, sd, m2, leaf_size=Lt, cmat=cm, **mkw)
            mt[tag_] = {"closest_full": same_bits([x_.reshape(-1) for x_ in planes(hw, True)],
                                                  planes(hm, True)),
                        "occluded": torch.equal(bm, bw.reshape(-1))}
            check(f"leaf12/make_tracer/{tag_}", all(mt[tag_].values()),
                  "make_tracer's outputs are not the wrappers'")
            del hm, bm, hw, bw
        emit({"phase": "leaf12", "case": "make_tracer_l8_l4", "card": card, **mt})

        # frame<4>, frame<8> and the width-2 pass-based render() at
        # L = 8, 4, 2 and 1, in turns (8, 4, 2, 1, 1, 2, 4, 8)
        sweep = {}
        w8_8 = prepare_native(RenderConfig(**CFG, bvh_width=8))
        w2_8 = prepare_native(RenderConfig(**CFG, bvh_width=2))
        w8_4 = prepare_native(RenderConfig(**CFG, bvh_width=8, leaf_size=4,
                                           leaf_threshold=L4_LEAF_THRESHOLD))
        w2_4 = prepare_native(RenderConfig(**CFG, bvh_width=2, leaf_size=4,
                                           leaf_threshold=L4_LEAF_THRESHOLD))
        by_leaf = {"w4": {8: pipe, 4: l4_tables["w4"][0]}, "w8": {8: w8_8, 4: w8_4},
                   "w2": {8: w2_8, 4: w2_4}}
        for key in by_leaf:
            by_leaf[key].update({Lx: kept[Lx, key] for Lx in L12_SIZES})
        order = (8, 4, 2, 1, 1, 2, 4, 8)
        for key, pipes in by_leaf.items():
            if key == "w2":
                fns = {Lx: (lambda p_=pq: p_.render()) for Lx, pq in pipes.items()}
                turns = [(Lx, time_ms(fns[Lx], ARITY_WARMUP, ARITY_TIMED)) for Lx in order]
            else:
                fns, counted = {}, {}
                for Lx, pq in pipes.items():
                    fn, cnt_fn, _, _ = kernel_runs(pq.tables)["frame"]
                    fns[Lx], counted[Lx] = fn, cnt_fn
                turns = [(Lx, time_ms(fns[Lx])) for Lx in order]
            rec = {}
            for Lx in (8, 4, 2, 1):
                ts = [t["median"] for l_, t in turns if l_ == Lx]
                rec[Lx] = {"median": statistics.median(ts), "turns": ts}
                if key != "w2":
                    c = dict(zip(ct.COUNTS, counted[Lx]().cpu().tolist()))
                    rec[Lx].update({f"{k}_per_ray": c[k] / n_rays for k in
                                    ("inner_visits", "box_tests", "leaf_visits", "tri_tests")})
                rec[Lx]["vs_l8"] = rec[Lx]["median"] / rec[8]["median"] if Lx != 8 else 1.0
            sweep["frame<4>" if key == "w4" else "frame<8>" if key == "w8"
                  else "render_pass_based_w2"] = rec
        emit({"phase": "leaf12", "case": "sweep", "card": card, "order": list(order),
              "sweep": sweep, "seconds": time.perf_counter() - t_phase})
        return rows_out

    extra_rows += leaf12_phase()
    del fp_f, l4_tables, mpipe, M

    # ---- 18. the microbench probes (rows 15a-15m) ---------------------------
    extra_rows += microbench_phase(card, out_dir, timing["w4"]["frame"])

    # ---- 19. the command line: the width-8 frame, the --bf16-bvh frame -----
    emit({"phase": "builds", "native_build": dict(native.BUILD_INFO), "builds": builds})
    run_clis({"cli_w8": ["--bvh-width", "8", "--no-mxu-leaf"]}, {"cli_w8": frames["w8"]})
    run_clis({"cli_bf16": ["--bf16-bvh", "--no-mxu-leaf"]}, {"cli_bf16": frames["w4_bf16"]})
    del frames

    # ---- 20. differentiable rendering and the training step ----------------
    mxu_pipe = prepare_native(RenderConfig(**MXU_CFG))
    diff_phase(card, {"mxu": mxu_pipe, "fp32": pipe})

    # ---- 21. the sharded render and step, the bands, the profiler ----------
    sharded_phase(card, {"mxu": mxu_pipe, "fp32": pipe})
    del mxu_pipe

    # ---- 22. the packet traversal in torch ops (variant="jax") -------------
    packet_phase(card, pipe, out_dir)

    # ---- 23. the kernels line --------------------------------------------
    kernels = []
    for name, key, kernel, line in KERNEL_ROWS:
        t = timing[key][kernel]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "parallel_ray_tracer_tpu_torch/csrc/trace.cuh",
            "replaces": f"parallel_ray_tracer_tpu/ops/pallas_trace.py:{line}",
            "tables": key, "launches": launches[key][kernel],
            "max_abs_err": max_err[key][kernel],
            "ms": t["median"], "plain_ms": full[kernel.replace("_stream", "")]["plain_ms"],
            "plain_of": (f"width-4 tables, every {FRAME_TILE_STRIDE}th tile of the same rays "
                         f"({full['frame']['rays']} rays; the plain version reads no node "
                         "table)"),
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "rays": n_rays,
        })
    kernels += extra_rows
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"records": RECORDS, "kernels": kernels, "failures": FAILURES}, f,
                  indent=1)
    if FAILURES:
        print("chip_smoke: FAILED\n  " + "\n  ".join(FAILURES), file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def diff_phase(card: str, pipes: dict) -> None:
    """Phase `diff`: differentiable rendering (ops/diff.py) and the training
    step (parallel/sharded.make_train_step) on car_boxed's tables with the
    MXU leaf (the defaults) and the FP32 leaf. For each table and size of
    DIFF_SIZES: one step with the launch counts from 0 (exactly `bounces`
    closest-with-attributes launches and bounces x lights any-hit launches,
    of the instances prepare chose; npop0 = 2 with npop = 8 the same), its
    peak memory, the step, its forward under no_grad and its backward timed
    with CUDA events, the forward at lr = 0 against the pass-based render
    of the same camera, tiles and flags (the loss below DIFF_FORWARD_LOSS
    of the table, DIFF_FORWARD_SHARE of the pixels within 1e-3; on the MXU
    table its loss against the FP32 table's render recorded); at 1080p a
    torch.profiler window
    (launches, the traversal kernels' share of the device time, the idle
    share), the gradients of the training loss with respect to the
    vertices, the material kd and the light positions on a 64-row band
    through the kernels against a tracer of their plain versions on the same
    tensors (hits to the hit bounds, gradients within 1e-5 max|g|; the MXU
    gradient also against the FP32 one: loss within 1e-3 relative, vertex
    gradient within 1e-2 relative L2), and DIFF_SGD_STEPS steps (finite,
    the last loss below the first); at 512x512 on the FP32 table the kd
    gradient of the most seen material against a central finite difference
    (h = DIFF_FD_H, the attr rows repacked, rtol 2e-2)."""
    from parallel_ray_tracer_tpu_torch.models.camera import default_camera
    from parallel_ray_tracer_tpu_torch.models.device_scene import build_device_scene
    from parallel_ray_tracer_tpu_torch.ops import cuda_trace as ct
    from parallel_ray_tracer_tpu_torch.ops import diff
    from parallel_ray_tracer_tpu_torch.ops import render as R
    from parallel_ray_tracer_tpu_torch.ops import trace_plain as tp
    from parallel_ray_tracer_tpu_torch.ops.pack import pack_attr
    from parallel_ray_tracer_tpu_torch.ops.shade import trace_rays
    from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3
    from parallel_ray_tracer_tpu_torch.parallel import sharded

    t_phase = time.perf_counter()
    B = DIFF_BOUNCES
    check("diff", pipes["mxu"].mxu and not pipes["fp32"].mxu,
          "prepare took the MXU leaf with mxu_leaf=False, or not with the defaults")

    def pass_based_tiles(p, W, H):
        """The pass-based render's colours in prepare_inputs' (ntiles, 1024,
        3) layout, the tile padding included (1080 rows take 34 tile
        rows): render_bvh_pallas before its crop, held to its frame."""
        T = p.tables
        o, d = R._tiled_planes(default_camera(), W, H, 32, 32, p.device)
        cf, of = ct.make_tracer(T.packed_dev, T.leaf_size, ds=p.ds, stack_depth=T.stack_depth,
                                compressed=T.compressed, dual=True)
        col = trace_rays(p.ds, cf, of, o.reshape(-1), d.reshape(-1), B, reverse_shadows=True)
        flat = col.clamp(0.0, 1.0).stack(-1).reshape(-1, 3)
        img = R.render_bvh_pallas(p.ds, T, default_camera(), W, H, bounces=B,
                                  fast_light=True, reverse_shadows=True)
        check(f"diff/{W}x{H}/render", torch.equal(R.tiles_to_image(flat, W, H, 32, 32), img),
              "the pass-based colours are not render_bvh_pallas's frame")
        return flat.reshape(-1, 1024, 3)

    def plain_tracer(T):
        L = T.leaf_size

        def closest(o, d):
            if T.cmat is None:
                return tp.closest_full_plain(T.tri, T.attr, o, d, L)
            return tp.closest_full_mxu_plain(T.cmat, T.tri, T.attr, o, d, L)

        def occluded(o, d, m2):
            if T.cmat is None:
                return tp.occluded_plain(T.tri, o, d, m2, L)
            return tp.occluded_mxu_plain(T.cmat, T.tri, o, d, m2, L)

        return closest, occluded

    def kernel_tracer(T, ds):
        return ct.make_tracer(T.packed_dev, T.leaf_size, ds=ds, stack_depth=T.stack_depth,
                              compressed=T.compressed, dual=True)

    def recording(pair, log):
        """The tracer pair, each output also kept in `log`."""
        c, o = pair

        def closest(*a):
            log.append(c(*a))
            return log[-1]

        def occluded(*a):
            log.append(o(*a))
            return log[-1]

        return closest, occluded

    def band_grads(p, tracer_of, o_b, d_b, log):
        """The training loss on the band (target zeros) and its gradients
        with respect to verts, mats_kd and lights_pos."""
        sc = p.scene
        params = [torch.tensor(np.asarray(a, np.float32), device=p.device, requires_grad=True)
                  for a in (sc.verts, sc.mats_kd, sc.lights_pos)]
        ds = build_device_scene(params[0], sc.faces, sc.mat_idx, params[1], sc.mats_ks,
                                sc.mats_kr, params[2], sc.lights_kl,
                                slot_map=p.flat.slot_map, device=p.device)
        cf, of = recording(tracer_of(ds), log)
        col = diff.trace_rays_diff(ds, cf, of, o_b, d_b, B, reverse_shadows=True)
        loss = (col.clamp(0.0, 1.0).stack(-1) ** 2).sum() / (3 * o_b.x.numel())
        return loss.detach(), torch.autograd.grad(loss, params)

    def cmp_logs(name, lk, lp, mxu, expect):
        """Each pass's kernel hits against the plain ones: miss masks and
        idx (blocked) agreement >= 0.999 (MXU: 0.9999), t within atol 1e-4,
        rtol 1e-5 (MXU: relative 1e-5) where both hit; bit-equal shares."""
        out, floor = [], 0.9999 if mxu else 0.999
        for i, (a, b) in enumerate(zip(lk, lp)):
            if isinstance(a, torch.Tensor):
                agree = (a == b).float().mean().item()
                check(name, agree >= floor, f"pass {i}: blocked agreement {agree}")
                out.append({"pass": i, "blocked_agree": agree})
                continue
            miss = ((a.t >= 3e38) == (b.t >= 3e38)).float().mean().item()
            both = (a.t < 3e38) & (b.t < 3e38)
            err = (a.t[both] - b.t[both]).abs()
            tol = (1e-5 * b.t[both].abs()) if mxu else (1e-4 + 1e-5 * b.t[both].abs())
            idx = (a.idx == b.idx).float().mean().item()
            check(name, miss >= floor and idx >= floor and bool((err <= tol).all()),
                  f"pass {i}: miss agreement {miss}, idx agreement {idx}, t beyond the bound")
            out.append({"pass": i, "miss_agree": miss, "idx_agree": idx,
                        "t_bit_equal": (a.t == b.t).float().mean().item(),
                        "t_max_err": err.max().item() if err.numel() else 0.0})
        check(name, len(lk) == len(lp) == expect, f"{len(lk)} / {len(lp)} passes, not {expect}")
        return out

    def grad_err(gk, gp):
        errs = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(gk, gp)]
        return dict(zip(("verts", "mats_kd", "lights_pos"), errs))

    def backward_ms(step, v, o_t, d_t, target):
        ms = []
        for i in range(DIFF_WARMUP + DIFF_TIMED):
            vv = v.detach().requires_grad_(True)
            loss = step.loss(vv, o_t, d_t, target)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.autograd.grad(loss, vv)
            b.record()
            torch.cuda.synchronize()
            if i >= DIFF_WARMUP:
                ms.append(a.elapsed_time(b))
        return {"median": statistics.median(ms), "min": min(ms), "max": max(ms), "runs": len(ms)}

    band_ref = {}
    for tag, p in pipes.items():
        T = p.tables
        mode = "_mxu" if T.cmat is not None else ""
        nl = T.lamb.shape[0] - 1
        want = {f"closest_full{mode}<4>": B, f"occluded{mode}<4>": B * nl}

        def make(W, H, lr, **kw):
            return sharded.make_train_step(
                p.scene, None, W, H, bounces=B, lr=lr, variant="pallas",
                tracer_data=T.packed_dev, leaf_size=T.leaf_size, stack_depth=T.stack_depth,
                slot_map=p.flat.slot_map, compressed=T.compressed, device=p.device, **kw)

        for W, H in DIFF_SIZES:
            rec = {"phase": "diff", "table": tag, "size": f"{W}x{H}", "card": card,
                   "bounces": B, "lr": DIFF_LR, "builder": p.builder}
            step, prep = make(W, H, DIFF_LR)
            v, o_t, d_t, target = prep()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ct.reset_launch_counts()
            t0 = time.perf_counter()
            v1, loss = step(v, o_t, d_t, target)
            torch.cuda.synchronize()
            rec["first_step_s"] = time.perf_counter() - t0
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            rec["step_bytes"] = rec["peak_bytes"] - base
            counts = {k: n for k, n in ct.LAUNCHES.items() if n}
            check(f"diff/{tag}/{W}x{H}", counts == want, f"launches {counts}, expected {want}")
            rec["launches"] = counts
            step8, _ = make(W, H, DIFF_LR, npop=8, npop0=2)
            ct.reset_launch_counts()
            v8, loss8 = step8(v, o_t, d_t, target)
            counts8 = {k: n for k, n in ct.LAUNCHES.items() if n}
            # the forward repeats bit for bit; the gradient to rounding (the
            # scatter-adds of the backward sum with atomics)
            rec["npop0_vertex_diff"] = (v8 - v1).abs().max().item()
            check(f"diff/{tag}/{W}x{H}/npop0", counts8 == want and torch.equal(loss8, loss)
                  and rec["npop0_vertex_diff"] <= 1e-6 * v1.abs().max().item(),
                  f"npop0=2, npop=8: launches {counts8}, or another step")
            rec["loss"] = loss.item()
            check(f"diff/{tag}/{W}x{H}", bool(torch.isfinite(v1).all()) and loss.item() > 0,
                  "a non-finite vertex, or no loss")

            rec["step_ms"] = time_ms(lambda: step(v, o_t, d_t, target), DIFF_WARMUP, DIFF_TIMED)

            def forward():
                with torch.no_grad():
                    step.loss(v, o_t, d_t, target)

            rec["forward_ms"] = time_ms(forward, DIFF_WARMUP, DIFF_TIMED)
            rec["backward_ms"] = backward_ms(step, v, o_t, d_t, target)

            # the forward against the pass-based render, at lr = 0
            tgt = pass_based_tiles(p, W, H)
            step0, _ = make(W, H, 0.0)
            v0, l0 = step0(v, o_t, d_t, tgt)
            with torch.no_grad():
                fwd = step.forward(v, o_t, d_t)
            dd = (fwd - tgt).abs()
            within = (dd.amax(-1) < 1e-3).float().mean().item()
            bound = DIFF_FORWARD_LOSS[tag]
            rec["forward_vs_render"] = {"loss": l0.item(), "bound": bound,
                                        "within_1e-3": within, "median": dd.median().item(),
                                        "max": dd.max().item()}
            if T.cmat is not None:
                # the recompute's frame is the FP32 leaf's wherever both
                # leaves pick one triangle
                with torch.no_grad():
                    rec["forward_vs_fp32_render"] = step.loss(
                        v, o_t, d_t, pass_based_tiles(pipes["fp32"], W, H)).item()
            check(f"diff/{tag}/{W}x{H}/forward", l0.item() < bound and torch.equal(v0, v),
                  f"lr=0 loss {l0.item()} against the render")
            check(f"diff/{tag}/{W}x{H}/forward",
                  within > DIFF_FORWARD_SHARE and dd.median().item() < 1e-5,
                  f"{within} of pixels within 1e-3, median {dd.median().item()}")

            if (W, H) == DIFF_SIZES[0]:
                prof = profile(lambda: step(v, o_t, d_t, target))
                rec["profile"] = prof
                if "kernel_launches_per_call" in prof:
                    rec["launches_per_step"] = {
                        "traversal": prof["traversal_launches_per_call"],
                        "other": prof["kernel_launches_per_call"]
                        - prof["traversal_launches_per_call"]}
                # the kernels' gradients against their plain versions' on a band
                r0 = (DIFF_BAND // 32) * (W // 32)
                r1 = r0 + 2 * (W // 32)
                o_b = Vec3(*(x[r0:r1].reshape(-1) for x in o_t))
                d_b = Vec3(*(x[r0:r1].reshape(-1) for x in d_t))
                lk, lp = [], []
                loss_k, gk = band_grads(p, lambda ds: kernel_tracer(T, ds), o_b, d_b, lk)
                t0 = time.perf_counter()
                loss_p, gp = band_grads(p, lambda ds: plain_tracer(T), o_b, d_b, lp)
                torch.cuda.synchronize()
                errs = grad_err(gk, gp)
                rec["band"] = {"rays": o_b.x.numel(), "loss": loss_k.item(),
                               "plain_loss": loss_p.item(), "plain_s": time.perf_counter() - t0,
                               "grad_max_rel_err": errs,
                               "passes": cmp_logs(f"diff/{tag}/band", lk, lp, bool(mode),
                                                  B * (1 + nl))}
                check(f"diff/{tag}/band", all(e <= 1e-5 for e in errs.values())
                      and all(torch.isfinite(g).all() for g in gk),
                      f"gradients against the plain versions' {errs}")
                band_ref[tag] = (loss_k, gk)

                # SGD steps at 1080p
                losses, vs = [], v
                for _ in range(DIFF_SGD_STEPS):
                    vs, ls = step(vs, o_t, d_t, target)
                    losses.append(ls.item())
                rec["sgd_losses"] = losses
                check(f"diff/{tag}/sgd", all(np.isfinite(losses))
                      and bool(torch.isfinite(vs).all()) and losses[-1] < losses[0],
                      f"losses {losses}")
            emit(rec)
            del step, step8, step0, prep, v, o_t, d_t, target, v1, tgt, fwd

    # the MXU leaf's band gradient against the FP32 leaf's
    (lm, gm), (lf, gf) = band_ref["mxu"], band_ref["fp32"]
    rel_loss = abs(lm.item() - lf.item()) / abs(lf.item())
    rel_l2 = ((gm[0] - gf[0]).norm() / gf[0].norm()).item()
    check("diff/mxu_vs_fp32", rel_loss < 1e-3 and rel_l2 < 1e-2,
          f"loss {rel_loss} relative, vertex gradient {rel_l2} relative L2")

    # kd of the most seen material by central difference, the attr rows
    # repacked from the perturbed table (tests/test_diff.py:239-283)
    p = pipes["fp32"]
    T, sc = p.tables, p.scene
    W, H = DIFF_SIZES[1]
    _, prep = sharded.make_train_step(sc, None, W, H, device=p.device)
    _, o_t, d_t, _ = prep()
    of, df = o_t.reshape(-1), d_t.reshape(-1)
    hit = ct.make_tracer(T.packed_dev, T.leaf_size, stack_depth=T.stack_depth)[0](of, df)
    mats = p.ds.mat_idx[hit.idx[hit.idx >= 0].long()].long()
    mi = int(torch.bincount(mats).argmax())

    def color_sum(kd, tables):
        ds = build_device_scene(sc.verts, sc.faces, sc.mat_idx, kd, sc.mats_ks, sc.mats_kr,
                                sc.lights_pos, sc.lights_kl, slot_map=p.flat.slot_map,
                                device=p.device)
        col = diff.trace_rays_diff(ds, *kernel_tracer(tables, ds), of, df, B,
                                   reverse_shadows=True)
        return col.stack(-1).double().sum()

    kd0 = np.asarray(sc.mats_kd, np.float32)
    kd = torch.tensor(kd0, device=p.device, requires_grad=True)
    (g,) = torch.autograd.grad(color_sum(kd, T), kd)
    fd_vals = []
    for sign in (1.0, -1.0):
        kd1 = kd0.copy()
        kd1[mi, 0] += sign * DIFF_FD_H
        attr = pack_attr(p.flat, sc.mat_idx, kd1, sc.mats_ks, sc.mats_kr)
        tables = T._replace(attr=torch.tensor(attr, device=p.device))
        with torch.no_grad():
            fd_vals.append(color_sum(torch.tensor(kd1, device=p.device), tables).item())
    fd = (fd_vals[0] - fd_vals[1]) / (2 * DIFF_FD_H)
    ad = g[mi, 0].item()
    check("diff/fd_kd", abs(fd) > 0.3 and abs(ad - fd) <= 2e-2 * abs(fd),
          f"d/dkd[{mi}, 0]: gradient {ad}, finite difference {fd}")
    emit({"phase": "diff", "case": "summary", "card": card,
          "mxu_vs_fp32": {"loss_rel": rel_loss, "verts_grad_rel_l2": rel_l2,
                          "loss_mxu": lm.item(), "loss_fp32": lf.item()},
          "fd_kd": {"material": mi, "h": DIFF_FD_H, "gradient": ad, "fd": fd,
                    "size": f"{W}x{H}"},
          "seconds": time.perf_counter() - t_phase})


# The sharded phase: the shards of one card's mesh, the sharded training
# step's size (scripts/bench_train.py's 512x512, the diff phase's bounces
# and lr), the checkpointed render's band rows (1080 rows: 4 bands of 256
# and one of 56) and the bands a first run renders before it stops; the
# bound of a sharded frame against render() (tests/test_sharded.py:123-125)
# and of the sharded step against the one-device step (:321-323).
SHARDS = 4
SHARD_STEP_SIZE = (512, 512)
SHARD_BAND_ROWS = 256
SHARD_BANDS_BEFORE_STOP = 2
SHARD_ATOL = 1e-6
SHARD_STEP_LOSS_ATOL, SHARD_STEP_VERTS_ATOL = 1e-6, 1e-5


class _Stop(Exception):
    """Ends a checkpointed render after some bands, as a crash would."""


def sharded_phase(card: str, pipes: dict) -> None:
    """Phase `sharded`: parallel/sharded.py, parallel/distributed.py,
    Pipeline.render_band with utils/checkpoint.py and utils/profiling.py on
    car_boxed 1080p, 4 bounces, with the MXU table (the defaults) and the
    FP32 table. For each table: render_sharded over make_mesh(1) and over a
    mesh naming cuda:0 SHARDS times, "fused" and "pallas", each with the
    launch counts from 0 (one frame launch a shard; the pass kernels'
    launches of render(), a shard each) and held against render() of the
    variant within SHARD_ATOL, rtol 0 (bit equality recorded); a one-rank
    NCCL group (distributed.initialize with a local address) whose sharded
    frame must be the frame without a group, bit for bit, the group
    destroyed after; the fused frames timed in turns (render(), 1 shard,
    SHARDS shards) with CUDA events. With the defaults: make_train_step
    over a mesh of cuda:0 twice against one device at SHARD_STEP_SIZE (the
    loss within SHARD_STEP_LOSS_ATOL, the vertices within
    SHARD_STEP_VERTS_ATOL, the traversal launches doubled), both steps
    timed; TileRenderCheckpoint in SHARD_BAND_ROWS-row bands through
    render_band("fused") into a temporary file (render()'s frame bit for
    bit, one frame launch a band, the bands timed), then a run stopped
    after SHARD_BANDS_BEFORE_STOP bands and resumed (only the missing bands
    rendered, the last of 56 rows, the frame bit for bit); and
    profiling.trace around one sharded frame, whose trace file must name
    the frame kernel."""
    import socket

    from parallel_ray_tracer_tpu_torch.ops import cuda_trace as ct
    from parallel_ray_tracer_tpu_torch.parallel import distributed, sharded
    from parallel_ray_tracer_tpu_torch.utils import profiling
    from parallel_ray_tracer_tpu_torch.utils.checkpoint import TileRenderCheckpoint

    t_phase = time.perf_counter()
    mesh1 = sharded.make_mesh(1)
    meshn = sharded.make_mesh(devices=["cuda:0"] * SHARDS)
    check("sharded", mesh1.size == 1 and meshn.size == SHARDS and not mesh1.distributed,
          f"meshes {mesh1}, {meshn}")

    def counted(fn):
        ct.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: n for k, n in ct.LAUNCHES.items() if n}

    def sharded_frame(p, mesh, variant):
        c = p.cfg
        return sharded.render_sharded(p.ds, p.tables, p.camera(), c.width, c.height, mesh,
                                      bounces=c.bounces, tile_rows=c.tile_rows,
                                      tile_cols=c.tile_cols, variant=variant,
                                      dual=c.dual_pop, stream=p.stream,
                                      fast_light=c.fast_light,
                                      reverse_shadows=c.reverse_shadows)

    for tag, p in pipes.items():
        rec = {"phase": "sharded", "table": tag, "card": card, "mxu": p.mxu,
               "shards": SHARDS}
        for variant in ("fused", "pallas"):
            ref, want = counted(lambda: p.render(variant=variant))
            for name, mesh in (("1", mesh1), (str(SHARDS), meshn)):
                img, got = counted(lambda: sharded_frame(p, mesh, variant))
                err = (img - ref).abs().max().item()
                expect = {k: n * mesh.size for k, n in want.items()}
                rec[f"{variant}_{name}"] = {"max_abs_err": err, "bit_equal": torch.equal(img, ref),
                                            "launches": got, "render_launches": want}
                check(f"sharded/{tag}/{variant}/{name}", err <= SHARD_ATOL,
                      f"max |sharded - render()| {err}")
                check(f"sharded/{tag}/{variant}/{name}", got == expect,
                      f"launches {got}, expected {expect}")
                del img
            if variant == "fused":
                frame_ref = ref
        # a one-rank NCCL group: the frame through the all-gather
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        distributed.initialize(f"localhost:{port}", num_processes=1, process_id=0)
        try:
            gmesh = sharded.make_mesh(1)
            img = sharded_frame(p, gmesh, "fused")
            torch.cuda.synchronize()
            rec["nccl_one_rank"] = {"backend": torch.distributed.get_backend(),
                                    "distributed": gmesh.distributed,
                                    "bit_equal": torch.equal(img, frame_ref)}
            check(f"sharded/{tag}/nccl", gmesh.distributed and rec["nccl_one_rank"]["bit_equal"]
                  and rec["nccl_one_rank"]["backend"] == "nccl",
                  f"the one-rank group's frame: {rec['nccl_one_rank']}")
        finally:
            distributed.shutdown()
        check(f"sharded/{tag}/nccl", not distributed.active(), "the group outlived the phase")
        # the fused frames in turns: render(), 1 shard, SHARDS shards
        fns = {"render": lambda: p.render(variant="fused"),
               "sharded_1": lambda: sharded_frame(p, mesh1, "fused"),
               f"sharded_{SHARDS}": lambda: sharded_frame(p, meshn, "fused")}
        order = list(fns) + list(fns)[::-1]
        runs = {k: [] for k in fns}
        for k in order:
            runs[k].append(time_ms(fns[k], 3, 20)["median"])
        rec["ms"] = {k: statistics.median(v) for k, v in runs.items()}
        rec["ms_turns"] = runs
        rec["overhead"] = {k: rec["ms"][k] / rec["ms"]["render"] - 1.0
                           for k in fns if k != "render"}
        emit(rec)

    # the sharded training step against one device, with the defaults
    p = pipes["mxu"]
    T = p.tables
    W, H = SHARD_STEP_SIZE
    rec = {"phase": "sharded", "case": "train", "card": card, "size": f"{W}x{H}",
           "bounces": DIFF_BOUNCES, "lr": DIFF_LR}
    steps = {}
    for name, mesh in (("one", None), ("two", sharded.make_mesh(devices=["cuda:0"] * 2))):
        step, prep = sharded.make_train_step(
            p.scene, mesh, W, H, bounces=DIFF_BOUNCES, lr=DIFF_LR, variant="pallas",
            tracer_data=T.packed_dev, leaf_size=T.leaf_size, stack_depth=T.stack_depth,
            slot_map=p.flat.slot_map, compressed=T.compressed, device=p.device)
        args = prep()
        (v1, loss), got = counted(lambda: step(*args))
        steps[name] = (v1, loss, got)
        rec[f"{name}_launches"] = got
        rec[f"{name}_step_ms"] = time_ms(lambda: step(*args), DIFF_WARMUP, DIFF_TIMED)
        del step, prep, args
    (v1, l1, g1), (v2, l2, g2) = steps["one"], steps["two"]
    rec["loss"] = {"one": l1.item(), "two": l2.item(), "abs_diff": abs(l2.item() - l1.item())}
    rec["verts_max_abs_diff"] = (v2 - v1).abs().max().item()
    rec["step_ratio"] = rec["two_step_ms"]["median"] / rec["one_step_ms"]["median"]
    check("sharded/train", rec["loss"]["abs_diff"] <= SHARD_STEP_LOSS_ATOL
          and rec["verts_max_abs_diff"] <= SHARD_STEP_VERTS_ATOL
          and bool(torch.isfinite(v2).all()) and l1.item() > 0,
          f"two shards against one device: loss {rec['loss']}, verts "
          f"{rec['verts_max_abs_diff']}")
    check("sharded/train", bool(g1) and g2 == {k: 2 * n for k, n in g1.items()},
          f"launches {g2}, expected twice {g1}")
    emit(rec)
    del steps, v1, v2

    # the checkpointed banded render, then a stopped run resumed
    c = p.cfg
    rec = {"phase": "sharded", "case": "bands", "card": card, "band_rows": SHARD_BAND_ROWS}
    frame_ref, frame_launch = counted(lambda: p.render(variant="fused"))
    ref_np = frame_ref.cpu().numpy()
    band_calls = []

    def band(y0, rows):
        band_calls.append((y0, rows))
        return p.render_band(y0, max(rows, c.tile_rows), variant="fused")

    with tempfile.TemporaryDirectory() as tmp:
        ck = TileRenderCheckpoint(os.path.join(tmp, "frame.npz"), c.width, c.height,
                                  SHARD_BAND_ROWS)
        t0 = time.perf_counter()
        (img, got) = counted(lambda: ck.run(band))
        rec["checkpointed_run_s"] = time.perf_counter() - t0
        rec["bands"] = list(band_calls)
        rec["launches"] = got
        frame_key = next(iter(frame_launch))
        check("sharded/bands", np.array_equal(img, ref_np) and got == {frame_key: ck.n_bands},
              f"banded frame bit for bit: {np.array_equal(img, ref_np)}, launches {got}")

        # a run that stops after some bands, then the resume
        ck2 = TileRenderCheckpoint(os.path.join(tmp, "resume.npz"), c.width, c.height,
                                   SHARD_BAND_ROWS)

        def stopping(y0, rows):
            if len(band_calls) >= SHARD_BANDS_BEFORE_STOP:
                raise _Stop
            return band(y0, rows)

        band_calls.clear()
        try:
            ck2.run(stopping)
        except _Stop:
            pass
        first = list(band_calls)
        band_calls.clear()
        (img2, got2) = counted(lambda: ck2.run(band))
        rec["resume"] = {"first_run_bands": first, "resumed_bands": list(band_calls),
                         "launches": got2, "bit_equal": bool(np.array_equal(img2, ref_np))}
        missing = ck2.n_bands - SHARD_BANDS_BEFORE_STOP
        check("sharded/bands/resume", rec["resume"]["bit_equal"]
              and len(first) == SHARD_BANDS_BEFORE_STOP and len(band_calls) == missing
              and got2 == {frame_key: missing}
              and band_calls[-1][1] == c.height - (ck2.n_bands - 1) * SHARD_BAND_ROWS == 56,
              f"resume: {rec['resume']}")
    rec["banded_ms"] = time_ms(lambda: [p.render_band(y0, max(min(SHARD_BAND_ROWS, c.height - y0),
                                                              c.tile_rows), variant="fused")
                                        for y0 in range(0, c.height, SHARD_BAND_ROWS)], 3, 20)
    rec["render_ms"] = time_ms(lambda: p.render(variant="fused"), 3, 20)
    rec["banded_over_render"] = rec["banded_ms"]["median"] / rec["render_ms"]["median"]
    emit(rec)

    # a profiler trace of one sharded frame
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            with profiling.annotate("sharded_frame"):
                sharded_frame(p, mesh1, "fused")
            torch.cuda.synchronize()
        files = [f for f in os.listdir(tmp) if f.endswith(".pt.trace.json")]
        names = []
        if files:
            with open(os.path.join(tmp, files[0])) as f:
                names = [e.get("name", "") for e in json.load(f).get("traceEvents", [])]
    frame_events = [n for n in names if "frame_kernel" in n]
    check("sharded/profile", len(files) == 1 and frame_events and "sharded_frame" in names,
          f"trace files {files}, frame kernel events {len(frame_events)}")
    emit({"phase": "sharded", "case": "summary", "card": card,
          "profile": {"files": len(files), "events": len(names),
                      "frame_kernel_events": len(frame_events),
                      "frame_kernel": frame_events[:1]},
          "seconds": time.perf_counter() - t_phase})


# The packet phase: the packet traversal in torch ops (ops/trace_bvh.py,
# variant="jax"; no kernel) on the FP32 main path. First the band of
# PACKET_BAND rows from its y0 (which also makes the smaller buckets'
# CUDA graphs), then the 1080p frame with its passes' steps, timed with
# CUDA events: if that call took more than PACKET_ONE_CALL_S it is the one
# timed call, else PACKET_TIMED more follow; the band must be the frame's
# rows bit for bit, and the frame within tests/test_fused.py's frame bounds
# (more than 99% of pixels within 1e-3, median below 1e-5) of the
# pass-based render, with no kernel launched (the launch counts from 0).
# The frame at PACKET_PROFILE_BOUNCES bounce under the profiler (device
# kernels, idle share; no traversal kernel): the 4-bounce frame's million
# kernels took the profiler 28 s to stop and 10 s to read (NVIDIA H100
# 80GB HBM3, 700 W, and its host). The primary closest-hit pass and the
# first bounce's shadow rays against the kernels' (ops/cuda_trace.
# make_tracer): equal miss masks, t within PACKET_T_ATOL + PACKET_T_RTOL
# |t|, idx agreement >= PACKET_IDX_SHARE, blocked agreement >=
# PACKET_BLOCKED_SHARE. render_sharded over SHARDS shards of cuda:0 at
# PACKET_SMALL and PACKET_SMALL_BOUNCES bounce (four shards at 4 bounces
# took 16.5 s on the NVIDIA H100 80GB HBM3 at 700 W), render()'s frame
# there bit for bit; the training step at
# SHARD_STEP_SIZE against the FP32 pallas step within tests/test_torch_
# train.py's bounds for the pair; the command line with --variant jax at
# PACKET_SMALL and PACKET_SMALL_BOUNCES (render()'s BMP byte for byte) and
# with --interpret at
# PACKET_INTERPRET and one bounce (the kernels' frame through the same
# 8-bit BMP; its profiler trace holds no traversal kernel), both run while
# the in-process checks run.
PACKET_TIMED = 3
PACKET_ONE_CALL_S = 5.0
PACKET_BAND = (384, 256)
PACKET_SMALL = (480, 270)
PACKET_SMALL_BOUNCES = 1
PACKET_PROFILE_BOUNCES = 1
PACKET_INTERPRET = (64, 32)
PACKET_T_ATOL, PACKET_T_RTOL = 1e-4, 1e-5
PACKET_IDX_SHARE, PACKET_BLOCKED_SHARE = 0.999, 0.9999
PACKET_STEP_LOSS_RTOL, PACKET_STEP_VERTS_ATOL = 1e-6, 1e-6


def device_profile(fn) -> dict:
    """One call of fn under torch.profiler with CUDA activity only: its
    device kernels, busy and wall ms, idle share, and the seconds the
    profiler's stop and the reading took. It reads the raw kineto events (a
    frame of the packet traversal runs about a million kernels, too many
    for the profiler's Python event list)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    cuda = DeviceType.CUDA
    spans, names = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            start = e.start_ns()
            spans.append((start, start + e.duration_ns()))
            name = e.name()
            names[name] = names.get(name, 0) + 1
    t3 = time.perf_counter()
    out = {"wall_ms": (t1 - t0) * 1e3, "stop_s": t2 - t1, "read_s": t3 - t2}
    if not spans:
        return dict(out, device_time="not measured: the trace holds no device events")
    span = np.array(spans, np.float64)
    span = span[np.argsort(span[:, 0])]
    reach = np.maximum.accumulate(span[:, 1])
    starts = np.maximum(span[:, 0], np.concatenate([[-np.inf], reach[:-1]]))
    busy_ns = float(np.clip(span[:, 1] - starts, 0.0, None).sum())
    return dict(out, device_kernels=len(spans),
                traversal_kernels=sum(n for k, n in names.items() if TRAVERSAL_NAME.search(k)),
                device_busy_ms=busy_ns / 1e6, idle_share=1.0 - busy_ns / 1e6 / out["wall_ms"],
                top_kernels=dict(sorted(names.items(), key=lambda kv: -kv[1])[:5]))


def packet_phase(card: str, pipe, out_dir: str) -> None:
    """Phase `packet`: the packet traversal (ops/trace_bvh.py, variant="jax")
    on car_boxed 1080p, 4 bounces, the FP32 tables' pipeline; see the
    constants above."""
    from parallel_ray_tracer_tpu_torch.models.camera import ray_basis
    from parallel_ray_tracer_tpu_torch.ops import cuda_trace as ct
    from parallel_ray_tracer_tpu_torch.ops import render as R
    from parallel_ray_tracer_tpu_torch.ops import shade, trace_bvh
    from parallel_ray_tracer_tpu_torch.ops.intersect import T_MAX
    from parallel_ray_tracer_tpu_torch.parallel import sharded
    from parallel_ray_tracer_tpu_torch.utils.bmp import bmp_bytes, read_bmp

    t_phase = time.perf_counter()
    c, T = pipe.cfg, pipe.tables
    W, H = c.width, c.height
    K = c.tile_rows * c.tile_cols
    parts = {}

    def part(name, t0):
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0

    def timed_call(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def frame_bounds(name, a, b):
        diff = (a - b).abs()
        out = {"within_1e-3": (diff.amax(-1) < 1e-3).float().mean().item(),
               "median": diff.median().item(), "max": diff.max().item(),
               "bit_equal": torch.equal(a, b)}
        check(name, out["within_1e-3"] > 0.99 and out["median"] < 1e-5
              and a.std().item() > 0.01, f"frame bounds: {out}")
        return out

    # the command line, in the background of the phase: the processes'
    # start-up is host work, and the frames they trace are small
    small_w, small_h = PACKET_SMALL
    iw, ih = PACKET_INTERPRET
    prof_dir = tempfile.mkdtemp(prefix="packet_profile_", dir=out_dir)
    base = [sys.executable, "-m", "parallel_ray_tracer_tpu_torch", "--scene", c.scene,
            "--heuristic", str(c.bvh_heuristic), "--no-mxu-leaf", "--warmup", "0",
            "--iterations", "1"]
    clis = {"cli_jax": ["--variant", "jax", "--width", str(small_w), "--height",
                        str(small_h), "--bounces", str(PACKET_SMALL_BOUNCES)],
            "cli_interpret": ["--interpret", "--width", str(iw), "--height", str(ih),
                              "--bounces", "1", "--profile", prof_dir]}
    t_cli = time.perf_counter()
    procs = {name: subprocess.Popen(
        base + flags + ["--output", os.path.join(out_dir, f"packet_{name}.bmp")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE)
        for name, flags in clis.items()}


    rec = {"phase": "packet", "card": card, "size": f"{W}x{H}", "bounces": c.bounces,
           "packet": K, "nodes": pipe.flat.n_nodes, "depth": pipe.flat.depth,
           "stack_depth": pipe.stack_depth, "schedule": "masked",
           "graph_steps": trace_bvh.GRAPH_STEPS}
    # the band first: its call also makes the buckets up to its packets'
    t0 = time.perf_counter()
    y0, rows = PACKET_BAND
    band, rec["band_first_call_ms"] = timed_call(
        lambda: pipe.render_band(y0, rows, variant="jax"))
    part("band", t0)
    # the frame, with its passes' steps
    t0 = time.perf_counter()
    stats = []
    ct.reset_launch_counts()
    img, first_ms = timed_call(lambda: R.render_bvh_jax(
        pipe.ds, pipe.dbvh, pipe.camera(), W, H, bounces=c.bounces, leaf_size=pipe.leaf_size,
        stack_depth=pipe.stack_depth, tile_rows=c.tile_rows, tile_cols=c.tile_cols,
        fast_light=c.fast_light, reverse_shadows=c.reverse_shadows, stats=stats))
    runs = [first_ms]
    if first_ms <= PACKET_ONE_CALL_S * 1e3:
        for _ in range(PACKET_TIMED):
            again, ms = timed_call(lambda: pipe.render(variant="jax"))
            runs.append(ms)
            check("packet/frame", torch.equal(again, img), "render(variant=\"jax\") is not "
                  "the first call's frame")
        runs = runs[1:]
    rec["frame_ms"] = {"median": statistics.median(runs), "runs": runs,
                       "first_call_ms": first_ms,
                       "capture_s": sum(r.get("capture_s", 0.0) for r in stats)}
    rec["launches"] = {k: n for k, n in ct.LAUNCHES.items() if n}
    check("packet/frame", not rec["launches"], f"the frame launched kernels: {rec['launches']}")
    part("frame", t0)
    rec["passes"] = [{k: v for k, v in r.items() if k != "live"} | {
        "live_max": max(r["live"]), "live_at": [r["live"][i] for i in
                                                range(0, r["steps"], max(1, r["steps"] // 8))]}
        for r in stats]
    rec["steps"] = sum(r["steps"] for r in stats)
    rec["packet_visits"] = sum(r["visits"] for r in stats)
    rec["replays"] = sum(r.get("replays", 0) for r in stats)
    rec["ms_per_step"] = rec["frame_ms"]["median"] / rec["steps"]
    rec["band_bit_equal"] = torch.equal(band, img[y0:y0 + rows])
    check("packet/band", rec["band_bit_equal"], f"the {rows}-row band at {y0}")
    t0 = time.perf_counter()
    rec["vs_pallas"] = frame_bounds("packet/frame", img, pipe.render(variant="pallas"))
    pb = PACKET_PROFILE_BOUNCES
    pstats = []
    rec["profile"] = device_profile(lambda: R.render_bvh_jax(
        pipe.ds, pipe.dbvh, pipe.camera(), W, H, bounces=pb, leaf_size=pipe.leaf_size,
        stack_depth=pipe.stack_depth, tile_rows=c.tile_rows, tile_cols=c.tile_cols,
        fast_light=c.fast_light, reverse_shadows=c.reverse_shadows, stats=pstats))
    rec["profile"].update(bounces=pb, steps=sum(r["steps"] for r in pstats),
                          replays=sum(r.get("replays", 0) for r in pstats))
    if rec["profile"].get("device_kernels"):
        rec["profile"]["kernels_per_step"] = (rec["profile"]["device_kernels"]
                                              / rec["profile"]["steps"])
    check("packet/frame", rec["profile"].get("traversal_kernels") == 0,
          f"the traversal kernels ran: {rec['profile']}")
    part("profile", t0)
    emit(rec)
    del band

    # the primary pass and the first bounce's shadow rays against the kernels
    t0 = time.perf_counter()
    rec = {"phase": "packet", "case": "passes", "card": card}
    o, d = R.generate_rays_tiled(ray_basis(pipe.camera(), W, H), W, H, c.tile_rows,
                                 c.tile_cols, device=pipe.device)
    pstats = []
    jc, jo = trace_bvh.make_tracer(pipe.dbvh, pipe.ds, pipe.leaf_size, pipe.stack_depth,
                                   packet=K, stats=pstats)
    kc, ko = ct.make_tracer(T.packed_dev, T.leaf_size, ds=pipe.ds, stack_depth=T.stack_depth,
                            dual=True, compressed=T.compressed)
    hj, hk = jc(o, d), kc(o, d)
    mj, mk = hj.t >= T_MAX, hk.t >= T_MAX
    both = ~mj & ~mk
    err = (hj.t[both] - hk.t[both]).abs()
    rec["closest"] = {"miss_equal": torch.equal(mj, mk), "hits": int(both.sum()),
                      "t_max_abs_err": err.max().item(),
                      "t_bit_equal_share": (hj.t == hk.t).float().mean().item(),
                      "idx_share": (hj.idx == hk.idx).float().mean().item()}
    check("packet/closest", rec["closest"]["miss_equal"]
          and bool((err <= PACKET_T_ATOL + PACKET_T_RTOL * hk.t[both].abs()).all())
          and rec["closest"]["idx_share"] >= PACKET_IDX_SHARE, f"{rec['closest']}")
    shadow = []

    def kernel_occluded(so, sd, m2):
        shadow.append((so, sd, m2))
        return ko(so, sd, m2)

    shade.trace_rays(pipe.ds, kc, kernel_occluded, o, d, 1, reverse_shadows=c.reverse_shadows)
    so, sd, m2 = shadow[0]
    bj, bk = jo(so, sd, m2), ko(so, sd, m2)
    rec["occluded"] = {"blocked_share": (bj == bk).float().mean().item(),
                       "blocked": int(bk.sum())}
    check("packet/occluded", rec["occluded"]["blocked_share"] >= PACKET_BLOCKED_SHARE
          and rec["occluded"]["blocked"] > 0, f"{rec['occluded']}")
    rec["passes"] = [{k: v for k, v in r.items() if k != "live"} for r in pstats]
    part("passes", t0)
    emit(rec)
    del o, d, hj, hk, so, sd, m2, bj, bk, shadow

    # the sharded frame, the training step
    rec = {"phase": "packet", "case": "entry_points", "card": card}
    t0 = time.perf_counter()
    small_pipe = dataclasses.replace(pipe, cfg=dataclasses.replace(
        c, bounces=PACKET_SMALL_BOUNCES))
    small, rec["small_ms"] = timed_call(
        lambda: small_pipe.render(variant="jax", width=small_w, height=small_h))
    meshn = sharded.make_mesh(devices=["cuda:0"] * SHARDS)
    shards, rec["sharded_ms"] = timed_call(lambda: sharded.render_sharded(
        pipe.ds, pipe.dbvh, pipe.camera(), small_w, small_h, meshn,
        bounces=PACKET_SMALL_BOUNCES,
        leaf_size=pipe.leaf_size, stack_depth=pipe.stack_depth, tile_rows=c.tile_rows,
        tile_cols=c.tile_cols, variant="jax", fast_light=c.fast_light,
        reverse_shadows=c.reverse_shadows))
    rec["sharded_bit_equal"] = torch.equal(shards, small)
    check("packet/sharded", rec["sharded_bit_equal"] and small.std().item() > 0.01,
          f"render_sharded over {SHARDS} shards against render() at {small_w}x{small_h}")
    part("sharded", t0)
    t0 = time.perf_counter()
    sw, sh = SHARD_STEP_SIZE
    step_j, prep = sharded.make_train_step(
        pipe.scene, None, sw, sh, bounces=DIFF_BOUNCES, lr=DIFF_LR, variant="jax",
        tracer_data=pipe.dbvh, leaf_size=pipe.leaf_size, stack_depth=pipe.stack_depth,
        slot_map=pipe.flat.slot_map, device=pipe.device)
    step_p, _ = sharded.make_train_step(
        pipe.scene, None, sw, sh, bounces=DIFF_BOUNCES, lr=DIFF_LR, variant="pallas",
        tracer_data=T.packed_dev, leaf_size=T.leaf_size, stack_depth=T.stack_depth,
        slot_map=pipe.flat.slot_map, compressed=T.compressed, device=pipe.device)
    args = prep()
    (vj, lj), rec["train_jax_step_ms"] = timed_call(lambda: step_j(*args))
    vp, lp = step_p(*args)
    rec["train"] = {"size": f"{sw}x{sh}", "loss_jax": lj.item(), "loss_pallas": lp.item(),
                    "loss_abs_diff": abs(lj.item() - lp.item()),
                    "verts_max_abs_diff": (vj - vp).abs().max().item()}
    check("packet/train", rec["train"]["loss_abs_diff"]
          <= PACKET_STEP_LOSS_RTOL * max(1.0, lp.item()) and lp.item() > 0
          and rec["train"]["verts_max_abs_diff"] <= PACKET_STEP_VERTS_ATOL,
          f"the jax step against the FP32 pallas step: {rec['train']}")
    del step_j, step_p, prep, args, vj, vp
    part("train", t0)

    # the command line's frames
    t0 = time.perf_counter()
    interp_pipe = dataclasses.replace(pipe, cfg=dataclasses.replace(c, width=iw, height=ih,
                                                                    bounces=1))
    want_interp = interp_pipe.render()
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        cli = {"rc": proc.returncode, "stdout_tail": out[-600:], "stderr_tail": err[-800:],
               "seconds_since_start": time.perf_counter() - t_cli}
        check(f"packet/{name}", proc.returncode == 0, f"exit {proc.returncode}: {err[-800:]}")
        path = os.path.join(out_dir, f"packet_{name}.bmp")
        if proc.returncode == 0 and os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read()
            if name == "cli_jax":
                cli["bmp_equal"] = data == bmp_bytes(small.cpu().numpy())
                check("packet/cli_jax", cli["bmp_equal"], "its BMP is not render()'s")
            else:
                # the kernels' frame through the same 8-bit BMP: the frame
                # bounds' 1e-3 is below one step of 1/255, so more than 99%
                # of the pixels must have the same bytes
                got = read_bmp(path)
                with tempfile.NamedTemporaryFile(suffix=".bmp", dir=out_dir) as f:
                    f.write(bmp_bytes(want_interp.cpu().numpy()))
                    f.flush()
                    mine = read_bmp(f.name)
                cli["bmp_equal"] = bool(np.array_equal(got, mine))
                cli["pixels_equal"] = float((got == mine).all(axis=-1).mean())
                check("packet/cli_interpret", cli["pixels_equal"] > 0.99,
                      f"the --interpret frame against the kernels': {cli}")
                traces = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
                events = []
                if traces:
                    with open(os.path.join(prof_dir, traces[0])) as f:
                        events = json.load(f).get("traceEvents", [])
                kern = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
                cli["profile"] = {"traces": len(traces), "device_kernels": len(kern),
                                  "traversal_kernels": sum(bool(TRAVERSAL_NAME.search(k))
                                                           for k in kern)}
                check("packet/cli_interpret", len(traces) == 1 and kern
                      and cli["profile"]["traversal_kernels"] == 0,
                      f"its profiler trace: {cli['profile']}")
            os.remove(path)
        rec[name] = cli
    part("cli_wait", t0)
    rec["parts_s"] = parts
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)


def microbench_phase(card: str, out_dir: str, frame: dict) -> list:
    """Phase `microbench`: kernels A-D, the bf16 probes, the inner-visit and
    branch probes and the child-parallel and tensor-core visit probes of
    parallel_ray_tracer_tpu_torch/microbench against their plain versions,
    then the entry point's nine commands with the launch counts from 0, and
    the inner visit's cost set beside the width-4 frame kernel's time
    (`frame`: its timing record); returns their kernels-line rows."""
    from parallel_ray_tracer_tpu_torch import microbench as mb
    from parallel_ray_tracer_tpu_torch.microbench import bf16 as mb16
    from parallel_ray_tracer_tpu_torch.microbench import cond as mc
    from parallel_ray_tracer_tpu_torch.microbench import glue as mg
    from parallel_ray_tracer_tpu_torch.microbench import inner as mi
    from parallel_ray_tracer_tpu_torch.microbench import fixtures
    from parallel_ray_tracer_tpu_torch.microbench import mxu_inner as mm
    from parallel_ray_tracer_tpu_torch.microbench import mxu_leaf as ml
    from parallel_ray_tracer_tpu_torch.microbench import overlap as mo
    from parallel_ray_tracer_tpu_torch.microbench import probes as mp
    from parallel_ray_tracer_tpu_torch.microbench import tiled as mt
    from parallel_ray_tracer_tpu_torch.microbench.__main__ import THREADS_PER_SM, WARPS_PER_SM
    from parallel_ray_tracer_tpu_torch.microbench.__main__ import main as mb_main
    from parallel_ray_tracer_tpu_torch.ops.intersect import T_MAX

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = sms * THREADS_PER_SM
    n_warps = sms * WARPS_PER_SM

    def agree(a, b):
        return (a == b).float().mean().item() if a.numel() else 1.0

    def vs_plain(name, k, p, exact, rel_max=True):
        """k, p: {"t": ..., other outputs}. Exact: every output bit for bit.
        Otherwise the mxu phase's bounds against the plain MXU version:
        miss and every other output agreeing on >= 0.9999 of the threads
        (idx where both hit), and where both hit with the same idx a
        relative t error of mean < 1e-6 and max < 1e-5; with rel_max False
        the relative bound takes a floor, |dt| <= 1e-6 + 1e-5 |t|, for
        fixtures of random C rows whose smallest t are ill-conditioned (a
        relative error of 1.15e-5 at |dt| near 1e-7; the largest |dt| of
        the overlap fixture is 9.5e-7)."""
        mk, mpl = k["t"] >= T_MAX, p["t"] >= T_MAX
        both = ~mk & ~mpl
        err = (k["t"] - p["t"]).abs()[both]
        res = {"max_abs_err": err.max().item() if err.numel() else 0.0,
               "miss_agree": agree(mk, mpl)}
        if exact:
            same = all(torch.equal(k[x], p[x]) for x in k)
            check(name, same, "not its plain version bit for bit")
            return dict(res, equal=same)
        check(name, res["miss_agree"] >= 0.9999, f"miss agreement {res['miss_agree']}")
        same = both
        for x in k:
            if x != "t":
                a = agree(k[x][both], p[x][both]) if x == "idx" else agree(k[x], p[x])
                res[f"{x}_agree"] = a
                check(name, a >= 0.9999, f"{x} agreement {a}")
                if x == "idx":
                    same = both & (k[x] == p[x])
        dt = (k["t"] - p["t"]).abs()[same]
        rel = dt / p["t"][same].abs().clamp(min=1e-9)
        res["rel_t_mean"] = rel.mean().item() if rel.numel() else 0.0
        res["rel_t_max"] = rel.max().item() if rel.numel() else 0.0
        check(name, res["rel_t_mean"] < 1e-6, f"relative t error mean {res['rel_t_mean']}")
        if rel_max:
            check(name, res["rel_t_max"] < 1e-5, f"relative t error max {res['rel_t_max']}")
        else:
            within = bool((dt <= 1e-6 + 1e-5 * p["t"][same].abs()).all())
            check(name, within, "t beyond 1e-6 + 1e-5 |t|")
        return res

    # kernel A: every instance at every D, and the accuracy fixtures
    t0 = time.perf_counter()
    tab = ml.rand_tables(dev)
    leaf_cmp = {}
    for mode, full, layout, c_in_a in sorted(ml.INSTANCES):
        for dd in ml.DISTINCT:
            kw = dict(iters=MB_ITERS, n=n, full=full, distinct=dd)
            tk, ik = ml.leaf_visits(tab, mode, layout=layout, c_in_a=c_in_a, **kw)
            tp_, ip = ml.leaf_plain(tab, mode, **kw)
            name = (f"microbench/leaf/{mode}{',full' if full else ''},{layout}"
                    f"{',c_in_a' if c_in_a else ''},D{dd}")
            leaf_cmp[name] = vs_plain(name, {"t": tk, "idx": ik}, {"t": tp_, "idx": ip},
                                      mode not in ml.MXU_MODES)
    accuracy = {}
    for dense in (True, False):
        atab = ml.accuracy_tables(dense, dev)
        for mode in ml.MODES:
            name = f"microbench/accuracy/{'dense' if dense else 'random'}/{mode}"
            tk, ik = ml.leaf_visits(atab, mode, iters=1, full=True)
            tp_, ip = ml.leaf_plain(atab, mode, iters=1, full=True)
            leaf_cmp[name] = vs_plain(name, {"t": tk, "idx": ik}, {"t": tp_, "idx": ip},
                                      mode not in ml.MXU_MODES)
        accuracy["dense" if dense else "random"] = ml.accuracy(dense, dev)
    emit({"phase": "microbench", "case": "leaf_vs_plain", "card": card, "n": n,
          "iters": MB_ITERS, "seconds": time.perf_counter() - t0, "compare": leaf_cmp,
          "accuracy_on_card": accuracy})

    # kernels B and C
    t0 = time.perf_counter()
    optin = mp.smem_optin()
    sweep = mp.stage_sweep(dev, optin)
    for r in sweep:
        name = f"microbench/stage/{r['layout']}/{r['bytes']}"
        if r["bytes"] <= optin:
            check(name, r["attr_rc"] == 0 and r["launch_rc"] == 0 and r["read_back_equal"],
                  f"a size within the limit did not stage: {r}")
        else:
            check(name, r["launch_rc"] != 0 and r["attr_rc"] != 0,
                  f"a size past the limit launched: {r}")
    gt = mp.gather_table(MB_GATHER_MB, dev)
    starts = mp.gather_starts(gt.shape[0], n_warps, dev)
    lk, sk = mp.gather(gt, starts, MB_ITERS)
    lp, sp_ = mp.gather_plain(gt, starts, MB_ITERS)
    gather_eq = torch.equal(lk, lp) and torch.equal(sk, sp_)
    check("microbench/gather", gather_eq, "chains or sums differ from the plain version")
    emit({"phase": "microbench", "case": "probes_vs_plain", "card": card,
          "seconds": time.perf_counter() - t0, "optin_bytes": optin,
          "sweep": [{k: r[k] for k in ("bytes", "layout", "attr_rc", "launch_rc",
                                         "read_back_equal")} for r in sweep],
          "gather_equal": gather_eq})

    # kernel D
    t0 = time.perf_counter()
    otab = mo.overlap_tables(dev)
    over_cmp = {}
    for body, (inner, leaf, _) in mo.BODIES.items():
        rk = mo.overlap_iters(otab, body, MB_ITERS, n)
        rp = mo.overlap_plain(otab, body, MB_ITERS, n)
        over_cmp[body] = vs_plain(f"microbench/overlap/{body}", rk, rp, leaf == 0, False)
    emit({"phase": "microbench", "case": "overlap_vs_plain", "card": card, "n": n,
          "seconds": time.perf_counter() - t0, "compare": over_cmp})

    # rows 15e-15h: every chain instance on the full grid against its plain
    # version at K = MB_ITERS, bit for bit (f32 and bf16 alike: each op
    # rounds once to the tile's type in both); the slab pairs' e exactly,
    # on the script's rays and on normal rays
    t0 = time.perf_counter()
    blocks = sms * mb16.BLOCKS_PER_SM
    n16 = blocks * mb16.CHAIN_THREADS
    bf16_cmp = {}
    for case, (op, rows, is_bf16, ilp) in mb16.CHAIN_CASES.items():
        a, b = mb16.chain_inputs(rows, is_bf16, dev)
        tk = mb16.chain(a, b, op, MB_ITERS, ilp, blocks)
        tp_ = mb16.chain_plain(a, b, op, MB_ITERS, ilp)
        kb = tk.view(torch.int16 if is_bf16 else torch.int32)
        pb = tp_.view(torch.int16 if is_bf16 else torch.int32)
        equal = bool((kb == pb[None]).all())
        fin = torch.isfinite(tp_.float())
        err = (tk.float() - tp_.float()[None]).abs()[:, fin]
        bf16_cmp[case] = {"equal": equal, "max_abs_err": err.max().item() if err.numel() else 0.0,
                          "finite_frac": fin.float().mean().item(),
                          "script_output": mb16.script_output(tp_)}
        check(f"microbench/bf16/{case}", equal, "not its plain version bit for bit")
    srows, splanes = mb16.slab_inputs(dev)
    normal = tuple(torch.as_tensor(p.reshape(-1), device=dev) for p in fixtures.overlap_rays())
    for case, is_bf16 in mb16.SLAB_CASES.items():
        for rays, planes in (("script", splanes), ("normal", normal)):
            for k in MB_SLAB_CHECK_ITERS:
                ek = mb16.slab(srows, planes, is_bf16, k, n16)
                ep = mb16.slab_plain(srows, planes, is_bf16, k, 32, n16)
                equal = torch.equal(ek, ep)
                bf16_cmp[f"{case}/{rays}/K{k}"] = {
                    "equal": equal, "max_abs_err": float((ek - ep).abs().max()),
                    "branched_frac": (ep != k).float().mean().item()}
                check(f"microbench/bf16/{case}/{rays}/K{k}", equal,
                      "e differs from the plain version's")
    emit({"phase": "microbench", "case": "bf16_vs_plain", "card": card, "blocks": blocks,
          "n": n16, "iters": MB_ITERS, "seconds": time.perf_counter() - t0,
          "compare": bf16_cmp})

    # rows 15i, 15j: every instance on the full grid against its plain
    # version at K = MB_INNER_CHECK_ITERS, bit for bit (e, acc, top; the
    # tensor-core leaf's acc to its bound); the plain results are shared by
    # the instances of one body, npop and packet (twins, placements) and by
    # the glue bodies of one plain version (glue.SEMANTICS)
    t0 = time.perf_counter()
    ptab = mi.probe_tables(dev)
    inner_cmp, plain_of = {}, {}
    for inst in mi.inner_instances() + mg.glue_instances():
        glue_row = inst.row == "glue"
        sem = mg.SEMANTICS.get(inst.body, inst.body) if glue_row else inst.body
        for k in MB_INNER_CHECK_ITERS:
            key = (inst.row, sem, inst.npop, inst.packet, k)
            if key not in plain_of:
                plain_of[key] = (mg.glue_plain(ptab, sem, inst.npop, k, inst.packet, n)
                                 if glue_row else mi.inner_plain(ptab, sem, k, inst.packet, n))
            p = plain_of[key]
            r = (mg.probe(ptab, inst.body, inst.npop, k, inst.packet, n, inst.stack, inst.meta)
                 if glue_row else
                 mi.probe(ptab, inst.body, k, inst.packet, n, inst.stack, inst.meta))
            res = {"e_equal": torch.equal(r["e"], p["e"]), "top_equal": torch.equal(r["top"], p["top"]),
                   "acc_equal": torch.equal(r["acc"].view(torch.int32), p["acc"].view(torch.int32)),
                   "e_distinct": int(p["e"].unique().numel())}
            fin = torch.isfinite(p["acc"])
            err = (r["acc"] - p["acc"]).abs()[fin]
            res["max_abs_err"] = err.max().item() if err.numel() else 0.0
            name = f"microbench/{inst.name}/K{k}"
            check(name, res["e_equal"] and res["top_equal"], "e or top differ from the plain version")
            if inst.body in mi.LEAF_BODIES:
                res["acc_within"] = bool(
                    torch.equal(fin, torch.isfinite(r["acc"]))
                    and (err <= k * 1e-6 + 1e-5 * p["acc"].abs()[fin]).all())
                check(name, res["acc_within"], "acc beyond K 1e-6 + 1e-5 |acc|")
            else:
                check(name, res["acc_equal"], "acc not its plain version's bits")
            inner_cmp[name] = res
    # row 15l: every shape in both cases, e and each thread's maximum exactly
    ctile = mc.tile(dev)
    for shape in mc.SHAPES:
        for uniform in (False, True):
            for k in MB_INNER_CHECK_ITERS:
                r = mc.cond(ctile, shape, uniform, k, n)
                p = mc.cond_plain(ctile, uniform, k, n)
                same = torch.equal(r["e"], p["e"]) and torch.equal(r["max"], p["max"])
                name = f"microbench/{mc.instance(shape, uniform)}/K{k}"
                inner_cmp[name] = {"equal": same, "max_abs_err": float((r["max"] - p["max"]).abs().max()),
                                   "e_distinct": int(p["e"].unique().numel())}
                check(name, same, "not its plain version bit for bit")
    emit({"phase": "microbench", "case": "inner_vs_plain", "card": card, "n": n,
          "iters": MB_INNER_CHECK_ITERS, "seconds": time.perf_counter() - t0,
          "compare": inner_cmp})

    # rows 15k, 15m: every instance on the full grid against its plain
    # version at K = MB_INNER_CHECK_ITERS, on the scripts' tables and on the
    # grown ones (fixtures.GROW: the packets hit every child, so the sums
    # are finite and e branches): e, acc and (15m) top bit for bit; the
    # tensor-core bodies' acc (L) within the Lf bound, K 1e-6 + 1e-5 |acc|
    # (their products sum in the tensor cores' order; acc_bits_equal says
    # whether they matched to the bit all the same)
    t0 = time.perf_counter()
    visit_tabs = {"tiled": {"script": ptab, "grown": mt.grown_tables(dev)},
                  "mxu_inner": {"script": mm.mxu_tables(dev),
                                "grown": mm.mxu_tables(dev, grow=fixtures.GROW)}}
    visit_cmp = {}
    for row, mod in (("tiled", mt), ("mxu_inner", mm)):
        for which, vtab in visit_tabs[row].items():
            plain_of = {}
            for body in mod.BODIES:
                sem = mt.SEMANTICS.get(body, body) if row == "tiled" else body
                for p in mod.PACKETS[body]:
                    for k in MB_INNER_CHECK_ITERS:
                        if (sem, p, k) not in plain_of:
                            plain_of[sem, p, k] = (
                                mt.tiled_plain(vtab, sem, k, p, n) if row == "tiled"
                                else mm.mxu_inner_plain(vtab, sem, k, p, n))
                        q = plain_of[sem, p, k]
                        r = mod.probe(vtab, body, k, p, n)
                        fin = torch.isfinite(q["acc"])
                        err = (r["acc"] - q["acc"]).abs()[fin]
                        res = {"e_equal": torch.equal(r["e"], q["e"]),
                               "top_equal": "top" not in q or torch.equal(r["top"], q["top"]),
                               "acc_bits_equal": torch.equal(r["acc"].view(torch.int32),
                                                             q["acc"].view(torch.int32)),
                               "e_distinct": int(q["e"].unique().numel()),
                               "finite": float(fin.float().mean()),
                               "max_abs_err": err.max().item() if err.numel() else 0.0}
                        name = f"microbench/{mod.instance(body, p)}/{which}/K{k}"
                        check(name, res["e_equal"] and res["top_equal"],
                              "e or top differ from the plain version")
                        if row == "mxu_inner" and body in mm.MXU_BODIES:
                            res["acc_within"] = bool(
                                torch.equal(fin, torch.isfinite(r["acc"]))
                                and (err <= k * 1e-6 + 1e-5 * q["acc"].abs()[fin]).all())
                            check(name, res["acc_within"], "acc beyond K 1e-6 + 1e-5 |acc|")
                        else:
                            check(name, res["acc_bits_equal"], "acc not its plain version's bits")
                        visit_cmp[name] = res
    emit({"phase": "microbench", "case": "visit_forms_vs_plain", "card": card, "n": n,
          "iters": MB_INNER_CHECK_ITERS, "grow": fixtures.GROW,
          "seconds": time.perf_counter() - t0, "compare": visit_cmp})

    # the entry point, each command with the counts from 0
    mb_out = os.path.join(out_dir, "microbench")
    launches, runs, instances = {}, {}, {}
    for cmd, kernels in MB_COMMANDS.items():
        mb.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = mb_main([cmd, "--out", mb_out])
        torch.cuda.synchronize()
        counts = dict(mb.LAUNCHES)
        want = {"bf16": mb16.INSTANCES | {mb16.slab_instance(f) for f in mb16.SLAB_CASES.values()},
                "inner": mi.INSTANCES, "glue": mg.INSTANCES, "cond": mc.INSTANCES,
                "tiled": mt.INSTANCES, "mxu_inner": mm.INSTANCES}.get(cmd)
        if want is not None:
            got = dict(mb.INSTANCE_LAUNCHES)
            instances.update(got)
            check(f"microbench/{cmd}", set(got) == want and min(got.values()) > 0,
                  f"instances launched {sorted(got)}, missing {sorted(want - set(got))}")
        check(f"microbench/{cmd}", rc == 0, f"exit {rc}")
        check(f"microbench/{cmd}", all(counts[k] > 0 for k in kernels)
              and all(v == 0 for k, v in counts.items() if k not in kernels),
              f"launches {counts}")
        launches.update({k: counts[k] for k in kernels})
        emit({"phase": "launches", "path": f"microbench {cmd}",
              "seconds": time.perf_counter() - t0, "launches": counts})
        with open(os.path.join(mb_out, f"{cmd}.json")) as f:
            runs[cmd] = json.load(f)["records"]

    # traps 1 and 2 (csrc/microbench_inner.cuh, csrc/microbench_cond.cu,
    # csrc/microbench_mxu_inner.cu): every 15i-15m instance has its SASS
    # counts; each push body keeps a store per push and iteration (STL, or
    # STS for a shared stack); the cond arms keep their branches
    for cmd, want in (("inner", mi.INSTANCES), ("glue", mg.INSTANCES), ("cond", mc.INSTANCES),
                      ("tiled", mt.INSTANCES), ("mxu_inner", mm.INSTANCES)):
        got = {r["instance"] for r in runs[cmd] if r.get("sass")}
        check(f"microbench/{cmd}/sass", got == want, f"no SASS counts for {sorted(want - got)}")
    for r in runs["inner"] + runs["glue"]:
        if r.get("sass"):
            pushes = (mi.PUSHES.get(r["body"], 0) if r["row"] == "inner"
                      else mg.pushes(r["body"], r["npop"]))
            op = "STS" if r["stack"] == "shared" else "STL"
            check(f"microbench/{r['instance']}/sass", r["sass"][op] >= pushes,
                  f"{r['sass'][op]} {op} for {pushes} pushes an iteration")
    for r in runs["mxu_inner"]:
        if r.get("sass") and r["body"] in mm.PUSHES:
            check(f"microbench/{r['instance']}/sass", r["sass"]["STL"] >= mm.PUSHES[r["body"]],
                  f"{r['sass']['STL']} STL for {mm.PUSHES[r['body']]} pushes an iteration")
    bra = {r["instance"]: r["sass"]["BRA"] for r in runs["cond"] if r.get("sass")}
    for uniform in (False, True):
        b = {shape: bra.get(mc.instance(shape, uniform), 0) for shape in mc.SHAPES}
        check("microbench/cond/sass", b["straight"] < b["cond1"] < b["cond2_nested"]
              and b["straight"] < b["switch4"], f"branches {b}")

    # the readings, one line per probe
    recs = runs["mxu_leaf"]
    timed = [r for r in recs if "ns_per_1024_rays" in r]
    sweep_d = {}
    for r in timed:
        if r["stage"] == "v5":
            sweep_d.setdefault(r["mode"], {})[r["distinct"]] = r["ns_per_1024_rays"]
    emit({"phase": "microbench", "case": "mxu_leaf", "card": card, "n": n,
          "ns_per_1024_rays": {f"{r['stage']}/{r['mode']}{',full' if r['full'] else ''}"
                               f"{'/' + r['layout'] if r['layout'] else ''}"
                               f"{'/' + r['placement'] if r['placement'] else ''}"
                               f"/D{r['distinct']}": r["ns_per_1024_rays"] for r in timed},
          "clocks_sm_mhz": sorted({r["marginal"]["clocks_sm_mhz"] for r in timed}),
          "bf16x3_over_mt_by_lanes_per_batch": {
              32 // dd: sweep_d["bf16x3"][dd] / sweep_d["mt"][dd] for dd in ml.DISTINCT},
          "accuracy": {r["accuracy"]: r["table"] for r in recs if "table" in r}})
    stage_rec = runs["probes"][0]
    gathers = [r for r in runs["probes"] if r.get("probe") == "gather"]
    emit({"phase": "microbench", "case": "probes", "card": card,
          "optin_bytes": stage_rec["optin_bytes"], "groups_per_block": stage_rec["groups_per_block"],
          "largest_fitting": stage_rec["largest_fitting"],
          "gather_ns_per_block": {r["table_mb"]: r["ns_per_block"] for r in gathers},
          "gather_gb_per_s": {r["table_mb"]: r["gb_per_s"] for r in gathers},
          "clocks_sm_mhz": sorted({r["marginal"]["clocks_sm_mhz"] for r in gathers})})
    b16 = runs["bf16"]
    emit({"phase": "microbench", "case": "bf16", "card": card,
          "ns_per_op_per_1024": {r["case"]: r["ns_per_op_per_1024"] for r in b16
                                 if "ns_per_op_per_1024" in r},
          "ns_per_op": {r["case"]: r["ns_per_op"] for r in b16 if "ns_per_op" in r},
          "ns_per_visit_per_1024": {r["case"]: r["ns_per_visit_per_1024"] for r in b16
                                    if "ns_per_visit_per_1024" in r},
          "ratios_bf16x2_over_f32": next(r for r in b16 if "ratios_bf16x2_over_f32" in r)[
              "ratios_bf16x2_over_f32"],
          "clocks_sm_mhz": sorted({r["marginal"]["clocks_sm_mhz"] for r in b16
                                   if "marginal" in r})})
    overs = runs["overlap"]
    emit({"phase": "microbench", "case": "overlap", "card": card,
          "ns_per_iteration": {f"{r['body']}@{r['blocks_per_sm']}": r["ns_per_iteration"]
                               for r in overs if "body" in r},
          "overlap": {r["blocks_per_sm"]: r["overlap"] for r in overs if "overlap" in r},
          "clocks_sm_mhz": sorted({r["marginal"]["clocks_sm_mhz"] for r in overs if "body" in r})})

    # rows 15i, 15j, 15l: the readings, the breakdown of one arity-4 inner
    # visit at packet 1 and its share of the width-4 frame kernel
    def per_1024(recs):
        return {r["instance"] + (f"@{r['twin_of']}" if r.get("twin_of") else ""):
                r["ns_per_1024_rays"] for r in recs if "ns_per_1024_rays" in r}

    irecs, grecs, crecs = runs["inner"], runs["glue"], runs["cond"]
    p1 = {r["body"]: r["ns_per_1024_rays"] for r in irecs
          if r.get("packet") == 1 and r["stack"] == "local" and not r.get("twin_of")
          and r["meta"] == ("shared" if r["body"] in mi.SMEM_META else "global")}
    g_shared = {r["npop"]: r["ns_per_1024_rays"] for r in grecs
                if r.get("body") == "full" and r["packet"] == 1 and r["stack"] == "shared"}
    g_twin = {r["npop"]: r["ns_per_1024_rays"] for r in grecs
              if r.get("body") == "full" and r["packet"] == 1 and r.get("twin_of") == "stack=shared"}
    g_stack = {r["instance"] + (f"@{r['twin_of']}" if r.get("twin_of") else ""):
               r["ns_per_1024_rays"] for r in irecs if r.get("body") == "G" and r["packet"] == 1}
    comps = {f"npop{r['npop']}/p{r['packet']}": r["components"] for r in grecs if "components" in r}
    breakdown = {"row_load_J": p1["J"], "slab_const_boxes_N": p1["N"], "vector_B": p1["B"],
                 "meta8_D": p1["D"], "meta4_H": p1["H"], "sort_F": p1["F"],
                 "push_G_local": p1["G"], "push_G_local_at_shared_occupancy":
                     next(v for k, v in g_stack.items() if k.endswith("@stack=shared")),
                 "push_G_shared": g_stack["inner<G,p1,stack=shared>"],
                 "full_visit_A": p1["A"], "glue_full_shared_stacks": g_shared,
                 "glue_full_local_at_shared_occupancy": g_twin,
                 "glue_components_p1": {k: v for k, v in comps.items() if k.endswith("/p1")}}
    visits = frame["inner_visits"]
    share = {"frame_ms": frame["median"], "inner_visits": visits,
             "A_ms": visits * p1["A"] / 1024 * 1e-6, "M_per_node_ms": visits * p1["M"] / 2048 * 1e-6}
    share["A_share_of_frame"] = share["A_ms"] / frame["median"]
    emit({"phase": "microbench", "case": "inner", "card": card, "n": n,
          "ns_per_1024_rays": per_1024(irecs),
          "occupancy": {r["instance"] + (f"@{r['twin_of']}" if r.get("twin_of") else ""):
                        r["threads_per_sm"] for r in irecs if "threads_per_sm" in r},
          "sass": {r["instance"]: r["sass"] for r in irecs if r.get("sass")},
          "breakdown_p1_ns_per_1024_rays": breakdown, "frame_share": share,
          "clocks_sm_mhz": sorted({r["marginal"]["clocks_sm_mhz"] for r in irecs if "marginal" in r})})
    emit({"phase": "microbench", "case": "glue", "card": card, "n": n,
          "ns_per_1024_rays": per_1024(grecs), "components": comps,
          "occupancy": {r["instance"] + (f"@{r['twin_of']}" if r.get("twin_of") else ""):
                        r["threads_per_sm"] for r in grecs if "threads_per_sm" in r},
          "sass": {r["instance"]: r["sass"] for r in grecs if r.get("sass")},
          "clocks_sm_mhz": sorted({r["marginal"]["clocks_sm_mhz"] for r in grecs if "marginal" in r})})
    for cmd in ("tiled", "mxu_inner"):
        recs = runs[cmd]
        emit({"phase": "microbench", "case": cmd, "card": card, "n": n,
              "ns_per_1024_rays": {r["instance"]: r["ns_per_1024_rays"] for r in recs
                                   if "ns_per_1024_rays" in r},
              "answers": next(r["answers"] for r in recs if "answers" in r),
              "sass": {r["instance"]: r["sass"] for r in recs if r.get("sass")},
              "spread": {r["instance"]: (r["marginal"]["ns_max"] - r["marginal"]["ns_min"])
                         / r["marginal"]["ns"] for r in recs if "marginal" in r},
              "clocks_sm_mhz": sorted({r["marginal"]["clocks_sm_mhz"] for r in recs
                                       if "marginal" in r})})
    emit({"phase": "microbench", "case": "cond", "card": card, "n": n,
          "ns_per_1024_elements": {r["instance"]: r["ns_per_1024_elements"] for r in crecs
                                   if "instance" in r},
          "costs": {r["case"]: {k: v for k, v in r.items() if k.endswith("_ns")}
                    for r in crecs if "case" in r},
          "sass": {r["instance"]: r["sass"] for r in crecs if r.get("sass")},
          "clocks_sm_mhz": sorted({r["marginal"]["clocks_sm_mhz"] for r in crecs if "marginal" in r})})

    # the kernels line: each kernel at one configuration of its run, its
    # plain version on the same inputs, its bound and (gather) the library
    def once_ms(fn):
        """A plain version's ms: one call after a warm-up call (a warm-up
        and 3 timed calls before the packet phase)."""
        fn()
        return time_ms(fn, 0, 1)["median"]

    def ops_bound(fp32_ops, tensor_ops, bytes_):
        t_ops = max(fp32_ops / PEAK_FP32_OPS, tensor_ops / PEAK_BF16_OPS) * 1e3
        t_bytes = bytes_ / PEAK_BYTES * 1e3
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def rate_bound(ops, bytes_):
        """FP32 operations over the FP32 rate plus bf16 element operations
        over the packed bf16 rate (one FMA pipe issues both), or the bytes
        over the memory rate, the larger."""
        t_ops = (ops.get("fp32", 0.0) / PEAK_FP32_OPS
                 + ops.get("bf16x2", 0.0) / PEAK_BF16X2_OPS) * 1e3
        t_bytes = bytes_ / PEAK_BYTES * 1e3
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def entry(key, ms, plain_ms, bound, err, library_ms=None, **extra):
        name, src, line = MB_KERNELS[key]
        return {"name": name, "route": "cuda",
                "source": f"parallel_ray_tracer_tpu_torch/csrc/{src}", "replaces": line,
                "launches": launches[key], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bound, "library_ms": library_ms, **extra}

    rows = []
    prod = next(r for r in timed if r["stage"] == "v5" and r["mode"] == "bf16x3"
                and r["distinct"] == 1)
    m = prod["marginal"]
    c = ml.Config("bf16x3", full=True)
    ops = ml.visit_ops(c)
    visits = m["k_hi"] * n
    rows.append(entry(
        "leaf", m["ms_hi"],
        once_ms(lambda: ml.leaf_plain(tab, "bf16x3", iters=m["k_hi"], n=n, full=True)),
        ops_bound(ops["fp32"] * visits, ops["tensor"] * visits,
                  nbytes(*tab.planes, tab.cmat) + 8 * n),
        max(v["max_abs_err"] for k, v in leaf_cmp.items() if "bf16x3" in k),
        iters=m["k_hi"], threads=n, ns_per_1024_rays=prod["ns_per_1024_rays"],
        config="bf16x3, full, interleaved, rays in A, D 1"))
    big = mp.group_table(optin // mp.BLOCK_BYTES, "bf16", dev)
    rows.append(entry(
        "stage", stage_rec["largest_fitting"]["ms"]["median"], once_ms(big.clone),
        ops_bound(0, 0, 2 * nbytes(big)), 0.0, bytes=nbytes(big)))
    visited = []
    mp.gather_plain(gt, starts, MB_GATHER_STEPS, visited)
    idx = torch.cat(visited)
    distinct = int(torch.unique(idx).numel())
    lib = lambda: gt.index_select(0, idx).view(MB_GATHER_STEPS, n_warps, -1).sum(dim=(0, 2))
    rows.append(entry(
        "gather", once_ms(lambda: mp.gather(gt, starts, MB_GATHER_STEPS)),
        once_ms(lambda: mp.gather_plain(gt, starts, MB_GATHER_STEPS)),
        ops_bound(0, 0, distinct * mp.BLOCK_BYTES + 8 * n_warps), 0.0,
        library_ms=once_ms(lib), table_mb=MB_GATHER_MB, steps=MB_GATHER_STEPS,
        warps=n_warps, distinct_blocks=distinct))
    del idx, visited, gt
    ob = next(r for r in overs if r.get("body") == "both_closest" and r["blocks_per_sm"] == 16)
    ops = mo.iteration_ops("both_closest")
    its = MB_OVERLAP_ITERS * n
    rows.append(entry(
        "overlap", once_ms(lambda: mo.overlap_iters(otab, "both_closest", MB_OVERLAP_ITERS, n)),
        once_ms(lambda: mo.overlap_plain(otab, "both_closest", MB_OVERLAP_ITERS, n)),
        ops_bound(ops["fp32"] * its, ops["tensor"] * its,
                  nbytes(*otab.planes, otab.cbox, otab.cmeta, otab.cmat) + 20 * n),
        over_cmp["both_closest"]["max_abs_err"], iters=MB_OVERLAP_ITERS, threads=n,
        ns_per_iteration=ob["ns_per_iteration"]))
    # rows 15e-15h: one row per instance, at MB_BF16_ROW_ITERS iterations
    # of the entry point's grid (kernel and plain version on the same
    # inputs), its bound the element operations over the FP32 rate or the
    # packed bf16 rate (the slab's bf16x2 and f32 operations both on the
    # FMA pipe, so their times add)
    kk = MB_BF16_ROW_ITERS
    by_case = {r["case"]: r for r in b16 if "case" in r}
    for case, (op, rows_, is_bf16, ilp) in mb16.CHAIN_CASES.items():
        a, b = mb16.chain_inputs(rows_, is_bf16, dev)
        ops = mb16.chain_ops(case, kk, blocks)
        inst = mb16.chain_instance(op, rows_, is_bf16, ilp)
        w = rows_ * 128 // (2 if is_bf16 else 1) // mb16.CHAIN_THREADS
        rows.append({
            "name": f"mb_chain_kernel<{'__nv_bfloat162' if is_bf16 else 'float'}, "
                    f"{'MB_FMS' if op == 'fms' else 'MB_MNX'}, {w}, {ilp}> ({case})",
            "route": "cuda", "source": "parallel_ray_tracer_tpu_torch/csrc/microbench_bf16.cu",
            "replaces": "scripts/microbench_bf16.py:"
                        f"{mb16.SCRIPT_LINE['chain1' if ilp == 1 else 'chain4']}",
            "launches": instances[inst], "max_abs_err": bf16_cmp[case]["max_abs_err"],
            "ms": time_ms(lambda: mb16.chain(a, b, op, kk, ilp, blocks), 2, 5)["median"],
            "plain_ms": once_ms(lambda: mb16.chain_plain(a, b, op, kk, ilp)),
            **rate_bound(ops, nbytes(a, b) * (1 + blocks)), "library_ms": None,
            "iters": kk, "blocks": blocks, "in_script": case not in mb16.NOT_IN_SCRIPT,
            "ns_per_op_per_1024": by_case[case]["ns_per_op_per_1024"]})
    for case, is_bf16 in mb16.SLAB_CASES.items():
        so = mb16.SLAB_OPS[is_bf16]
        ops = {"fp32": so["fp32"] * n16 * kk, "bf16x2": 2 * so["bf16x2"] * n16 * kk}
        rows.append({
            "name": f"mb_slab_kernel<{'true' if is_bf16 else 'false'}> ({case})", "route": "cuda",
            "source": "parallel_ray_tracer_tpu_torch/csrc/microbench_bf16.cu",
            "replaces": "scripts/microbench_bf16.py:"
                        f"{mb16.SCRIPT_LINE['slab_bf16' if is_bf16 else 'slab_f32']}",
            "launches": instances[mb16.slab_instance(is_bf16)],
            "max_abs_err": max(v["max_abs_err"] for k, v in bf16_cmp.items()
                               if k.startswith(case + "/")),
            "ms": time_ms(lambda: mb16.slab(srows, splanes, is_bf16, kk, n16), 2, 5)["median"],
            "plain_ms": once_ms(lambda: mb16.slab_plain(srows, splanes, is_bf16, kk, 32, n16)),
            **rate_bound(ops, nbytes(srows, *splanes) + 4 * n16 // 32), "library_ms": None,
            "iters": kk, "threads": n16,
            "ns_per_visit_per_1024": by_case[case]["ns_per_visit_per_1024"]})
    # rows 15i, 15j, 15l: one row per body (15i at packet 1, Lf at 32; 15j
    # at npop MB_GLUE_ROW_NPOP and packet 1) and per step shape and case
    # (15l), kernel and plain version at MB_INNER_ROW_ITERS iterations of
    # the grid of the checks; the bound is the body's FP32 operations (and
    # Lf's tensor-core products) over the peak rates, or over the memory
    # rate the bytes it must move: of its tables what this run reads, once
    # (the rows its e chains visit, from the plain version), and its
    # outputs (e, acc, top), once
    kk = MB_INNER_ROW_ITERS

    def probe_row(inst, launch, plain, ops, reads, line, body_line):
        visited = []
        plain(1, None)                                      # the warm-up
        plain_ms = time_ms(lambda: plain(kk, visited), 0, 1)["median"]
        moved = reads(visited) + 12 * n                     # the rows this run visited
        return {"name": f"mb_inner_kernel {inst.name}", "route": "cuda",
                "source": "parallel_ray_tracer_tpu_torch/csrc/microbench_inner.cuh",
                "replaces": line, "body_line": body_line,
                "launches": instances[inst.name],
                "max_abs_err": max(v["max_abs_err"] for k, v in inner_cmp.items()
                                   if k.startswith(f"microbench/{inst.name}/")),
                "ms": time_ms(launch, 2, 5)["median"],
                "plain_ms": plain_ms,
                **ops_bound(ops.get("fp32", 0) * n * kk, ops.get("tensor", 0) * n * kk, moved),
                "library_ms": None, "iters": kk, "threads": n, "bytes": moved}

    for inst in mi.inner_instances():
        if inst.stack == "shared" or (inst.body in mi.SMEM_META and inst.meta == "global") \
                or inst.packet != (32 if inst.body in mi.LEAF_BODIES else 1):
            continue
        b = inst.body
        rows.append(probe_row(
            inst, lambda: mi.probe(ptab, b, kk, inst.packet, n),
            lambda k, v: mi.inner_plain(ptab, b, k, inst.packet, n, v), mi.iteration_ops(b),
            lambda v: mi.read_bytes(ptab, b, v), "scripts/microbench_inner.py:108",
            mi.SCRIPT_LINES[b]))
    for inst in mg.glue_instances():
        if inst.npop != MB_GLUE_ROW_NPOP or inst.packet != 1 or inst.stack == "shared" \
                or (inst.body in mg.SMEM_META and inst.meta == "global"):
            continue
        b = inst.body
        rows.append(probe_row(
            inst, lambda: mg.probe(ptab, b, inst.npop, kk, 1, n),
            lambda k, v: mg.glue_plain(ptab, b, inst.npop, k, 1, n, v),
            mg.iteration_ops(b, inst.npop), lambda v: mg.read_bytes(ptab, b, inst.npop, v),
            "scripts/microbench_glue.py:135", mg.SCRIPT_LINES[b]))
    for shape in mc.SHAPES:
        for uniform in (False, True):
            name = mc.instance(shape, uniform)
            rows.append({
                "name": f"mb_cond_kernel {name}", "route": "cuda",
                "source": "parallel_ray_tracer_tpu_torch/csrc/microbench_cond.cu",
                "replaces": "scripts/microbench_cond.py:54", "body_line": mc.SCRIPT_LINES[shape],
                "launches": instances[name],
                "max_abs_err": max(v["max_abs_err"] for k, v in inner_cmp.items()
                                   if k.startswith(f"microbench/{name}/")),
                "ms": time_ms(lambda: mc.cond(ctile, shape, uniform, kk, n), 2, 5)["median"],
                "plain_ms": time_ms(lambda: mc.cond_plain(ctile, uniform, kk, n), 1, 1)["median"],
                **ops_bound(mc.OPS_PER_ELEMENT * mc.W * n * kk, 0, nbytes(ctile) + 8 * n),
                "library_ms": None, "iters": kk, "threads": n})
    # rows 15k, 15m: one row per instance, kernel and plain version at
    # MB_INNER_ROW_ITERS iterations of the grid on the scripts' tables (the
    # commands' inputs); the bound as 15i's: the FP32 operations (slab
    # tests, min/max chains, sorts) and the tensor-core products over the
    # peak rates, or the bytes of the tables this run visits and the
    # outputs (e, acc; 15m also top) over the memory rate
    for row, mod in (("tiled", mt), ("mxu_inner", mm)):
        vtab = visit_tabs[row]["script"]
        plain_fn = mt.tiled_plain if row == "tiled" else mm.mxu_inner_plain
        out_bytes = (8 if row == "tiled" else 12) * n
        for body in mod.BODIES:
            for p in mod.PACKETS[body]:
                name = mod.instance(body, p)
                visited = []
                plain_fn(vtab, body, 1, p, n)                   # the warm-up
                plain_ms = time_ms(lambda: plain_fn(vtab, body, kk, p, n, visited), 0, 1)["median"]
                moved = mod.read_bytes(vtab, body, visited) + out_bytes
                ops = mod.iteration_ops(body)
                rows.append({
                    "name": f"{'mb_tiled_kernel' if row == 'tiled' else 'mb_mxu_inner_kernel'}"
                            f" {name}", "route": "cuda",
                    "source": f"parallel_ray_tracer_tpu_torch/csrc/microbench_{row}.cu",
                    "replaces": ("scripts/microbench_tiled.py:103" if row == "tiled"
                                 else "scripts/microbench_mxu_inner.py:141"),
                    "body_line": mod.SCRIPT_LINES[body], "launches": instances[name],
                    "max_abs_err": max(v["max_abs_err"] for k, v in visit_cmp.items()
                                       if k.startswith(f"microbench/{name}/")),
                    "ms": time_ms(lambda: mod.probe(vtab, body, kk, p, n), 2, 5)["median"],
                    "plain_ms": plain_ms,
                    **ops_bound(ops["fp32"] * n * kk, ops["tensor"] * n * kk, moved),
                    "library_ms": None, "iters": kk, "threads": n, "bytes": moved})
    emit({"phase": "microbench", "case": "kernels", "card": card, "rows": rows})
    return rows


# The traversal kernels' mangled names: their template arguments end in
# MXU and the leaf size L, the frame kernel's in MXU, L and FWD.
TRAVERSAL_ENTRY = re.compile(r"_Z\d+(closest|occluded|frame)_kernel")
TEMPLATE_TAIL = re.compile(r"ELb(?P<mxu>[01])ELi(?P<leaf>\d+)E(?:Lb(?P<fwd>[01])E)?Ev")


def entry_leaf(k: str) -> int:
    """The leaf size of a traversal kernel's mangled name, else 0."""
    m = TEMPLATE_TAIL.search(k) if TRAVERSAL_ENTRY.match(k) else None
    return int(m.group("leaf")) if m else 0


def entry_mxu(k: str) -> bool:
    m = TEMPLATE_TAIL.search(k) if TRAVERSAL_ENTRY.match(k) else None
    return bool(m) and m.group("mxu") == "1"


# ptxas's registers, stack frame and spill bytes of kernels that are meant
# to stay as they are: the build phase fails if one of them changed or is
# gone. A change that means to alter a kernel's registers renews the file
# with the run's own table (written beside the records, same name).
PTXAS_BASELINE = os.path.join(HERE, "tests", "goldens", "ptxas_kernels.tsv")
PTXAS_FIELDS = ("registers", "stack", "spill_stores", "spill_loads")


def write_ptxas(table: dict, path: str) -> None:
    """A read_ptxas table as text: a kernel a line, tab-separated."""
    with open(path, "w") as f:
        f.write("# mangled kernel\t" + "\t".join(PTXAS_FIELDS) + "   (nvcc -Xptxas -v, sm_90a)\n")
        for k in sorted(table):
            f.write("\t".join([k, *(str(table[k].get(c, "")) for c in PTXAS_FIELDS)]) + "\n")


def load_ptxas(path: str) -> dict:
    """The table write_ptxas wrote ({} without the file)."""
    table = {}
    if not os.path.exists(path):
        return table
    with open(path) as f:
        for ln in f:
            if not ln.startswith("#"):
                k, *vals = ln.rstrip("\n").split("\t")
                table[k] = {c: int(v) for c, v in zip(PTXAS_FIELDS, vals) if v}
    return table


def read_ptxas(log) -> dict:
    """{mangled kernel: registers, stack frame and spill bytes} from an nvcc
    build log written with -Xptxas -v."""
    table, entry = {}, None
    if not log:
        return table
    for ln in open(log):
        if "Compiling entry" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
            table[entry] = {}
        elif entry and "Used" in ln and "registers" in ln:
            table[entry]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
        elif entry and "spill" in ln:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            if m:
                table[entry].update(zip(("stack", "spill_stores", "spill_loads"),
                                        map(int, m.groups())))
    return table


def ratios(a: dict, b: dict) -> dict:
    """a / b for the work counts and the median time of two timing records."""
    return {c: a[c] / b[c] if b[c] else None for c in
            ("inner_visits", "box_tests", "leaf_visits", "tri_tests", "median")}


# The traversal kernels' names in a profiler trace (csrc/trace.cuh).
TRAVERSAL_NAME = re.compile(r"(closest|occluded|frame)_kernel")


def profile(fn, n: int = 2) -> dict:
    """Device time by kernel name and the device's busy share over n calls
    of fn (2; 5 before the packet phase: the event list of a pass-based
    frame takes seconds to read), from a torch.profiler trace (CUPTI), as
    per-call averages. The window runs from the first call's start on the
    host to the synchronise after the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured: the trace holds no device events"}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for s, t in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if t > end:
            busy += t - max(s, end)
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    trav = [e for e in kernels if TRAVERSAL_NAME.search(e.name)]
    trav_us = sum(e.time_range.elapsed_us() for e in trav)
    return {"calls": n, "wall_ms_per_call": wall_us / n / 1e3,
            "device_busy_ms_per_call": busy / n / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "kernel_launches_per_call": len(kernels) / n,
            "traversal_launches_per_call": len(trav) / n,
            "traversal_ms_per_call": trav_us / n / 1e3,
            "traversal_share_of_busy": trav_us / busy if busy else None,
            "top_kernels_ms_per_call": {k: v / n / 1e3 for k, v in top}}


def write_sphere_folder(folder: str) -> None:
    """SPHERE_SCENE as an asset folder: triangles.obj and .mtl, lights.obj
    and spheres.obj. The loader's material 0 is its implicit black slot, so
    the MTL's materials are 1-3; the loader reads Kd/Ks/Kr in the 5 lines
    after each newmtl (as the reference does), so each block has 6 lines."""
    os.makedirs(folder)
    files = {
        "triangles.obj": "mtllib triangles.mtl\n" + "".join(
            f"v {x} {y} {z}\n" for x, y, z in SPHERE_SCENE["verts"])
        + "usemtl floor\nf 1 2 3\nf 1 3 4\n",
        "triangles.mtl": "".join(
            f"newmtl {n}\nKd {' '.join(map(str, kd))}\nKs {' '.join(map(str, ks))}\n"
            f"Kr {' '.join(map(str, kr))}\nNs 10\nd 1\n"
            for n, kd, ks, kr in zip(("floor", "red", "mirror"), SPHERE_SCENE["mats_kd"],
                                     SPHERE_SCENE["mats_ks"], SPHERE_SCENE["mats_kr"])),
        "lights.obj": "".join(f"{' '.join(map(str, p))} {' '.join(map(str, k))}\n"
                              for p, k in zip(SPHERE_SCENE["lights_pos"],
                                              SPHERE_SCENE["lights_kl"])),
        "spheres.obj": "".join(f"{' '.join(map(str, c))} {r} {m + 1}\n" for c, r, m in zip(
            SPHERE_SCENE["spheres_center"], SPHERE_SCENE["spheres_radius"],
            SPHERE_SCENE["spheres_mat"])),
    }
    for name, text in files.items():
        with open(os.path.join(folder, name), "w") as f:
            f.write(text)


def read_reference(read_bmp) -> np.ndarray:
    """(1080, 1920, 3) uint8 RGB as the reference binary wrote it."""
    with gzip.open(REFERENCE_BMP, "rb") as f:
        data = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.bmp")
        with open(path, "wb") as f:
            f.write(data)
        return read_bmp(path)


if __name__ == "__main__":
    sys.exit(main())

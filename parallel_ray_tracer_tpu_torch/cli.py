"""Port of parallel_ray_tracer_tpu/cli.py: render and time frames from the
command line.

    python -m parallel_ray_tracer_tpu_torch [--device cuda|cpu] [flags]

The same flags and defaults as the JAX package's CLI, plus --device: the
card by default, "cpu" for the kernels' plain PyTorch versions. The same
output protocol as the reference harness: settings banner
(cpu/src/main.c:149-165), BVH build time and structural metrics
(cpu/src/main.c:135-147, cpu/src/bvh.c:381-387), warm-up and timed
iterations (gpu/include/options.cuh:25-26), per-frame times, then
mean/median/stddev/99% CI/FPS (cpu/src/main.c:194-209), an optional BMP and
a JSON metrics record.

--variant jax renders by the packet traversal in torch ops
(ops/trace_bvh.py). --interpret runs the kernels' plain versions on the
device instead of launching the kernels (JAX's Pallas interpreter); the
card is still needed without --device cpu. A NotImplementedError (a leaf
size without kernels) ends the run with its message and exit code 2.
--devices N renders each frame with its tiles sharded over a mesh of N
devices (parallel/sharded.render_sharded): N cards, or with --device cpu N
virtual CPU devices; fewer cards than N end the run with the reason.
--checkpoint PATH renders one frame in bands of --band-rows rows that
persist to PATH (utils/checkpoint.TileRenderCheckpoint, Pipeline.
render_band), resumes at the first missing band, and skips the timing
loop. --profile DIR writes a torch.profiler trace of the timed iterations
into DIR (utils/profiling.trace). The run joins its processes first
(parallel/distributed.initialize: a no-op in one process; under torchrun
every rank renders, and only rank 0 prints and writes files).
--leaf-size 4 packs and
traces leaf groups of 4 triangles (the kernels' L = 4 instances),
--no-reverse-shadows traces shadow rays from the hit point to the light,
--no-fast-light finds shadows by the closest-hit kernel on the pass-based
path, and --presplit RATIO splits large triangles before the BVH build, as
the JAX CLI does; the banner and the metrics record give the leaf size.
--no-bvh and --variant
bruteforce render every frame by brute force (ops/trace_brute.py), as the
JAX CLI does; a --scene folder with a spheres.obj renders its spheres.
--no-native takes the numpy scene loader and BVH builder instead of the C++
ones (native/). --pop-width and --adaptive-pop are accepted and change
nothing here (see config.py). --stream picks streamed leaf rows and --mxu-leaf / --no-mxu-leaf
the tensor-core leaf test as the JAX CLI does (by the JAX prepare's rule);
the banner and the metrics record give the pipeline's resolved choices.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Optional

from .config import RESOLUTIONS, RenderConfig

PROG = "parallel_ray_tracer_tpu_torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="PyTorch + CUDA parallel ray tracer",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: the card; "
                        "cpu runs the kernels' plain PyTorch versions)")
    p.add_argument("--scene", default="car_boxed",
                   help="asset scene name (or use --synthetic)")
    p.add_argument("--asset-root", default=None)
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="render N random triangles instead of a scene "
                        "(cpu/src/main.c:115-131)")
    p.add_argument("--resolution", default=None, choices=sorted(RESOLUTIONS),
                   help="preset name; overrides --width/--height")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--variant", default="auto",
                   choices=("auto", "pallas", "fused", "jax", "bruteforce"),
                   help="auto = fused whole-frame kernel at --bvh-width 4 "
                        "or 8 with 1024-pixel tiles, else pallas; pallas = "
                        "pass-based kernels; fused = whole-frame single-"
                        "launch kernel; jax = packet traversal in torch "
                        "ops; bruteforce = every ray against every "
                        "triangle")
    p.add_argument("--no-bvh", action="store_true",
                   help="USE_BVH=0: brute-force all triangles")
    p.add_argument("--heuristic", type=int, default=6, choices=range(7),
                   help="BVH split heuristic 0-6 (cpu/src/bvh.c:115-242)")
    p.add_argument("--sah-bins", type=int, default=32,
                   help="SAH_BIN_SIZE; -1 = per-centroid brute force")
    p.add_argument("--leaf-threshold", type=int, default=8,
                   help="BVH_ELEMENT_THRESHOLD")
    p.add_argument("--leaf-size", type=int, default=None, choices=(4, 8),
                   help="triangles per packed leaf group row (default 8)")
    p.add_argument("--max-depth", type=int, default=32, help="BVH_MAX_ITER")
    p.add_argument("--seed", type=int, default=1,
                   help="SEED; 0 = time-based (options.h:66-71)")
    p.add_argument("--no-fast-light", action="store_true",
                   help="USE_BVH_FAST_LIGHT=0: closest-hit shadow traversal "
                        "(the pass-based path)")
    p.add_argument("--no-bvh-metrics", action="store_true",
                   help="BVH_METRICS=0: suppress the leaf statistics banner")
    p.add_argument("--bf16-bvh", action="store_true",
                   help="bf16-compressed BVH boxes (conservative rounding)")
    p.add_argument("--bvh-width", type=int, default=4, choices=(2, 4, 8),
                   help="traversal node arity (4 = grandchildren-packed rows)")
    p.add_argument("--pop-width", type=int, default=8, choices=(2, 4, 8),
                   help="TPU wide-pop schedule; no effect here")
    p.add_argument("--adaptive-pop", action=argparse.BooleanOptionalAction,
                   default=True, help="TPU pop schedule; no effect here")
    p.add_argument("--no-reverse-shadows", action="store_true",
                   help="trace shadow segments hit->light")
    p.add_argument("--no-dual-pop", action="store_true",
                   help="single-pop traversal schedule; the same kernels "
                        "as dual-pop here (one thread traces one ray)")
    p.add_argument("--stream", default="auto", choices=("auto", "on", "off"),
                   help="the streamed kernels, on leaf rows padded to whole "
                        "blocks (auto: where the JAX package streams, past its "
                        "126 MiB row model, about 450k triangles)")
    p.add_argument("--presplit", type=float, default=0.0, metavar="RATIO",
                   help="pre-split triangles whose box diagonal passes RATIO "
                        "of the scene's (0 = off)")
    p.add_argument("--true-sah", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="score heuristic-6 splits by true surface area "
                        "instead of the reference's squared diagonal")
    p.add_argument("--mxu-leaf", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the MXU leaf: tensor-core (bf16x3) leaf tests, "
                        "taken where the JAX prepare takes its MXU leaf")
    p.add_argument("--tile", default="32x32",
                   help="pixel tile shape ROWSxCOLS")
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--warmup", type=int, default=None,
                   help="untimed warmup frames before the timed loop; "
                        "default 1 for single renders, 50 (the reference "
                        "GPU protocol, gpu/include/options.cuh:25) when "
                        "--iterations > 1")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="resumable banded render: finished scanline bands "
                        "persist to PATH and a rerun resumes at the first "
                        "missing band")
    p.add_argument("--band-rows", type=int, default=128,
                   help="scanline rows per checkpoint band (a multiple of "
                        "the tile row count)")
    p.add_argument("--devices", type=int, default=1,
                   help="shard image tiles over this many devices (cards, "
                        "or virtual CPU devices with --device cpu)")
    p.add_argument("--output", default=None, metavar="BMP",
                   help="write the final frame as a BMP")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write run metrics as JSON")
    p.add_argument("--interpret", action="store_true",
                   help="the kernels' plain PyTorch versions on the device "
                        "instead of the kernels (Pallas interpreter mode)")
    p.add_argument("--no-native", action="store_true",
                   help="NumPy loaders and builders instead of the C++ ones")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the timed "
                        "iterations into DIR")
    p.add_argument("--quiet", action="store_true")
    return p


def config_from_args(args) -> RenderConfig:
    width, height = args.width, args.height
    if args.resolution:
        width, height = RESOLUTIONS[args.resolution]
    tr, tc = (int(x) for x in args.tile.split("x"))
    return RenderConfig(
        width=width,
        height=height,
        scene=args.scene,
        use_bvh=not args.no_bvh,
        bvh_heuristic=args.heuristic,
        bvh_max_depth=args.max_depth,
        leaf_threshold=args.leaf_threshold,
        sah_bins=args.sah_bins,
        seed=args.seed,
        bvh_metrics=not args.no_bvh_metrics,
        fast_light=not args.no_fast_light,
        bounces=args.bounces,
        iterations=args.iterations,
        warmup=(
            args.warmup if args.warmup is not None
            else (50 if args.iterations > 1 else 1)
        ),
        tile_rows=tr,
        tile_cols=tc,
        variant=args.variant if not args.no_bvh else "bruteforce",
        bf16_bvh=args.bf16_bvh,
        bvh_width=args.bvh_width,
        synthetic_triangles=args.synthetic,
        asset_root=args.asset_root,
        num_devices=args.devices,
        use_native=not args.no_native,
        dual_pop=not args.no_dual_pop,
        reverse_shadows=not args.no_reverse_shadows,
        pop_width=args.pop_width,
        adaptive_pop=args.adaptive_pop,
        presplit=args.presplit,
        stream=args.stream,
        true_sah=args.true_sah,
        mxu_leaf=args.mxu_leaf,
        leaf_size=args.leaf_size,
    )


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _run(args)
    except NotImplementedError as e:
        print(f"{PROG}: NotImplementedError: {e}", file=sys.stderr)
        return 2


def _run(args) -> int:
    cfg = config_from_args(args)

    import numpy as np
    import torch

    from . import pipeline
    from .parallel import distributed, sharded
    from .utils.bmp import write_bmp
    from .utils.profiling import timed, trace
    from .utils.stats import format_summary, summarize

    # A multi-process run joins its group before any device use; a single
    # process is a no-op.
    distributed.initialize(
        backend="gloo" if torch.device(args.device).type == "cpu" else None)
    primary = distributed.is_primary()
    say = (lambda *a: None) if args.quiet or not primary else print

    say(f"\n# Scene settings #\nscene: "
        f"{'synthetic:%d' % cfg.synthetic_triangles if cfg.synthetic_triangles else cfg.scene}, "
        f"resolution: {cfg.width}x{cfg.height}, bounces: {cfg.bounces}")

    t0 = time.perf_counter()
    pipe = pipeline.prepare(cfg, device=args.device)
    prep_s = time.perf_counter() - t0
    device = pipe.device
    on_card = device.type == "cuda"
    device_name = torch.cuda.get_device_name(device) if on_card else None
    variant = pipe.resolved_variant()
    mesh = None
    if cfg.num_devices > 1 or distributed.active():
        # one device a process when a group renders without --devices
        mesh = sharded.make_mesh(cfg.num_devices if cfg.num_devices > 1 else None,
                                 device=device.type)
    say(f"# Host settings #\nbackend: {device}"
        + (f" ({device_name})" if device_name else "")
        + f", devices: {mesh.size if mesh else 1}, variant: {variant}"
        + (" (auto)" if cfg.variant == "auto" else "")
        + f", stream: {pipe.stream}" + (" (auto)" if cfg.stream == "auto" else "")
        + f", mxu: {pipe.mxu}")
    say(f"\n# Bvh settings #\nuse_bvh: {cfg.use_bvh}, heuristic: "
        f"{cfg.bvh_heuristic}, sah_bins: {cfg.sah_bins}, leaf: "
        f"{pipe.leaf_size}, max_depth: {cfg.bvh_max_depth}, seed: "
        f"{cfg.seed}, fast_light: {cfg.fast_light}, bf16: {cfg.bf16_bvh}, "
        f"width: {cfg.bvh_width}")
    if cfg.use_bvh:
        say(f"Time to build the bvh: {pipe.build_ms:.0f} ms")
        if cfg.bvh_metrics:  # BVH_METRICS toggle (options.h:73)
            banner = pipe.bvh_metrics_banner()
            if banner:
                say(banner)
    say(f"(total prepare: {prep_s:.1f} s)")

    if args.checkpoint:
        # Resumable banded render (utils/checkpoint.py): each finished band
        # persists; a rerun picks up at the first missing band. This path
        # renders ONE frame and skips the timing loop (JAX cli.py:227-249).
        from .utils.checkpoint import TileRenderCheckpoint

        band = max(args.band_rows // cfg.tile_rows, 1) * cfg.tile_rows
        ckpt = TileRenderCheckpoint(args.checkpoint, cfg.width, cfg.height, band)
        img = ckpt.run(
            lambda y0, rows: pipe.render_band(y0, max(rows, cfg.tile_rows),
                                              interpret=args.interpret).cpu().numpy(),
            progress=lambda done, total: say(f"band {done}/{total}"),
        )
        if args.output and primary:
            write_bmp(args.output, img)
            say(f"Wrote {args.output}")
        return 0

    def render_once():
        if mesh is None:
            return pipe.render(interpret=args.interpret)
        # The pipeline's kernel schedule and shadow knobs: --devices N
        # renders the frame --devices 1 does.
        jax_path = variant == "jax"
        return sharded.render_sharded(
            pipe.ds, pipe.dbvh if jax_path else pipe.tables, pipe.camera(), cfg.width,
            cfg.height, mesh, bounces=cfg.bounces,
            leaf_size=pipe.leaf_size if jax_path else None,
            stack_depth=pipe.stack_depth if jax_path else None,
            tile_rows=cfg.tile_rows, tile_cols=cfg.tile_cols, variant=variant,
            dual=cfg.dual_pop, stream=pipe.stream, fast_light=cfg.fast_light,
            reverse_shadows=cfg.reverse_shadows, interpret=args.interpret)

    # The JAX CLI moves the camera by i * 1e-7 each iteration to defeat a
    # remote dispatch cache; nothing here caches, so every frame is the
    # frame an in-process render() gives.
    # Each frame's time ends when its device is done (the frame of a mesh
    # comes back to one device, after every shard).
    for i in range(cfg.warmup):
        _, s = timed(render_once)
        say(f"Warmup {i}: {s * 1e3:.3f} ms")

    times = []
    img = None
    with trace(args.profile) if args.profile else contextlib.nullcontext():
        for i in range(cfg.iterations):
            img, s = timed(render_once)
            times.append(s * 1e3)
            say(f"Iteration {i}: {times[-1]:.3f} ms")
    if args.profile:
        say(f"Wrote profiler trace to {args.profile}")

    stats = summarize(times)
    if stats:
        say(format_summary(stats))
        stats["primary_rays_per_s"] = cfg.width * cfg.height / (stats["median_ms"] / 1e3)
        say(f"Primary rays/s: {stats['primary_rays_per_s']:.3e}")

    if args.output and img is not None and primary:
        write_bmp(args.output, np.asarray(img.cpu()))
        say(f"Wrote {args.output}")

    if args.metrics_json and primary:
        record = {
            "config": dataclasses.asdict(cfg),
            "backend": str(device),
            "device_name": device_name,
            "devices": mesh.size if mesh else 1,
            "build_ms": pipe.build_ms,
            "builder": pipe.builder,
            "bvh_stats": pipe.bvh_stats,
            "stream": pipe.stream,
            "mxu": pipe.mxu,
            "leaf_size": pipe.leaf_size,
            "times_ms": times,
            **stats,
        }
        with open(args.metrics_json, "w") as f:
            json.dump(record, f, indent=2)
        say(f"Wrote {args.metrics_json}")

    return 0


if __name__ == "__main__":
    sys.exit(main())

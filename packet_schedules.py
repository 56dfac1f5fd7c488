#!/usr/bin/env python3
"""Time the packet traversal (variant="jax", ops/trace_bvh.py) on both of its
schedules on the card.

    python3 packet_schedules.py [--out FILE]

car_boxed at 1920x1080, 4 bounces, 32x32 tiles, the FP32 tables' pipeline
(chip_smoke.py's CFG): the frame on the "masked" schedule (buckets of CUDA
graphs; the card's default) twice, the first with the graphs' capture,
then on the "split" schedule (compaction and a host sync every step), each
pass's steps and host seconds, and the two frames' equality. Prints one
JSON object a frame and writes them to FILE. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the records (JSON lines) here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("packet_schedules: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from parallel_ray_tracer_tpu_torch import pipeline
    from parallel_ray_tracer_tpu_torch.config import RenderConfig
    from parallel_ray_tracer_tpu_torch.models.camera import ray_basis
    from parallel_ray_tracer_tpu_torch.ops import render as R
    from parallel_ray_tracer_tpu_torch.ops import trace_bvh

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    cfg = RenderConfig(scene="car_boxed", width=1920, height=1080, bounces=4,
                       bvh_heuristic=6, tile_rows=32, tile_cols=32, mxu_leaf=False)
    pipe = pipeline.prepare(cfg)
    W, H = cfg.width, cfg.height
    o, d = R.generate_rays_tiled(ray_basis(pipe.camera(), W, H), W, H, cfg.tile_rows,
                                 cfg.tile_cols, device=pipe.device)
    records, frames = [], {}
    for run, schedule in enumerate(("masked", "masked", "split")):
        stats = []
        closest, occluded = trace_bvh.make_tracer(
            pipe.dbvh, pipe.ds, pipe.leaf_size, pipe.stack_depth,
            packet=cfg.tile_rows * cfg.tile_cols, stats=stats, schedule=schedule)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        col = R.trace_rays(pipe.ds, closest, occluded, o, d, cfg.bounces,
                           reverse_shadows=cfg.reverse_shadows)
        img = R._to_image(col, W, H, cfg.tile_rows, cfg.tile_cols)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        frames.setdefault(schedule, img)
        rec = {"card": card, "run": run, "schedule": schedule, "frame_s": seconds,
               "steps": sum(r["steps"] for r in stats),
               "ms_per_step": seconds * 1e3 / sum(r["steps"] for r in stats),
               "passes": [{k: r[k] for k in ("kind", "steps", "visits", "leaf_visits",
                                             "seconds")} for r in stats]}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    same = {"card": card, "masked_equals_split": torch.equal(frames["masked"],
                                                            frames["split"])}
    records.append(same)
    print(json.dumps(same))
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in records))
    return 0 if same["masked_equals_split"] else 1


if __name__ == "__main__":
    sys.exit(main())

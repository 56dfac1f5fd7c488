"""The microbench probes' command line.

    python -m parallel_ray_tracer_tpu_torch.microbench
        {mxu_leaf,probes,overlap,bf16,inner,glue,cond,tiled,mxu_inner}
        [--stage v1..v6|all] [--probes-only] [--device cpu] [--out DIR]

`mxu_leaf` times kernel A's leaf visit in each stage's configurations
(mxu_leaf.STAGES; --stage, default all) and prints the accuracy tables;
`probes` runs the shared-memory staging sweep (B) and the L2 ceiling's
gather sweep (C); `overlap` times kernel D's bodies and prints the overlap
harvested; `bf16` times the f32 and bf16x2 chains (ns per op per 1,024
elements, and the script's bf16(16,128) / f32(8,128) mul-sub ratio line)
and the f32 and packed bf16 slab pairs (ns per visit per 1,024 rays);
`inner` times each body of row 15i at packet 1 and 32 (ns per iteration
per 1,024 rays, occupancy, SASS counts; the shared-memory units beside
their twins); `glue` each body of row 15j at npop 4 and 8 and the script's
components (--probes-only: full, full_xs and xb, as the script's flag);
`cond` the four step shapes per thread and warp-uniform and the script's
cond_cost_ns, nested_extra_ns and switch_vs_nested_ns; `tiled` each body
of row 15k (ns per iteration per 1,024 rays, SASS counts, each as the
script's line) and the answer: the child-parallel forms B, H, F, G over A
at packet 32, and A at packet 32 over packet 1; `mxu_inner` each body of
row 15m the same way and the answers J / I, K / I and L / M. On the card (the
default) every time is a marginal cost per loop
iteration measured with CUDA events on that card (microbench/_timing.py),
with the SM clock beside it; the card's name and power limit head the
output. With --device cpu the plain versions run at a few iterations and
no time is printed. Each record is printed as one JSON line and all of them
are written to DIR/<command>.json (default: chiprun_out/microbench/ at the
repository's root).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

import torch

from . import _timing, bf16, cond, glue, inner, mxu_inner, mxu_leaf, overlap, probes, tiled

COMMANDS = ("mxu_leaf", "probes", "overlap", "bf16", "inner", "glue", "cond", "tiled",
            "mxu_inner")
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "chiprun_out", "microbench")
# Resident threads per SM: the grid of the timed kernels fills the card.
THREADS_PER_SM = 2048
WARPS_PER_SM = THREADS_PER_SM // 32
CPU_THREADS = 1024


def card() -> str:
    """nvidia-smi's name and power limit of the card, one line."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "not measured"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m parallel_ray_tracer_tpu_torch.microbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=COMMANDS)
    ap.add_argument("--stage", default="all", choices=sorted(mxu_leaf.STAGES) + ["all"],
                    help="mxu_leaf: the stage to run")
    ap.add_argument("--probes-only", action="store_true",
                    help="glue: only full, full_xs and xb (the script's --probes-only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=DEFAULT_OUT, help="where <command>.json goes")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("microbench: no CUDA device (use --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    on_card = args.device == "cuda"
    head = {"command": args.command, "device": args.device}
    if on_card:
        props = torch.cuda.get_device_properties(device)
        head.update(card=card(), name=torch.cuda.get_device_name(device),
                    sms=props.multi_processor_count)
    timing = _timing if on_card else None
    sms = head.get("sms", 0)
    if args.command == "mxu_leaf":
        stages = sorted(mxu_leaf.STAGES) if args.stage == "all" else [args.stage]
        n = sms * THREADS_PER_SM if on_card else CPU_THREADS
        records = mxu_leaf.run(stages, device, n, timing)
    elif args.command == "probes":
        records = probes.run(device, timing, n_warps=sms * WARPS_PER_SM)
    elif args.command == "overlap":
        records = overlap.run(device, timing, sms=sms)
    elif args.command == "bf16":
        records = bf16.run(device, timing, sms=sms)
    elif args.command == "inner":
        records = inner.run(device, timing, sms=sms, card=head.get("card", ""))
    elif args.command == "glue":
        records = glue.run(device, timing, sms=sms, card=head.get("card", ""),
                           probes_only=args.probes_only)
    elif args.command == "cond":
        records = cond.run(device, timing, sms=sms, card=head.get("card", ""))
    elif args.command == "tiled":
        records = tiled.run(device, timing, sms=sms, card=head.get("card", ""))
    else:
        records = mxu_inner.run(device, timing, sms=sms, card=head.get("card", ""))
    print(json.dumps(head), flush=True)
    for rec in records:
        print(json.dumps(rec), flush=True)
        if "script_line" in rec:
            print(rec["script_line"], flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.command}.json"), "w") as f:
        json.dump({"head": head, "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The marginal-cost method of the microbench scripts, with CUDA events.

The port's copy of scripts/_timing.py (`marginal_s`), of
microbench_mxu_leaf.py's `timeit` :172 and of microbench_overlap.py's `_run`
:160. A kernel runs a data-dependent loop of K iterations; one launch is
timed at K_lo and at K_hi, and (t_hi - t_lo) / (K_hi - K_lo) is the cost of
one iteration, with the launch and the loop's set-up cancelled. Each
repeat times both launches with CUDA events on the current stream; after a
warm-up, the median of the repeats is reported with their min and max. K_hi
is chosen so that its launch takes 2-10 ms (about 4 ms), K_lo a quarter of
it. The SM clock is read with nvidia-smi while the card runs the loop, since a
marginal cost of a few nanoseconds moves with the boost clock.

Device times only: there is no CPU path here. The TPU scripts jittered each
call's input against a dispatch cache; a CUDA launch is not cached, so no
jitter is needed.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Dict

import torch

TARGET_MS = 4.0
LO_MS, HI_MS = 2.0, 10.0
REPS = 5
WARMUP = 1


def _event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


def launch_ms(launch: Callable[[int], object], k: int) -> float:
    """Device ms of one launch at K = k (after the stream drains)."""
    torch.cuda.synchronize()
    a, b = _event(), _event()
    a.record()
    launch(k)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def calibrate(launch: Callable[[int], object], k0: int = 4, k_max: int = 1 << 22):
    """(k_lo, k_hi): K_hi such that its launch takes about TARGET_MS."""
    launch(k0)                                   # first call: load, warm caches
    k = k0
    ms = launch_ms(launch, k)
    while ms < 0.5 and k < k_max:
        k = min(k * 8, k_max)
        ms = launch_ms(launch, k)
    k_hi = max(4, min(k_max, int(k * TARGET_MS / max(ms, 1e-6))))
    return max(1, k_hi // 4), k_hi


def marginal(launch: Callable[[int], object], k_lo: int, k_hi: int,
             reps: int = REPS, warmup: int = WARMUP) -> Dict:
    """Marginal ns per iteration: median, min and max over `reps` repeats of
    (t(k_hi) - t(k_lo)) / (k_hi - k_lo), and each K's median launch ms."""
    for _ in range(warmup):
        launch(k_lo)
        launch(k_hi)
    try:
        clock = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        clock = None
    evs = []
    for _ in range(reps):
        e = [_event() for _ in range(4)]
        e[0].record()
        launch(k_lo)
        e[1].record()
        e[2].record()
        launch(k_hi)
        e[3].record()
        evs.append(e)
    # keep the card busy until nvidia-smi has sampled the clock
    while clock is not None and clock.poll() is None:
        launch(k_hi)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    sm = "not measured"
    if clock is not None:
        lines = clock.communicate()[0].strip().splitlines()
        if clock.returncode == 0 and lines:
            sm = lines[0].strip()
    lo = [e[0].elapsed_time(e[1]) for e in evs]
    hi = [e[2].elapsed_time(e[3]) for e in evs]
    per = [(h - l) / (k_hi - k_lo) * 1e6 for l, h in zip(lo, hi)]
    return {"ns": statistics.median(per), "ns_min": min(per), "ns_max": max(per),
            "k_lo": k_lo, "k_hi": k_hi, "ms_lo": statistics.median(lo),
            "ms_hi": statistics.median(hi), "reps": reps, "clocks_sm_mhz": sm}


def measure(launch: Callable[[int], object], k0: int = 4) -> Dict:
    """Calibrate K, then the marginal cost; if the K_hi launch fell outside
    2-10 ms, K is scaled from the measured cost and the marginal repeated
    once."""
    k_lo, k_hi = calibrate(launch, k0)
    m = marginal(launch, k_lo, k_hi)
    if not LO_MS <= m["ms_hi"] <= HI_MS and m["ns"] > 0:
        k_hi = max(4, int(TARGET_MS * 1e6 / m["ns"]))
        m = marginal(launch, max(1, k_hi // 4), k_hi)
    return m

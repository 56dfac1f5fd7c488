"""Port of parallel_ray_tracer_tpu/utils/profiling.py: profiler traces, named
spans and fenced wall timing, on torch.profiler.

  - `trace(log_dir)`: a context manager that records the host's and, where
    there is a card, the device's activity (CUPTI) and writes it into
    log_dir as a Chrome trace (`<host>_<pid>.<ms>.pt.trace.json`, through
    torch.profiler.tensorboard_trace_handler), which TensorBoard's profiler
    plugin, Perfetto and chrome://tracing open: the counterpart of the
    reference's cudaProfilerStart/Stop for Nsight (gpu/src/gpu.cu:104-116).
  - `annotate(name)`: a named span on that timeline (record_function), for
    phases such as the BVH build, the upload or a band.
  - `timed(fn)`: (result, seconds) on the host's clock, with the devices of
    the result's tensors synchronised before the clock stops: the cudaEvent
    analog for a whole call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Record the activity inside the block and write its trace into
    log_dir (made if missing); yields the torch.profiler.profile."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
                 acc_events=True) as prof:
        yield prof


def annotate(name: str):
    """Named span on the profiler timeline."""
    return record_function(name)


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def fence(tree) -> None:
    """Wait for the work that produced the tensors of `tree`: synchronise
    each CUDA device they lie on (CPU tensors are ready when returned)."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def timed(fn: Callable[[], object]) -> Tuple[object, float]:
    """(result, seconds) with a device fence."""
    t0 = time.perf_counter()
    out = fn()
    fence(out)
    return out, time.perf_counter() - t0

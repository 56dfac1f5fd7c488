"""Port of parallel_ray_tracer_tpu/parallel/distributed.py: joining the
processes of a multi-process run, on torch.distributed.

Usage in each process:

    from parallel_ray_tracer_tpu_torch.parallel import distributed, sharded
    distributed.initialize()          # no-op in a single process
    mesh = sharded.make_mesh()        # every process's devices, in rank order
    img = sharded.render_sharded(..., mesh=mesh)

A process group needs its address, its size and each process's rank. They
come from the arguments, or from the launcher's environment (torchrun sets
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK). The processes
talk through NCCL when they render on cards and through gloo on the CPU.
The forward render needs one collective, the gather of the frame's tiles;
the training step all-reduces its loss and gradient (parallel/sharded.py).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# A lost peer ends the rendezvous and every collective after this long,
# rather than leaving the others waiting.
TIMEOUT_S = 120.0


def _multiprocess(coordinator_address, num_processes) -> bool:
    """JAX's rule (distributed.py:48-54), from the arguments and the
    environment only: an explicit address, more than one process, or a
    launcher's environment of more than one process."""
    return (coordinator_address is not None
            or (num_processes or 0) > 1
            or (int(os.environ.get("WORLD_SIZE", "1")) > 1 and "MASTER_ADDR" in os.environ))


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group when the run has several processes.

    coordinator_address is "host:port" (or "tcp://host:port") of rank 0's
    rendezvous; without it the launcher's environment (env://) gives it.
    num_processes and process_id default to WORLD_SIZE and RANK. backend:
    "nccl" on the cards, "gloo" on the CPU (default: NCCL where CUDA is
    available); under NCCL this process's card is LOCAL_RANK's (the rank
    modulo the visible cards without it). A single-process run, or a group
    that already exists, is a no-op; any other failure raises, as in JAX
    (distributed.py:61-77)."""
    if not _multiprocess(coordinator_address, num_processes):
        return
    if dist.is_initialized():
        return
    rank = int(os.environ.get("RANK", "0")) if process_id is None else int(process_id)
    world = (int(os.environ.get("WORLD_SIZE", "1")) if num_processes is None
             else int(num_processes))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = backend or default_backend()
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def active() -> bool:
    """True inside a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_primary() -> bool:
    """True on the process that should write BMPs and metrics: rank 0, and
    every process outside a group."""
    return rank() == 0


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if active():
        dist.destroy_process_group()

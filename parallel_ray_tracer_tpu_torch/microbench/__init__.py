"""Probes that ask the H100 what a leaf visit costs: the port of the leaf-test
microbenchmarks of scripts/ (row 15a-15d of PERF.md's kernel table).

Each TPU script asked the TPU one question about the MXU leaf; each kernel
here asks the card the same question, through the production device
functions of csrc/trace.cuh wherever the script went through
pallas_trace.py's:

| module        | kernel (csrc/)                           | replaces (scripts/)                                   |
| ------------- | ---------------------------------------- | ----------------------------------------------------- |
| `mxu_leaf.py` | A `mb_leaf_kernel` (microbench_leaf.cu)  | `pallas_run` microbench_mxu_leaf.py:161 (call :162)   |
| `probes.py`   | B `mb_stage_kernel` (microbench_probes.cu) | `probe_pad` microbench_mxu_leaf.py:513 (call :523)  |
| `probes.py`   | C `mb_gather_kernel` (microbench_probes.cu) | `probe_ceiling` microbench_mxu_leaf.py:544 (call :554) |
| `overlap.py`  | D `mb_overlap_kernel` (microbench_overlap.cu) | `_run` microbench_overlap.py:160 (call :168)     |

`fixtures.py` holds numpy copies of the scripts' fixtures, `_timing.py` the
marginal-cost method with CUDA events. Each wrapper runs its kernel's plain
PyTorch version for tensors on the CPU and launches the kernel, or raises,
for tensors on the card; it counts its launches in LAUNCHES. The entry
point is `python -m parallel_ray_tracer_tpu_torch.microbench
{mxu_leaf,probes,overlap}` (__main__.py).
"""

LAUNCHES = {"leaf": 0, "stage": 0, "gather": 0, "overlap": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0

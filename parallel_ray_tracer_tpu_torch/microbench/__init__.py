"""Probes that ask the H100 what a leaf visit costs, whether it runs
packed bf16x2 at the rate of f32, what one inner visit costs part by part,
and whether a child-parallel warp or a tensor-core inner-node test beats
the per-ray slab test: the port of the microbenchmarks of scripts/ (rows
15a-15m of PERF.md's kernel table).

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
| `bf16.py`     | `mb_chain_kernel` (microbench_bf16.cu)  | `_chain_bench` :85 (:101), `_chain_bench_ilp` :116 (:140) of microbench_bf16.py |
| `bf16.py`     | `mb_slab_kernel` (microbench_bf16.cu)   | `_slab_pair_f32` :155 (:185), `_slab_pair_bf16` :200 (:255) of microbench_bf16.py |
| `inner.py`    | `mb_inner_kernel` (microbench_inner.cuh, instances in microbench_inner.cu) | `_run` microbench_inner.py:98 (call :108) |
| `glue.py`     | `mb_inner_kernel` (instances in microbench_glue.cu) | `_run` microbench_glue.py:132 (call :135) |
| `cond.py`     | `mb_cond_kernel` (microbench_cond.cu)   | `_bench` microbench_cond.py:42 (call :54) |
| `tiled.py`    | `mb_tiled_kernel` (microbench_tiled.cu) | `_run` microbench_tiled.py:78 (call :103) |
| `mxu_inner.py` | `mb_mxu_inner_kernel` (microbench_mxu_inner.cu) | `_run` microbench_mxu_inner.py:108 (call :141) |

`fixtures.py` holds numpy copies of the scripts' fixtures, `_timing.py` the
marginal-cost method with CUDA events, `sass.py` the SASS instruction
counts of the built probes. Each wrapper runs its kernel's plain
PyTorch version for tensors on the CPU and launches the kernel, or raises,
for tensors on the card; it counts its launches in LAUNCHES. The entry
point is `python -m parallel_ray_tracer_tpu_torch.microbench
{mxu_leaf,probes,overlap,bf16,inner,glue,cond,tiled,mxu_inner}` (__main__.py).
"""

LAUNCHES = {"leaf": 0, "stage": 0, "gather": 0, "overlap": 0, "chain": 0, "slab": 0,
            "inner": 0, "glue": 0, "cond": 0, "tiled": 0, "mxu_inner": 0}
# Launches per kernel instance, for the kernels whose instances are probes
# of their own (bf16.py: "chain<bf16x2,fms,16x128>", "slab<f32>", ...;
# inner.py: "inner<A,p1>", ...; glue.py: "glue<full,npop4,p32>", ...;
# cond.py: "cond<cond1,uniform>", ...; tiled.py: "tiled<stacked,p32>", ...;
# mxu_inner.py: "mxu_inner<J,p32>", ...).
INSTANCE_LAUNCHES = {}


def count_launch(instance: str, kernel: str) -> None:
    """One launch of `instance` of `kernel` (a key of LAUNCHES)."""
    LAUNCHES[kernel] += 1
    INSTANCE_LAUNCHES[instance] = INSTANCE_LAUNCHES.get(instance, 0) + 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    INSTANCE_LAUNCHES.clear()

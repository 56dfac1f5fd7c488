"""PyTorch + CUDA port of parallel_ray_tracer_tpu for NVIDIA Hopper.

A package beside the JAX one, which stays the reference. It renders the
Whitted frame (closest hit, any-hit shadows, mirror bounces) over a BVH of
node arity 2, 4 or 8 with hand-written CUDA kernels (csrc/trace.cuh) on a
CUDA device, and with their plain PyTorch versions on the CPU. Entry
points: `python -m parallel_ray_tracer_tpu_torch` (cli.py),
`pipeline.prepare` and `Pipeline.render`, and the kernel wrappers in
`ops/cuda_trace.py`.
"""

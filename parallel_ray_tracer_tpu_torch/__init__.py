"""PyTorch + CUDA port of parallel_ray_tracer_tpu for NVIDIA Hopper.

A package beside the JAX one, which stays the reference. It renders the
BVH4 Whitted frame (closest hit, any-hit shadows, mirror bounces) with
hand-written CUDA kernels (csrc/trace.cuh) on a CUDA device, and with their
plain PyTorch versions on the CPU. Entry points: `pipeline.prepare` and
`Pipeline.render`, and the kernel wrappers in `ops/cuda_trace.py`.
"""

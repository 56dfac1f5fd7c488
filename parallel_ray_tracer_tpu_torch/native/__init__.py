"""The port's native host runtime (a copy of parallel_ray_tracer_tpu/native/):
the C++ scene loader and BVH builder, built with g++ at first use."""

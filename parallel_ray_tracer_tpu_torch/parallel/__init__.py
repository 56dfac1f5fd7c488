"""Port of parallel_ray_tracer_tpu/parallel/: the sharded render and training
step over a mesh of devices (sharded.py) and the process group of a
multi-process run (distributed.py)."""

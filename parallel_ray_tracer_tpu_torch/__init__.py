"""PyTorch + CUDA port of parallel_ray_tracer_tpu for NVIDIA Hopper.

A package beside the JAX one, which stays the reference. It renders the
Whitted frame (closest hit, any-hit shadows, mirror bounces) over a BVH of
node arity 2, 4 or 8 with hand-written CUDA kernels (csrc/trace.cuh) on a
CUDA device, and with their plain PyTorch versions on the CPU. Entry
points: `python -m parallel_ray_tracer_tpu_torch` (cli.py), `prepare`
(pipeline.prepare) with `Pipeline.render` and `Pipeline.render_band`, the
sharded render and training step over a mesh of devices
(parallel/sharded.py, parallel/distributed.py), and the kernel wrappers in
`ops/cuda_trace.py`.
"""

__version__ = "0.1.0"

from .config import RenderConfig  # noqa: E402,F401


def prepare(cfg=None, scene=None, device=None, **kwargs):
    """Convenience: build a render pipeline (pipeline.prepare), as the JAX
    package's prepare (parallel_ray_tracer_tpu/__init__.py:16-27).

    `prepare()` with no arguments uses the default RenderConfig; keyword
    arguments make one: `prepare(scene="car_boxed", width=1920,
    height=1080)`. device: the card by default, "cpu" for the kernels'
    plain versions."""
    from . import pipeline as _pipeline

    if cfg is None:
        cfg = RenderConfig(**kwargs)
    elif kwargs:
        raise TypeError("pass either a RenderConfig or keyword fields")
    return _pipeline.prepare(cfg, scene=scene, device=device)

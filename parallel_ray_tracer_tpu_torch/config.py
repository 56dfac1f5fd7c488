"""Copy of parallel_ray_tracer_tpu/config.py: the same `RenderConfig`
fields and defaults, so a test can build both packages' configs from one
set of keyword arguments.

The port runs every path the fields select; `pipeline.prepare` raises
NotImplementedError only for a leaf size without kernel instances. Asset
lookup is limited to this repository's `assets/`.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

# cpu/src/main.c:105-106: cam at (0,-9,3), fov pi/3.2, rot.x = -pi/12.
DEFAULT_CAM_POS = (0.0, -9.0, 3.0)
DEFAULT_CAM_ROT = (-math.pi / 12.0, 0.0, 0.0)
DEFAULT_CAM_FOV = math.pi / 3.2

# Resolution presets mirroring the reference table (cpu/include/options.h:8-20).
RESOLUTIONS = {
    "32p": (64, 32),
    "144p": (256, 144),
    "240p": (426, 240),
    "360p": (640, 360),
    "480p": (854, 480),
    "720p": (1280, 720),
    "1080p": (1920, 1080),
    "2k": (2560, 1440),
    "4k": (3840, 2160),
    "8k": (7680, 4320),
}

SCENES = ("car_only", "car_boxed", "dragon", "sportscar", "two_cars")

# Asset search path: the repository's own assets/ directory.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_ASSET_ROOTS = (os.path.join(_REPO_ROOT, "assets"),)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All reference knobs, runtime-selectable.

    Reference citations: WIDTH/HEIGHT (cpu/include/options.h:6-7), USE_BVH
    (:22), BVH_HEURISTIC (:34), SCENE (:40), TILE_SIZE (:49), BOUNCES (:52),
    ITERATIONS (:55), BVH_ELEMENT_THRESHOLD (:58), SAH_BIN_SIZE (:61),
    BVH_MAX_ITER (:64), SEED (:67), BVH_METRICS (:73), USE_BVH_FAST_LIGHT (:74).
    """

    width: int = 1920
    height: int = 1080
    scene: str = "car_boxed"

    use_bvh: bool = True
    # 0: axis 0 midpoint, 1: largest-axis midpoint, 2: random-axis midpoint,
    # 3: random pos on random axis, 4: median on largest axis,
    # 5: median on best-SAH axis, 6: binned SAH sweep  (cpu/src/bvh.c:115-242)
    bvh_heuristic: int = 3
    bvh_max_depth: int = 32          # BVH_MAX_ITER
    leaf_threshold: int = 2          # BVH_ELEMENT_THRESHOLD
    sah_bins: int = 32               # SAH_BIN_SIZE; -1 = brute-force sweep
    seed: int = 1                    # 0 = time-based, else fixed (options.h:66-71)
    bvh_metrics: bool = True
    fast_light: bool = True          # USE_BVH_FAST_LIGHT: any-hit shadow traversal

    bounces: int = 4
    iterations: int = 1
    warmup: int = 0                  # GPU harness uses 50 (gpu/include/options.cuh:25)

    # Pixel tile of the tile-major ray layout (ops/render.py); a tile must
    # hold a whole number of 128-ray rows.
    tile_rows: int = 8
    tile_cols: int = 128

    # "fused": the fused frame kernel; "pallas": the pass-based path over
    # the closest / any-hit kernels; "jax": the packet traversal in torch
    # ops (ops/trace_bvh.py); "bruteforce": every ray against every
    # triangle (use_bvh=False always takes it); "auto": fused where the JAX
    # package would take it (bvh_width >= 4, fast_light, 1024-ray tiles),
    # else pallas.
    variant: str = "auto"
    # bf16 node boxes, rounded conservatively: pair rows at bvh_width 4, the
    # raw bf16 binary table at 2, f32 at 8 (as the JAX prepare packs them).
    bf16_bvh: bool = False

    # Ambient light (cpu/src/main.c:36).
    ambient: Tuple[float, float, float] = (0.5, 0.5, 0.5)

    # Camera defaults (cpu/src/main.c:105-107).
    cam_pos: Tuple[float, float, float] = DEFAULT_CAM_POS
    cam_rot: Tuple[float, float, float] = DEFAULT_CAM_ROT
    cam_fov: float = DEFAULT_CAM_FOV

    # Synthetic scene mode: if >0, generate this many random triangles and no
    # lights (cpu/src/main.c:115-131).
    synthetic_triangles: int = 0

    asset_root: Optional[str] = None

    # Fields of the JAX package's TPU paths, kept so that both packages'
    # configs build from one set of keyword arguments. use_native takes
    # the C++ scene loader and BVH builder (native/, built with g++ at first
    # use; the numpy builder where g++ is missing), as in JAX. The port
    # ignores pop_width and adaptive_pop (packet schedules; one thread
    # traces one ray here). num_devices is the mesh size of the command
    # line's sharded render (--devices, parallel/sharded.render_sharded);
    # prepare itself uploads to one device.
    num_devices: int = 1
    use_native: bool = True
    # Node arity of the packed BVH: 2 (the binary tree), 4 or 8. Each has
    # its own kernel instances; the fused frame needs 4 or 8, so "auto"
    # renders width 2 by the pass-based path. Other values raise ValueError.
    bvh_width: int = 4
    # Single-pop (False) or dual-pop (True) packet schedule of the TPU
    # kernels. Both compute the same hits; here both reach the same
    # one-ray-per-thread kernels.
    dual_pop: bool = True
    pop_width: int = 8
    adaptive_pop: bool = True
    # The MXU leaf: each leaf group's triangle tests as one tensor-core
    # product of the rays' features with the group's C-matrix (bf16x3,
    # ops/pack.build_cmat). prepare takes it by the JAX prepare's rule
    # (ops/pack.mxu_decision: dual_pop, bvh_width >= 4, leaf rows not
    # streamed, the table within JAX's TPU budget); otherwise, or with
    # False, the leaf test is the FP32 one.
    mxu_leaf: bool = True

    # Score SAH splits by true surface area instead of the reference's
    # squared-diagonal approximation (cpu/src/bvh.c:43-46); the image does
    # not depend on it.
    true_sah: bool = True

    # Trace shadow segments from the light toward the hit points (the
    # distance window maps exactly, see ops/shade.shade_hit); False traces
    # them from the hit points toward the light.
    reverse_shadows: bool = True

    # Triangles per leaf group row; None = largest that fits the 128-lane
    # row (8). The kernels hold 8, 4, 2 and 1: any other value raises
    # NotImplementedError.
    leaf_size: Optional[int] = None

    presplit: float = 0.0
    # Leaf rows streamed by the kernels' streamed instances: "on", "off",
    # or "auto", which streams where the JAX package streams (past its row
    # model's 126 MiB, about 450k triangles; ops/pack.stream_decision).
    # A streamed pipeline renders "auto" by the pass-based path.
    stream: str = "auto"

    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    def with_resolution(self, name: str) -> "RenderConfig":
        w, h = RESOLUTIONS[name]
        return dataclasses.replace(self, width=w, height=h)

    def asset_dir(self) -> str:
        roots = (self.asset_root,) if self.asset_root else DEFAULT_ASSET_ROOTS
        for root in roots:
            path = os.path.join(root, self.scene)
            if os.path.isdir(path):
                return path
        raise FileNotFoundError(
            f"scene '{self.scene}' not found under any of {roots}"
        )

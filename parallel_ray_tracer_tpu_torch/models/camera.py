"""Copy of parallel_ray_tracer_tpu/models/camera.py (numpy only).

Pinhole camera with the reference's exact conventions.

Matches cpu/src/cam.c:
  - `fov` is stored as cot(fov/2) (cam_init, cpu/src/cam.c:8).
  - Euler rotation order Y -> X -> Z (cam_rotate, cpu/src/cam.c:11-15).
  - Screen corners in camera space: UL=(-ar, cot, +1), UR=(+ar, cot, +1),
    DL=(-ar, cot, -1); rotated then translated by pos (cpu/src/cam.c:35-48).
  - Per-pixel ray dir = (UL - pos) + x*inc_x + y*inc_y, *not normalized*
    (cpu/src/main.c:228-233), with inc_x=(UR-UL)/W, inc_y=(DL-UL)/H.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: Tuple[float, float, float]
    rot: Tuple[float, float, float]  # radians; applied Y, then X, then Z
    fov: float                       # full field of view in radians

    @property
    def cot_half_fov(self) -> float:
        return 1.0 / math.tan(self.fov / 2.0)


def _rotate(rot, p: np.ndarray) -> np.ndarray:
    """Apply the reference's Y -> X -> Z rotation to points (..., 3)."""
    rx, ry, rz = rot
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    # rotateY (cpu/src/cam.c:24-28)
    x, z = (
        x * math.cos(ry) + z * math.sin(ry),
        -x * math.sin(ry) + z * math.cos(ry),
    )
    # rotateX (cpu/src/cam.c:17-21)
    y, z = (
        y * math.cos(rx) - z * math.sin(rx),
        y * math.sin(rx) + z * math.cos(rx),
    )
    # rotateZ (cpu/src/cam.c:30-34)
    x, y = (
        x * math.cos(rz) - y * math.sin(rz),
        x * math.sin(rz) + y * math.cos(rz),
    )
    return np.stack([x, y, z], axis=-1)


def screen_corners(cam: Camera, aspect_ratio: float) -> np.ndarray:
    """(3, 3) world-space [UL, UR, DL] corners (cpu/src/cam.c:35-48)."""
    cot = cam.cot_half_fov
    corners = np.array(
        [
            [-aspect_ratio, cot, +1.0],
            [+aspect_ratio, cot, +1.0],
            [-aspect_ratio, cot, -1.0],
        ],
        dtype=np.float64,
    )
    corners = _rotate(cam.rot, corners)
    return (corners + np.asarray(cam.pos, dtype=np.float64)).astype(np.float32)


def ray_basis(cam: Camera, width: int, height: int):
    """Return (origin, dir00, inc_x, inc_y) as float32 (3,) arrays.

    Per-pixel direction = dir00 + x*inc_x + y*inc_y, unnormalized
    (cpu/src/main.c:228-233, gpu/src/gpu.cu:60-68).
    """
    ul, ur, dl = screen_corners(cam, float(width) / float(height))
    inc_x = (ur - ul) / np.float32(width)
    inc_y = (dl - ul) / np.float32(height)
    origin = np.asarray(cam.pos, dtype=np.float32)
    dir00 = ul - origin
    return origin, dir00, inc_x, inc_y


def default_camera() -> Camera:
    """The harness camera (cpu/src/main.c:105-107)."""
    return Camera(
        pos=(0.0, -9.0, 3.0),
        rot=(-math.pi / 12.0, 0.0, 0.0),
        fov=math.pi / 3.2,
    )

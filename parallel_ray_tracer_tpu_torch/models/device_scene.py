"""Port of parallel_ray_tracer_tpu/models/device_scene.py, cut to what shading
needs: the lights and the ambient colour, as tensors on one device.

The triangle and material planes of the JAX DeviceScene serve its gather
path; the port's traversals return the winning triangle's normal and
material from the packed rows instead (HitFull), so it has no such planes.
All values come from the packed light table `lamb` (ops/pack.pack_lights),
the same table the fused frame kernel reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.vecmath import Vec3


class DeviceScene(NamedTuple):
    lamb: torch.Tensor      # (nl+1, 8) f32 light + ambient table
    lights_pos: Vec3        # (nl,) planes
    lights_kl: Vec3
    ambient: Vec3           # 0-d tensors

    @property
    def num_lights(self) -> int:
        return int(self.lamb.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.lamb.device


def device_scene_from_lights(lamb: torch.Tensor) -> DeviceScene:
    """Split a packed (nl+1, 8) light table into the shading planes."""
    nl = int(lamb.shape[0]) - 1
    return DeviceScene(
        lamb=lamb,
        lights_pos=Vec3(lamb[:nl, 0], lamb[:nl, 1], lamb[:nl, 2]),
        lights_kl=Vec3(lamb[:nl, 3], lamb[:nl, 4], lamb[:nl, 5]),
        ambient=Vec3(lamb[nl, 0], lamb[nl, 1], lamb[nl, 2]),
    )

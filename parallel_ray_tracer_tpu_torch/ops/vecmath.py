"""Port of parallel_ray_tracer_tpu/ops/vecmath.py: SoA 3-vectors over tensors.

Each component is its own tensor plane, as in the JAX package, so the public
functions keep its layout and tests compare like with like.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "Vec3":
        if isinstance(s, Vec3):  # elementwise, like vec_mul(v1, v2)
            return Vec3(self.x * s.x, self.y * s.y, self.z * s.z)
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __truediv__(self, s) -> "Vec3":
        return Vec3(self.x / s, self.y / s, self.z / s)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def mag2(self) -> torch.Tensor:
        return self.dot(self)

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def clamp(self, lo: float, hi: float) -> "Vec3":
        return Vec3(
            self.x.clamp(lo, hi), self.y.clamp(lo, hi), self.z.clamp(lo, hi)
        )

    def where(self, pred: torch.Tensor, other: "Vec3") -> "Vec3":
        """Select self where pred else other (lane masking)."""
        return Vec3(
            torch.where(pred, self.x, other.x),
            torch.where(pred, self.y, other.y),
            torch.where(pred, self.z, other.z),
        )

    def reshape(self, *shape) -> "Vec3":
        return Vec3(
            self.x.reshape(*shape), self.y.reshape(*shape),
            self.z.reshape(*shape),
        )

    def contiguous(self) -> "Vec3":
        return Vec3(
            self.x.contiguous(), self.y.contiguous(), self.z.contiguous()
        )

    def stack(self, dim: int = -1) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=dim)


def from_array(a: torch.Tensor) -> Vec3:
    """A Vec3 of (...,) planes from a (..., 3) tensor."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])

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


def scatter_add_f64(rows: int, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The transpose of a gather along dim 0: g's rows added at idx into
    `rows` rows, with index_add_ into an f64 buffer, rounded once to g's
    dtype.

    Plain indexing's backward (index_put_ with accumulate) sorts the indices
    and sums each run of duplicates in one thread on CUDA: with 2M rays
    gathering from a few thousand triangles (a wall hit by half the frame)
    it took 1.13 s of a 1.18 s training step at 1080p on the H100. index_add_
    adds with atomics instead; in f64 the order the atomics land in moves
    the f32 result by at most a rounding."""
    acc = g.new_zeros((rows, *g.shape[1:]), dtype=torch.float64)
    return acc.index_add_(0, idx, g.double()).to(g.dtype)


class _Take(torch.autograd.Function):
    """src.index_select(0, idx) whose backward is scatter_add_f64."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.rows = src.shape[0]
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_add_f64(ctx.rows, idx, g), None


def take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] along dim 0, for an integer idx of any shape: the gather of
    the differentiable path (the same values as src[idx])."""
    out = _Take.apply(src, idx.reshape(-1).long())
    return out.reshape(*idx.shape, *src.shape[1:])


def from_array(a: torch.Tensor) -> Vec3:
    """A Vec3 of (...,) planes from a (..., 3) tensor."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])

"""Port of parallel_ray_tracer_tpu/ops/intersect.py: the constants and the
triangle test that the traversal kernels and their plain versions share.

`mt_rows` is Möller–Trumbore on the packed triangle row layout
[v0, e1, e2, n] (n = e1 x e2), written in the same operation order as the
JAX kernels' `_mt_scalar_tri` (ops/pallas_trace.py:563-594) and the CUDA
kernels' `rt_mt` (csrc/trace.cuh), so that all three round alike.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .pack import T_MAX  # noqa: F401  (re-exported: the miss sentinel)
from .vecmath import Vec3

EPSILON = 1e-3
INV_DIR_MAX = 1e30          # finite stand-in for 1/0 (see clip_inv_dir)


def clip_inv_dir(d: Vec3) -> Vec3:
    """Reciprocal direction with infinities clamped to +/-INV_DIR_MAX, so the
    slab test never meets 0 * inf (ops/intersect.py:94-111 of the JAX
    package)."""
    return Vec3(
        (1.0 / d.x).clamp(-INV_DIR_MAX, INV_DIR_MAX),
        (1.0 / d.y).clamp(-INV_DIR_MAX, INV_DIR_MAX),
        (1.0 / d.z).clamp(-INV_DIR_MAX, INV_DIR_MAX),
    )


def mt_rows(o: Vec3, d: Vec3, rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays against packed triangle rows -> (t, det < 0).

    `rows` is (..., 12) as [v0.xyz, e1.xyz, e2.xyz, n.xyz]; the ray planes
    broadcast against rows[..., k]. Miss -> T_MAX. A zero row (padding) or a
    zero direction (a dead ray) has det == 0 and never hits.
    """
    v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
    e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
    e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
    nx, ny, nz = rows[..., 9], rows[..., 10], rows[..., 11]

    det = -(d.x * nx + d.y * ny + d.z * nz)
    invdet = 1.0 / det
    aox = o.x - v0x
    aoy = o.y - v0y
    aoz = o.z - v0z
    daox = aoy * d.z - aoz * d.y
    daoy = aoz * d.x - aox * d.z
    daoz = aox * d.y - aoy * d.x
    u = (e2x * daox + e2y * daoy + e2z * daoz) * invdet
    v = -(e1x * daox + e1y * daoy + e1z * daoz) * invdet
    t = (aox * nx + aoy * ny + aoz * nz) * invdet
    hit = (
        (det.abs() >= EPSILON)
        & (t > EPSILON)
        & (u >= 0.0)
        & (v >= 0.0)
        & ((u + v) <= 1.0)
    )
    return torch.where(hit, t, torch.full_like(t, T_MAX)), det < 0.0

"""Port of parallel_ray_tracer_tpu/ops/render.py: ray generation in the
tile-major layout, and the two BVH renderers of this slice.

Pixel (x, y) gets the unnormalised direction dir00 + x*inc_x + y*inc_y from
the camera basis. The BVH renderers trace rays in tile-major order, as
(rows, 128) planes: tiles of (tile_rows, tile_cols) pixels, row-major over
the tile grid and row-major inside a tile (ops/render.py:131-172 of the JAX
package). Colours are clamped to [0, 1] at the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.camera import Camera, ray_basis
from . import cuda_trace
from .pack import LANES
from .shade import trace_rays
from .vecmath import Vec3


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def generate_rays(origin, dir00, inc_x, inc_y, width: int, height: int,
                  device="cuda") -> Tuple[Vec3, Vec3]:
    """Per-pixel (origin, direction) planes of shape (height, width), on
    `device` (CUDA unless the caller asks for the CPU)."""
    x = torch.arange(width, dtype=torch.float32, device=device).expand(height, width)
    y = torch.arange(height, dtype=torch.float32, device=device)[:, None].expand(height, width)
    d00, ix, iy = _f32(dir00, device), _f32(inc_x, device), _f32(inc_y, device)

    def plane(c):
        return d00[c] + x * ix[c] + y * iy[c]

    d = Vec3(plane(0), plane(1), plane(2))
    o = Vec3(*(torch.full((height, width), float(c), device=device)
               for c in np.asarray(origin, np.float32)))
    return o, d


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def tile_image_shape(width: int, height: int, tr: int, tc: int):
    """Padded dims + tile grid for (tr, tc) pixel tiles."""
    wp, hp = _ceil_to(width, tc), _ceil_to(height, tr)
    return wp, hp, hp // tr, wp // tc


def tiles_to_image(flat: torch.Tensor, width, height, tr, tc) -> torch.Tensor:
    """(ntiles*K,) or (ntiles*K, C) tile-major -> (height, width[, C]), cropped."""
    wp, hp, nty, ntx = tile_image_shape(width, height, tr, tc)
    trailing = tuple(flat.shape[1:])
    img = flat.reshape(nty, ntx, tr, tc, *trailing)
    img = torch.movedim(img, 2, 1).reshape(hp, wp, *trailing)
    return img[:height, :width]


def generate_rays_tiled(cam_arrays, width, height, tr, tc,
                        device="cuda") -> Tuple[Vec3, Vec3]:
    """(ntiles*K,) origin/direction planes in tile-major order."""
    origin, dir00, inc_x, inc_y = cam_arrays
    wp, hp, nty, ntx = tile_image_shape(width, height, tr, tc)
    o, d = generate_rays(origin, dir00, inc_x, inc_y, wp, hp, device=device)

    def tilewise(p):
        return (
            p.reshape(nty, tr, ntx, tc).transpose(1, 2).reshape(nty * ntx * tr * tc)
        )

    return Vec3(*(tilewise(p) for p in o)), Vec3(*(tilewise(p) for p in d))


def _tiled_planes(cam: Camera, width, height, tile_rows, tile_cols, device):
    if (tile_rows * tile_cols) % LANES:
        raise ValueError(
            f"a tile of {tile_rows}x{tile_cols} pixels is not a whole number "
            f"of {LANES}-lane rows"
        )
    o, d = generate_rays_tiled(
        ray_basis(cam, width, height), width, height, tile_rows, tile_cols,
        device=device,
    )
    rows = o.x.shape[0] // LANES
    return o.reshape(rows, LANES), d.reshape(rows, LANES)


def _to_image(col: Vec3, width, height, tile_rows, tile_cols) -> torch.Tensor:
    flat = col.clamp(0.0, 1.0).stack(-1).reshape(-1, 3)
    return tiles_to_image(flat, width, height, tile_rows, tile_cols)


def render_bvh_fused(ds, tables, cam: Camera, width: int, height: int,
                     bounces: int = 4, tile_rows: int = 32,
                     tile_cols: int = 32) -> torch.Tensor:
    """Whole-frame render with one launch of the fused frame kernel
    (cuda_trace.frame_tiles) -> (H, W, 3) f32 in [0, 1]. The tables' box
    format (f32, bf16 pairs) picks the kernel instance."""
    o, d = _tiled_planes(cam, width, height, tile_rows, tile_cols, ds.device)
    col = cuda_trace.frame_tiles(
        tables.cbox, tables.cmeta, tables.tri, tables.attr, tables.lamb, o, d,
        bounces=bounces, leaf_size=tables.leaf_size,
        stack_depth=tables.stack_depth, compressed=tables.compressed,
    )
    return _to_image(col, width, height, tile_rows, tile_cols)


def render_bvh_pallas(ds, tables, cam: Camera, width: int, height: int,
                      bounces: int = 4, tile_rows: int = 32,
                      tile_cols: int = 32, stream: bool = False) -> torch.Tensor:
    """Pass-based render: per bounce one closest-hit launch and one any-hit
    launch per light (cuda_trace.closest_tiles_full / occluded_tiles), with
    the shading in torch (ops/shade.trace_rays). `stream` takes both
    kernels' streamed instances, as JAX's _render_bvh_pallas threads it."""
    o, d = _tiled_planes(cam, width, height, tile_rows, tile_cols, ds.device)
    kw = dict(leaf_size=tables.leaf_size, stack_depth=tables.stack_depth,
              compressed=tables.compressed, stream=stream)

    def closest(o, d):
        return cuda_trace.closest_tiles_full(
            tables.cbox, tables.cmeta, tables.tri, tables.attr, o, d, **kw,
        )

    def occluded(o, d, max_dist2):
        return cuda_trace.occluded_tiles(
            tables.cbox, tables.cmeta, tables.tri, o, d, max_dist2, **kw,
        )

    col = trace_rays(ds, closest, occluded, o, d, bounces)
    return _to_image(col, width, height, tile_rows, tile_cols)

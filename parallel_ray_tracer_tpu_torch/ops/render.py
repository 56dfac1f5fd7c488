"""Port of parallel_ray_tracer_tpu/ops/render.py: ray generation, the
brute-force renderer (the oracle), and the three BVH renderers: the fused
frame kernel, the pass-based kernels, and the packet traversal in torch ops
(variant="jax", ops/trace_bvh.py).

Pixel (x, y) gets the unnormalised direction dir00 + x*inc_x + y*inc_y from
the camera basis. The brute-force renderer traces scanline bands in row
order; the BVH renderers trace rays in tile-major order, as (rows, 128)
planes: tiles of (tile_rows, tile_cols) pixels, row-major over the tile
grid and row-major inside a tile (ops/render.py:131-172 of the JAX
package). Colours are clamped to [0, 1] at the end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.camera import Camera, ray_basis
from . import cuda_trace, trace_brute, trace_bvh
from .pack import LANES
from .shade import occluded_from_closest, trace_rays
from .vecmath import Vec3


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def generate_rays(origin, dir00, inc_x, inc_y, width: int, height: int,
                  y_offset: int = 0, rows: Optional[int] = None,
                  device="cuda") -> Tuple[Vec3, Vec3]:
    """Per-pixel (origin, direction) planes of shape (rows, width), on
    `device` (CUDA unless the caller asks for the CPU). y_offset / rows
    select a horizontal band; row r gets the direction of frame row
    r + y_offset, with the frame's arithmetic."""
    rows = height if rows is None else rows
    x = torch.arange(width, dtype=torch.float32, device=device).expand(rows, width)
    y = (torch.arange(rows, dtype=torch.float32, device=device)
         + np.float32(y_offset))[:, None].expand(rows, width)
    d00, ix, iy = _f32(dir00, device), _f32(inc_x, device), _f32(inc_y, device)

    def plane(c):
        return d00[c] + x * ix[c] + y * iy[c]

    d = Vec3(plane(0), plane(1), plane(2))
    o = Vec3(*(torch.full((rows, width), float(c), device=device)
               for c in np.asarray(origin, np.float32)))
    return o, d


def render_band(ds, closest_fn, occluded_fn, cam_arrays, width: int,
                height: int, y_offset: int, rows: int, bounces: int) -> torch.Tensor:
    """Render a band of `rows` scanlines from y_offset -> (rows, width, 3)
    f32 in [0, 1], shadow rays traced from the light (reverse_shadows=True,
    as JAX's render_band, render.py:67)."""
    origin, dir00, inc_x, inc_y = cam_arrays
    o, d = generate_rays(origin, dir00, inc_x, inc_y, width, height, y_offset,
                         rows, device=ds.device)
    col = trace_rays(ds, closest_fn, occluded_fn, o.reshape(rows * width),
                     d.reshape(rows * width), bounces, reverse_shadows=True)
    return col.clamp(0.0, 1.0).stack(-1).reshape(rows, width, 3)


def _render_bruteforce(ds, cam_arrays, width: int, height: int, bounces: int,
                       chunk: int = 512, row_chunk: int = 0,
                       y_offset: int = 0) -> torch.Tensor:
    closest_fn, occluded_fn = trace_brute.make_tracer(ds, chunk=chunk)
    if not row_chunk or row_chunk >= height:
        return render_band(ds, closest_fn, occluded_fn, cam_arrays, width,
                           height, y_offset, height, bounces)
    if height % row_chunk:
        raise ValueError(f"row_chunk {row_chunk} does not divide height {height}")
    return torch.cat([
        render_band(ds, closest_fn, occluded_fn, cam_arrays, width, height,
                    y0 + y_offset, row_chunk, bounces)
        for y0 in range(0, height, row_chunk)
    ])


def render_bruteforce(ds, cam: Camera, width: int, height: int, bounces: int = 4,
                      chunk: int = 512, row_chunk: int = 0) -> torch.Tensor:
    """The USE_BVH=0 oracle render (cpu/src/raytracer.c:112-130 semantics)
    on the scene's device -> (H, W, 3) f32 in [0, 1]. row_chunk renders the
    frame in bands of that many scanlines (it must divide the height)."""
    return _render_bruteforce(ds, ray_basis(cam, width, height), width, height,
                              bounces, chunk, row_chunk)


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


def generate_rays_tiled(cam_arrays, width, height, tr, tc, device="cuda",
                        y_offset: int = 0) -> Tuple[Vec3, Vec3]:
    """(ntiles*K,) origin/direction planes in tile-major order. y_offset
    shifts pixel rows (band rendering): row r gets the direction of frame
    row r + y_offset, with the frame's arithmetic, so a band's pixels are
    the frame's bit for bit (JAX render.py:154-178)."""
    origin, dir00, inc_x, inc_y = cam_arrays
    wp, hp, nty, ntx = tile_image_shape(width, height, tr, tc)
    o, d = generate_rays(origin, dir00, inc_x, inc_y, wp, hp, y_offset, hp, device=device)

    def tilewise(p):
        return (
            p.reshape(nty, tr, ntx, tc).transpose(1, 2).reshape(nty * ntx * tr * tc)
        )

    return Vec3(*(tilewise(p) for p in o)), Vec3(*(tilewise(p) for p in d))


def _tiled_planes(cam: Camera, width, height, tile_rows, tile_cols, device,
                  y_offset: int = 0, rows: Optional[int] = None):
    """(rows, 128) ray planes of the frame's tiles, or with y_offset / rows
    of the band of frame rows [y_offset, y_offset + rows), in the frame's
    camera basis."""
    if (tile_rows * tile_cols) % LANES:
        raise ValueError(
            f"a tile of {tile_rows}x{tile_cols} pixels is not a whole number "
            f"of {LANES}-lane rows"
        )
    o, d = generate_rays_tiled(
        ray_basis(cam, width, height), width, height if rows is None else rows,
        tile_rows, tile_cols, device=device, y_offset=y_offset,
    )
    rows = o.x.shape[0] // LANES
    return o.reshape(rows, LANES), d.reshape(rows, LANES)


def _to_image(col: Vec3, width, height, tile_rows, tile_cols) -> torch.Tensor:
    flat = col.clamp(0.0, 1.0).stack(-1).reshape(-1, 3)
    return tiles_to_image(flat, width, height, tile_rows, tile_cols)


def render_bvh_fused(ds, tables, cam: Camera, width: int, height: int,
                     bounces: int = 4, tile_rows: int = 32,
                     tile_cols: int = 32, reverse_shadows: bool = True,
                     y_offset: int = 0, rows: Optional[int] = None,
                     interpret: bool = False) -> torch.Tensor:
    """Whole-frame render with one launch of the fused frame kernel
    (cuda_trace.frame_tiles) -> (H, W, 3) f32 in [0, 1]. The tables' box
    format (f32, bf16 pairs) picks the kernel instance, their leaf size its
    L, their sphere table (ops/pack.pack_spheres) its sphere instance, and
    their C-matrix table (ops/pack.split_cmat) its MXU instance;
    reverse_shadows=False traces shadow rays from the hit points. With
    y_offset / rows it renders the band of frame rows [y_offset, y_offset +
    rows) -> (rows, W, 3), the frame's rows bit for bit (JAX
    _render_bvh_fused(y_offset), render.py:301-338). interpret=True runs
    the kernel's plain version on the tables' device (JAX's Pallas
    interpreter)."""
    o, d = _tiled_planes(cam, width, height, tile_rows, tile_cols, ds.device, y_offset, rows)
    col = cuda_trace.frame_tiles(
        tables.cbox, tables.cmeta, tables.tri, tables.attr, tables.lamb, o, d,
        bounces=bounces, leaf_size=tables.leaf_size,
        stack_depth=tables.stack_depth, compressed=tables.compressed,
        sph=tables.sph, cmat=tables.cmat, reverse_shadows=reverse_shadows,
        interpret=interpret,
    )
    return _to_image(col, width, height if rows is None else rows, tile_rows, tile_cols)


def render_bvh_pallas(ds, tables, cam: Camera, width: int, height: int,
                      bounces: int = 4, tile_rows: int = 32,
                      tile_cols: int = 32, stream: bool = False,
                      fast_light: bool = True,
                      reverse_shadows: bool = True, y_offset: int = 0,
                      rows: Optional[int] = None,
                      interpret: bool = False) -> torch.Tensor:
    """Pass-based render: per bounce one closest-hit launch and one any-hit
    launch per light (cuda_trace.closest_tiles_full / occluded_tiles), with
    the shading in torch (ops/shade.trace_rays), on the tracer pair of
    cuda_trace.make_tracer over the frame's flat ray planes, as JAX's
    _render_bvh_pallas builds it (render.py:267-274). `stream` takes both
    kernels' streamed instances. The scene's spheres are tested after each
    pass (make_tracer's `ds`, ops/spheres.wrap_tracer); with spheres the hits
    are plain and shading gathers their attributes from `ds`. The tables'
    C-matrix table takes both kernels' MXU instances where make_tracer takes
    them (dual=True: prepare uploads one only with dual_pop, as JAX's
    prepare does, and JAX's render passes dual=cfg.dual_pop).
    fast_light=False finds shadows by the closest-hit kernel
    (shade.occluded_from_closest) with forward shadow rays, and
    reverse_shadows=False traces forward ones with the any-hit kernel, as
    JAX's _render_bvh_pallas (render.py:288-295). y_offset / rows render a
    band of the frame, as render_bvh_fused's; interpret=True runs the
    kernels' plain versions on the tables' device."""
    o, d = _tiled_planes(cam, width, height, tile_rows, tile_cols, ds.device, y_offset, rows)
    closest, occluded = cuda_trace.make_tracer(
        tables.packed_dev, tables.leaf_size, ds=ds, stack_depth=tables.stack_depth,
        dual=True, compressed=tables.compressed, stream=stream, interpret=interpret)
    if not fast_light:
        occluded = occluded_from_closest(closest)
    col = trace_rays(ds, closest, occluded, o.reshape(-1), d.reshape(-1), bounces,
                     reverse_shadows=fast_light and reverse_shadows)
    return _to_image(col, width, height if rows is None else rows, tile_rows, tile_cols)


def _render_bvh_jax(ds, bvh, cam_arrays, width: int, height: int, bounces: int,
                    leaf_size: int, stack_depth: int, tile_rows: int, tile_cols: int,
                    fast_light: bool = True, y_offset: int = 0,
                    reverse_shadows: bool = True, stats=None) -> torch.Tensor:
    """JAX's _render_bvh_jax (render.py:182-213): `height` rows of tiles
    from frame row y_offset in the camera basis cam_arrays, one packet a
    tile, through the packet traversal (ops/trace_bvh.make_tracer)."""
    o, d = generate_rays_tiled(cam_arrays, width, height, tile_rows, tile_cols,
                               device=ds.device, y_offset=y_offset)
    closest_fn, occluded_fn = trace_bvh.make_tracer(
        bvh, ds, leaf_size, stack_depth, packet=tile_rows * tile_cols, stats=stats)
    if not fast_light:
        # Keep the USE_BVH_FAST_LIGHT=0 parity mode literally
        # reference-shaped: forward shadow rays.
        occluded_fn = occluded_from_closest(closest_fn)
    col = trace_rays(ds, closest_fn, occluded_fn, o, d, bounces,
                     reverse_shadows=fast_light and reverse_shadows)
    return _to_image(col, width, height, tile_rows, tile_cols)


def render_bvh_jax(ds, bvh, cam: Camera, width: int, height: int, bounces: int = 4,
                   leaf_size: int = 4, stack_depth: int = 64, tile_rows: int = 32,
                   tile_cols: int = 32, fast_light: bool = True,
                   reverse_shadows: bool = True, y_offset: int = 0,
                   rows: Optional[int] = None, stats=None) -> torch.Tensor:
    """Packet-traversal render (variant="jax", JAX render.py:216-235) ->
    (H, W, 3) f32 in [0, 1] on the scene's device: the tracer pair of
    ops/trace_bvh.make_tracer over the DeviceBVH `bvh`, one packet a tile
    of any shape, under ops/shade.trace_rays. fast_light=False finds
    shadows by the closest-hit traversal with forward shadow rays. y_offset /
    rows render the band of frame rows [y_offset, y_offset + rows), the
    frame's rows bit for bit. `stats`, a list, gets one record a pass
    (trace_bvh.make_tracer)."""
    return _render_bvh_jax(ds, bvh, ray_basis(cam, width, height), width,
                           height if rows is None else rows, bounces, leaf_size,
                           stack_depth, tile_rows, tile_cols, fast_light,
                           y_offset=y_offset, reverse_shadows=reverse_shadows,
                           stats=stats)

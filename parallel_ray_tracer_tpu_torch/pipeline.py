"""Port of parallel_ray_tracer_tpu/pipeline.py: config -> scene -> BVH ->
device tables -> render.

`prepare` loads the scene (and pre-splits its large triangles with
presplit > 0), builds, flattens and packs the BVH at the configured node
arity (bvh_width 2, 4 or 8), box format (f32, or bf16 with bf16_bvh) and
leaf size (8, 4, 2 or 1) with the port's C++ host runtime (native/, with
use_native) or its own numpy modules, decides as JAX does
whether leaf rows stream and whether the leaf test is the MXU leaf, and
uploads the tables, the packet traversal's flat tree (DeviceBVH) and the
scene planes (DeviceScene, in the BVH's slot order) once; `Pipeline.render`
then renders frames from them on the device, and `Pipeline.render_band`
bands of rows of a frame. With use_bvh=False it builds no BVH, and every
frame is the brute-force render.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch

from .config import DEFAULT_ASSET_ROOTS, RenderConfig
from .convert import SceneTables, packed_from_numpy
from .models.camera import Camera, ray_basis
from .models.device_scene import DeviceScene, device_scene_from_host
from .models.presplit import presplit_scene
from .models.procgen import substitute_scene
from .models.scene import Scene, load_scene, load_scene_npz, synthetic_scene
from .ops import render as render_ops
from .ops import trace_bvh
from .ops.bvh import build_bvh
from .ops.bvh_flat import FlatBVH, flatten_bvh
from .ops.cuda_trace import LEAF_SIZES
from .ops.pack import (LANES, TRI_STRIDE, cbox_to_bf16, mxu_decision, pack_attr,
                       pack_bvh, pack_bvh4, pack_bvh8, pack_spheres, pad_stream_rows,
                       split_cmat, stream_decision)

VARIANTS = ("auto", "fused", "pallas", "jax", "bruteforce")
PACKERS = {2: pack_bvh, 4: pack_bvh4, 8: pack_bvh8}   # by bvh_width
PACKET = 1024            # rays per TPU packet (pallas_trace.PACKET)


@dataclasses.dataclass
class Pipeline:
    """Prepared, device-resident render state."""

    cfg: RenderConfig
    scene: Scene
    ds: DeviceScene
    flat: Optional[FlatBVH]             # None when use_bvh=False
    tables: Optional[SceneTables]       # None when use_bvh=False
    build_ms: float
    bvh_stats: Optional[dict] = None    # the host tree's stats (ops/bvh.py or C++)
    builder: Optional[str] = None       # "native" (C++) or "numpy"; None without a BVH
    stream: bool = False                # streamed leaf rows (pass-based path)
    mxu: bool = False                   # the MXU leaf (tables.cmat is set)
    leaf_size: int = 8                  # triangles per leaf group (_pick_leaf_size)
    # The packet traversal's tree (variant="jax", ops/trace_bvh.py) and its
    # stack slots a packet, JAX's Pipeline.dbvh and Pipeline.stack_depth.
    # tables.stack_depth is another number: the stack entries a ray of the
    # CUDA kernels needs (ops/pack.stack_need).
    dbvh: Optional[trace_bvh.DeviceBVH] = None
    stack_depth: int = 0

    def bvh_metrics_banner(self) -> Optional[str]:
        """The reference's BVH_METRICS printout (cpu/src/bvh.c:381-387)."""
        s = self.bvh_stats
        if not s:
            return None
        return (
            f"min number of triangle: {int(s['min_leaf'])}\n"
            f"max number of triangle: {int(s['max_leaf'])}\n"
            f"avg number of triangle: {s['avg_leaf']:.2f}\n"
            f"number of leaf: {int(s['leaf_count'])}\n"
            f"bvh size (bytes): {int(s['bytes'])}"
        )

    @property
    def device(self) -> torch.device:
        return self.ds.device

    def camera(self) -> Camera:
        return Camera(pos=self.cfg.cam_pos, rot=self.cfg.cam_rot, fov=self.cfg.cam_fov)

    def resolved_variant(self, variant: Optional[str] = None) -> str:
        """Resolve "auto" (and None) as the JAX package does
        (pipeline.py:80-104): the fused whole-frame kernel when the table
        is at bvh_width >= 4, the leaf rows do not stream, shadows use the
        any-hit traversal and a tile is one 1024-ray packet; otherwise the
        pass-based path. An explicit "fused" on a streamed pipeline runs
        the resident frame kernel, as JAX's render does (it has no streamed
        frame kernel). use_bvh=False always means "bruteforce"."""
        cfg = self.cfg
        variant = variant or cfg.variant
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
        if not cfg.use_bvh:
            return "bruteforce"
        if variant != "auto":
            return variant
        fused_ok = (
            cfg.bvh_width >= 4
            and not self.stream
            and cfg.fast_light
            and cfg.tile_rows * cfg.tile_cols == PACKET
        )
        return "fused" if fused_ok else "pallas"

    def render(self, cam: Optional[Camera] = None, width: Optional[int] = None,
               height: Optional[int] = None, variant: Optional[str] = None,
               interpret: bool = False) -> torch.Tensor:
        """Render one frame -> (H, W, 3) f32 in [0, 1] on the pipeline's
        device. "fused" launches the frame kernel once; "pallas" is the
        pass-based path (one closest-hit and one any-hit launch per light,
        per bounce), on the streamed instances when the leaf rows stream;
        with the MXU leaf both take the MXU instances; "jax" is the packet
        traversal in torch ops (ops/trace_bvh.py, one packet a tile, no
        kernel); "bruteforce" tests every ray against every triangle in
        torch ops (ops/trace_brute.py). cfg.reverse_shadows picks the
        shadow rays' direction in "fused", "pallas" and "jax", and
        cfg.fast_light=False finds shadows by the closest-hit traversal in
        "pallas" and "jax", as JAX's render does. interpret=True runs the
        kernels' plain versions on the pipeline's device instead of
        launching the kernels (JAX's Pallas interpreter); "jax" and
        "bruteforce" have no kernel and ignore it."""
        cfg = self.cfg
        return self._render(cam, width or cfg.width, height or cfg.height, variant,
                            interpret=interpret)

    def render_band(self, y0: int, rows: int, cam: Optional[Camera] = None,
                    variant: Optional[str] = None, interpret: bool = False) -> torch.Tensor:
        """Render scanlines [y0, y0 + rows) of the configured frame ->
        (rows, W, 3), through the same kernels as render() (JAX
        pipeline.py:160-215). The band keeps the whole frame's camera basis
        with its rows shifted by y0, so its pixels are the same rows of a
        whole-frame render, bit for bit: the checkpointed render
        (utils/checkpoint.TileRenderCheckpoint) assembles a frame of them.
        Rows past the frame's last are traced and returned as the basis
        gives them. `interpret` as in render()."""
        cfg = self.cfg
        return self._render(cam, cfg.width, cfg.height, variant, int(y0), int(rows),
                            interpret=interpret)

    def _render(self, cam, width: int, height: int, variant, y_offset: int = 0,
                rows: Optional[int] = None, interpret: bool = False) -> torch.Tensor:
        cfg = self.cfg
        cam = cam or self.camera()
        variant = self.resolved_variant(variant)
        if variant == "bruteforce":
            return render_ops._render_bruteforce(
                self.ds, ray_basis(cam, width, height), width,
                height if rows is None else rows, cfg.bounces, y_offset=y_offset)
        kw = dict(bounces=cfg.bounces, tile_rows=cfg.tile_rows,
                  tile_cols=cfg.tile_cols, reverse_shadows=cfg.reverse_shadows,
                  y_offset=y_offset, rows=rows)
        if variant == "jax":
            return render_ops.render_bvh_jax(
                self.ds, self.dbvh, cam, width, height, leaf_size=self.leaf_size,
                stack_depth=self.stack_depth, fast_light=cfg.fast_light, **kw)
        kw.update(interpret=interpret)
        if variant == "fused":
            fn = render_ops.render_bvh_fused
        else:
            fn = render_ops.render_bvh_pallas
            kw.update(stream=self.stream, fast_light=cfg.fast_light)
        return fn(self.ds, self.tables, cam, width, height, **kw)


def _check_ported(cfg: RenderConfig) -> None:
    if cfg.bvh_width not in PACKERS:
        raise ValueError(f"bvh_width must be 2, 4 or 8, got {cfg.bvh_width}")
    if cfg.variant not in VARIANTS:
        raise ValueError(f"unknown variant {cfg.variant!r}: one of {VARIANTS}")
    if cfg.leaf_size not in (None, *LEAF_SIZES):
        raise NotImplementedError(f"not ported yet: leaf_size={cfg.leaf_size}")


def _pick_leaf_size(cfg: RenderConfig) -> int:
    """Leaf group size, as JAX's prepare picks it (pipeline.py:479-489):
    cfg.leaf_size (_check_ported has refused the sizes without kernels),
    else the largest power of two whose triangles (12 floats each) fit one
    128-lane row, 8."""
    if cfg.leaf_size is not None:
        return cfg.leaf_size
    return next(c for c in (8, 4, 2, 1) if c * TRI_STRIDE <= LANES)


def _load(cfg: RenderConfig, native=None) -> Scene:
    """Synthetic scene, else the OBJ folder (through the native loader when
    `native` is given, else the Python parser), else the repo's npz
    snapshot, else the procedural substitute (dragon, two_cars, sportscar;
    the last two need a car_only OBJ folder), as the JAX prepare
    (pipeline.py:227-257)."""
    if cfg.synthetic_triangles > 0:
        return synthetic_scene(cfg.synthetic_triangles, seed=cfg.seed)
    roots = (cfg.asset_root,) if cfg.asset_root else DEFAULT_ASSET_ROOTS
    try:
        asset_dir = cfg.asset_dir()
        return (native.load_scene_native(asset_dir) if native else None) \
            or load_scene(asset_dir)
    except FileNotFoundError:
        for root in roots:
            snap = os.path.join(root, cfg.scene + ".npz")
            if os.path.isfile(snap):
                return load_scene_npz(snap)
        scene = substitute_scene(cfg.scene, roots, seed=cfg.seed)
        if scene is None:
            raise
        return scene


def _pick_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels"
        )
    return device


def prepare(cfg: RenderConfig, scene: Optional[Scene] = None, device=None) -> Pipeline:
    """Load the scene, build + flatten + pack the BVH at cfg.bvh_width,
    upload the tables.

    bf16_bvh packs what the JAX prepare packs (pipeline.py:297-343): bf16
    pair rows at width 4 (compressed), the raw bf16 binary table at width 2
    (JAX's branch for every backend but the TPU; the card reads 16-bit rows
    directly), and f32 rows at width 8, where JAX's prepare passes
    bf16=False to pack_bvh8.

    leaf_size 8 (the default), 4, 2 or 1 packs that many triangles per leaf
    group (_pick_leaf_size), with leaves built of at least that many
    (leaf_threshold = max(cfg.leaf_threshold, leaf_size)), as JAX's prepare
    does; the kernels have instances at each, and at 2 and 1 the leaf test
    is the FP32 one (mxu_decision, as JAX's rule). presplit > 0
    splits the scene's large triangles before the build
    (models/presplit.presplit_scene), as JAX's prepare does
    (pipeline.py:259-262).

    The device defaults to CUDA; with no card, pass device="cpu". With
    use_native (the default) the scene folder is parsed and the BVH built,
    flattened and packed by the C++ host runtime (native/builder.py), as
    JAX's prepare does (pipeline.py:221-250, 281-325): the binary table
    comes from C++, widths 4 and 8 repack its flat tree, and a bf16 binary
    table rounds its boxes (cbox_to_bf16). Where g++ is missing or fails,
    and with use_native=False, the numpy builder runs; Pipeline.builder
    says which ran. Both build the same tree. dual_pop changes nothing:
    one thread traces one ray, so both schedules reach the same kernels.

    Leaf rows stream by the JAX prepare's rule (ops/pack.stream_decision,
    pipeline.py:350-368): stream="on" always, "off" never, "auto" when
    JAX's row model passes its 126 MiB ceiling (about 450k triangles).
    Streamed tables have tri and attr padded to whole blocks
    (pad_stream_rows); streaming at bvh_width 2 raises ValueError, as JAX
    asserts it.

    The leaf test is the MXU leaf by the JAX prepare's rule
    (ops/pack.mxu_decision, pipeline.py:407-446): mxu_leaf and dual_pop,
    bvh_width 4 or 8, leaf rows not streamed, and the padded C-matrix
    table plus the scene rows within JAX's TPU budget of 88 MiB (car_boxed
    passes, the 180k-triangle dragon does not). The C-matrix table is
    then uploaded split into bf16 halves (ops/pack.split_cmat) as
    tables.cmat, which sends both the fused frame and the pass-based
    tracer through the MXU instances; Pipeline.mxu records the choice.

    The scene's spheres go into the DeviceScene (the pass-based, packet and
    brute-force paths test them in torch) and into the tables' sphere
    table (pack_spheres; the fused frame kernel tests them). The packet
    traversal's tree (Pipeline.dbvh, ops/trace_bvh.device_bvh_from_flat)
    takes bf16 boxes with bf16_bvh at every width, as JAX's prepare builds
    it (pipeline.py:382-383), though the width-8 tables stay f32.
    use_bvh=False builds no BVH: the DeviceScene alone is uploaded."""
    _check_ported(cfg)
    device = _pick_device(device)
    native = None
    if cfg.use_native:
        from .native import builder as native

        if not native.available():
            native = None
    if scene is None:
        scene = _load(cfg, native)
    if cfg.presplit > 0 and scene.num_triangles > 0:
        scene, _ = presplit_scene(scene, ratio=cfg.presplit)
    leaf_size = _pick_leaf_size(cfg)
    if not cfg.use_bvh:
        ds = device_scene_from_host(scene, ambient=cfg.ambient, device=device)
        return Pipeline(cfg=cfg, scene=scene, ds=ds, flat=None, tables=None,
                        build_ms=0.0, leaf_size=leaf_size)

    tv = scene.triangle_vertices()
    bf16 = cfg.bf16_bvh and cfg.bvh_width != 8
    t0 = time.perf_counter()
    res = None
    if native is not None:
        res = native.build_bvh_native(
            tv, heuristic=cfg.bvh_heuristic, max_depth=cfg.bvh_max_depth,
            leaf_threshold=max(cfg.leaf_threshold, leaf_size),
            sah_bins=cfg.sah_bins, seed=cfg.seed, leaf_size=leaf_size,
            true_sah=cfg.true_sah,
        )
    if res is not None:
        # The C++ builder packs the binary table; widths 4 and 8 repack the
        # flat tree, as JAX's prepare does (pipeline.py:318-329).
        flat, packed, bvh_stats = res
        if cfg.bvh_width != 2:
            packed = PACKERS[cfg.bvh_width](flat, tv, bf16=bf16)
        elif bf16:
            packed = dataclasses.replace(packed, cbox=cbox_to_bf16(packed.cbox))
        builder = "native"
    else:
        bvh = build_bvh(
            tv, heuristic=cfg.bvh_heuristic, max_depth=cfg.bvh_max_depth,
            leaf_threshold=max(cfg.leaf_threshold, leaf_size),
            sah_bins=cfg.sah_bins, seed=cfg.seed, true_sah=cfg.true_sah,
        )
        flat = flatten_bvh(bvh, tv, leaf_size=leaf_size)
        packed = PACKERS[cfg.bvh_width](flat, tv, bf16=bf16)
        bvh_stats = bvh.stats
        builder = "numpy"
    attr = pack_attr(flat, scene.mat_idx, scene.mats_kd, scene.mats_ks, scene.mats_kr)
    build_ms = (time.perf_counter() - t0) * 1e3

    tri = packed.tri
    stream = stream_decision(packed.cbox.shape[0], packed.cmeta.shape[0],
                             tri.shape[0], cfg.stream)
    if stream:
        if cfg.bvh_width < 4:
            raise ValueError("streaming needs bvh_width >= 4 (stream="
                             f"{cfg.stream!r} at bvh_width {cfg.bvh_width})")
        tri, attr = pad_stream_rows(tri), pad_stream_rows(attr)
    ds = device_scene_from_host(scene, ambient=cfg.ambient,
                                slot_map=flat.slot_map, device=device)
    sph = pack_spheres(scene.spheres_center, scene.spheres_radius,
                       scene.spheres_mat, scene.mats_kd, scene.mats_ks,
                       scene.mats_kr)
    scene_bytes = packed.cbox.nbytes + packed.cmeta.nbytes + packed.tri.nbytes + attr.nbytes
    # The native binary table carries no C-matrices; width 2 never takes
    # the MXU leaf.
    mxu = packed.cmat is not None and mxu_decision(
        cfg, packed.cmat.shape[0], scene_bytes, stream, leaf_size)
    tables = packed_from_numpy(
        packed.cbox, packed.cmeta, tri, attr, ds.lamb.cpu().numpy(),
        device=device, leaf_size=leaf_size, compressed=packed.compressed,
        sph=sph, cmat=split_cmat(packed.cmat) if mxu else None,
    )
    dbvh, _, stack_depth = trace_bvh.device_bvh_from_flat(flat, bf16=cfg.bf16_bvh,
                                                          device=device)
    return Pipeline(cfg=cfg, scene=scene, ds=ds, flat=flat, tables=tables,
                    build_ms=build_ms, bvh_stats=bvh_stats, stream=stream, mxu=mxu,
                    builder=builder, leaf_size=leaf_size, dbvh=dbvh,
                    stack_depth=stack_depth)

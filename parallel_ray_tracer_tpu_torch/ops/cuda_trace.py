"""Port of the device half of parallel_ray_tracer_tpu/ops/pallas_trace.py: the
wrappers of the CUDA traversal kernels (csrc/trace.cuh), at node arity 2, 4
and 8, on f32 or bf16 node boxes, with the FP32 or the MXU leaf test, at
leaf size 8, 4, 2 or 1, and `make_tracer`, the (closest, occluded) pair
over flat ray planes built on them.

| wrapper              | kernel                        | replaces (pallas_trace.py)                                                  |
| -------------------- | ----------------------------- | --------------------------------------------------------------------------- |
| `closest_tiles`      | `closest_kernel<A, F, false>` | `_closest_dual_kernel(n_attr=0)` :1774, `_closest4_kernel` :825, `_closest_kernel` :610 |
| `closest_tiles_full` | `closest_kernel<A, F, true>`  | `_closest_dual_kernel(n_attr=12)` :1774, `_closest_attr_kernel` :2437       |
| `occluded_tiles`     | `occluded_kernel<A, F>`       | `_occluded_dual_kernel` :1835, `_occluded4_kernel` :886, `_occluded_kernel` :676 |
| `frame_tiles`        | `frame_kernel<A, F>`, A 4, 8  | `_frame_fused_kernel` :2536                                                 |
| `frame_tiles`, `sph` of S > 0 rows | `frame_kernel<A, F, COUNT, SPH = true>`, A 4, 8 | `_frame_fused_kernel(num_spheres > 0)` :2536 (`sphere_t` :2604, `sphere_closest_merge` :2626, `sphere_occluded_merge` :2655) |
| `closest_tiles`, `closest_tiles_full`, `stream=True` | `closest_kernel<A, F, FULL, COUNT, true>`, A 4, 8 | `_closest_stream_kernel(n_attr=0, 12)` :2070 |
| `occluded_tiles`, `stream=True` | `occluded_kernel<A, F, COUNT, true>`, A 4, 8 | `_occluded_stream_kernel` :2253 |
| each, with `cmat`    | the same kernels with `MXU = true`, A 4, 8 | their `mxu=True` instances: the MXU leaf `_mxu_*` :1002-1466 |
| `make_tracer`        | closest_tiles(_full), occluded_tiles | `make_tracer` :3361 |

The arity A comes from the node table (cbox row width 16, 32 or 64, as
pallas_trace.py:3068), the box format F from its dtype and `compressed`:
  - f32 cbox: RT_F32;
  - f32 cbox with compressed=True, A 4 or 8: RT_PAIRS, the bf16 (min|max)
    pair rows of pack_box_bf16_pairs (the kernels' compressed=True
    instances); compressed=True at A 2 raises ValueError, as JAX asserts;
  - torch.bfloat16 cbox (A 2 only): RT_BF16, the raw bf16 binary table of
    cbox_to_bf16, which JAX's binary kernels read with .astype(f32).
Rays come as (rows, 128) f32 planes in the tile-major
order of ops/render.generate_rays_tiled. The signatures are the JAX ones
without the TPU schedule knobs (dual, npop, nleaf, adaptive, smem_meta,
sort): one thread traces one ray, so none of them applies, and the JAX
single-pop and dual-pop kernels of one arity map to the same instance.

`cmat`, the MXU leaf's C-matrix table as a torch.bfloat16 tensor ((G+1)*32
rows of [hi(16) | lo(16)], ops/pack.split_cmat; or the four-group
(ceil((G+1)/4)*32, 128) layout of ops/pack.pack_cmi4, whose hits are the
same bit for bit), takes the MXU instances under JAX's own condition
(pallas_trace.py:3084, :2896): arity 4 or 8, leaf size 4 or 8, and leaf
rows not streamed. At arity 2, at leaf size 1 or 2 and with stream=True
the FP32 instances run, as JAX's wrappers fall back to the VPU leaf. The
MXU instances test each leaf group as a tensor-core product of the rays'
features with the group's C-matrix (bf16x3, csrc/trace.cuh); their hits
are held to the repo's hit bounds against the FP32 ones, never bit for bit. A cmat of another dtype, width
or row count raises ValueError.

`stream=True` takes the instances with streamed leaf rows: the resident
traversal on tables padded to whole blocks, with nothing asked for ahead
(csrc/trace.cuh); their hits are those of the resident instances. As in
JAX they exist at arity 4 and 8 only: a binary table raises ValueError, and so does a `tri` or `attr` that is not
padded to whole blocks of STREAM_BLK rows (ops/pack.pad_stream_rows), on
every device.

A tensor on the CPU runs the kernel's plain version (ops/trace_plain.py, and
ops/shade.trace_rays for the frame; the `*_mxu_plain` versions with
`cmat`); the plain versions read no node table, so they are the oracle for
every box format. A CUDA tensor launches the kernel, or raises: there is no
fallback. `interpret=True` (default False) runs the plain version on the
tensors' own device, a CUDA tensor too, and counts no launch: the port's
counterpart of JAX's `interpret`, which runs a Pallas kernel's body in the
interpreter instead of the compiled kernel. Each wrapper checks device,
dtype, shape and contiguity, counts
its launches in `LAUNCHES` by kernel, arity and format (keys such as
"closest_full<8>", or "frame<8,bf16>" and "occluded<2,bf16>" for the bf16
instances, "closest_full_stream<4>" for a streamed one, "frame_mxu<4>" or
"occluded_mxu<8,bf16,deep>" for an MXU one; ",l4", ",l2" or ",l1" at leaf
sizes 4, 2 and 1, as "frame_mxu<4,l4>" or "closest_stream<8,bf16,l1>"),
and raises if the launch reported an error.

`leaf_size` is the triangles per leaf group of the tables (L, of the packed
rows g * L + j): each kernel has instances at L = 8, 4, 2 and 1
(LEAF_SIZES), every power of two whose triangles fit one 128-lane row, as
JAX's _pick_leaf_size accepts them (pipeline.py:479-489); the MXU instances
at L = 8 and 4 only (MXU_LEAF_SIZES), where JAX takes its MXU leaf. Any
other size raises NotImplementedError, on every device. An MXU table has
4L rows per group. The fused frame traces shadow rays from the light
(reverse_shadows=True) or from the hit point to the light
(reverse_shadows=False), as JAX's frame kernel does; the pass-based path
takes either direction in ops/shade. The fused frame
exists at arity 4 and 8 only (as in JAX); binary tables raise ValueError
there. `sph`, the (S, 16) table of ops/pack.pack_spheres, takes the
frame's sphere instance (key "frame_sph<4>"); None or S = 0 takes the
sphere-free one.

Stack tiers: a tree whose traversal needs more stack entries per ray
(`stack_depth`, ops/pack.stack_need) than the standard tier holds
(STACK_SIZE) takes every kernel's DEEP instance, whose stack lives in a
buffer of stack_depth entries per ray that the wrapper allocates
(csrc/trace.cuh); its keys end in ",deep" ("closest<8,deep>"). No depth is
refused, as JAX sizes its stack to the tree. The plain versions use no
stack.

`counters=True` (CUDA only) launches the kernel's counting instance and also
returns an int64 tensor of the `COUNTS` sums over the rays (`STREAM_COUNTS`
for a streamed launch, `MXU_COUNTS` for an MXU one); the closest-hit and
any-hit passes follow them with `STEP_COUNTS`.
`frame_info` reads a frame instance's occupancy, registers, stack frame
and shared memory (CUDA only).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from .._build import error_string, load_library
from ..models.device_scene import device_scene_from_lights
from .intersect import T_MAX
from .pack import ARITY_OF_WIDTH, LANES, META_WIDTH, STREAM_BLK, stack_need
from .shade import trace_rays
from .spheres import nearest_sphere, wrap_tracer
from .trace_plain import (Hit, HitFull, closest_full_mxu_plain, closest_full_plain,
                          closest_mxu_plain, closest_plain, occluded_mxu_plain,
                          occluded_plain)
from .vecmath import Vec3

# The standard tier's per-thread stack entries by arity, RtArity<A>::STACK
# in csrc/trace.cuh; a tree that needs more takes the DEEP tier.
STACK_SIZE = {2: 48, 4: 64, 8: 96}
SPHERE_COLS = 16         # floats per row of the sphere table (pack_spheres)
# Triangles per leaf group with kernel instances (the template parameter L
# of csrc/trace.cuh), and those with MXU instances.
LEAF_SIZES = (1, 2, 4, 8)
MXU_LEAF_SIZES = (4, 8)
# What counters=True returns, in order (RT_C_* in csrc/trace.cuh): node
# visits, box tests of valid children, leaf visits, triangle tests of live
# slots, traversals.
COUNTS = ("inner_visits", "box_tests", "leaf_visits", "tri_tests", "traversals")
# A streamed launch also counts the block fills (prefetches sent: none) and
# the sync fetches (leaf visits whose row no prefetch asked for: every leaf
# visit; csrc/trace.cuh).
STREAM_COUNTS = COUNTS + ("block_fills", "sync_fetches")
# An MXU launch also counts its mma batches (one per leaf group a warp
# serves: 24 mma.sync each) and the lanes served (rays that took a
# group's result; the same number as leaf_visits).
MXU_COUNTS = COUNTS + ("mma_batches", "lanes_served")
# A closest-hit or any-hit pass also counts its warp steps: those in which
# some lane visited an inner node, those in which some lane tested a leaf
# group, and the distinct leaf groups of each leaf step, summed (RT_S_* in
# csrc/trace.cuh). inner_visits / inner_steps is the lanes active a step of
# the inner branch, leaf_visits / leaf_steps those of the leaf branch,
# leaf_rows / leaf_steps the rows a leaf step loads (with the MXU leaf, its
# mma batches). An MXU instance on the loop that its while-while gate leaves
# out (rt_mxu_while_while) reads 0 there.
STEP_COUNTS = ("inner_steps", "leaf_steps", "leaf_rows")
# C-matrix table widths in bf16 values: one group per row ([hi | lo],
# ops/pack.split_cmat) or four (ops/pack.pack_cmi4). A group has 4L rows.
CMAT_WIDTHS = (32, 128)

# The arities each kernel is instantiated for; every arity also has one
# bf16 format (RT_PAIRS at 4 and 8, RT_BF16 at 2), and each instance a
# DEEP twin. "frame_sph" is the frame kernel's sphere instance.
ARITIES = {"closest": (2, 4, 8), "closest_full": (2, 4, 8),
           "occluded": (2, 4, 8), "frame": (4, 8), "frame_sph": (4, 8)}
# The box formats, as RtBox in csrc/trace.cuh.
BOX_F32, BOX_PAIRS, BOX_BF16 = 0, 1, 2
# The streamed instances (f32 and bf16 pair rows at each arity).
STREAM_ARITIES = {"closest": (4, 8), "closest_full": (4, 8), "occluded": (4, 8)}
# The MXU instances (f32 and bf16 pair rows at each arity, no streaming).
MXU_ARITIES = {k: (4, 8) for k in ARITIES}


def _leaf_tag(leaf_size: int) -> str:
    return "" if leaf_size == 8 else f",l{leaf_size}"


LAUNCHES = {f"{k}{mode}<{a}{sfx}{tier}{_leaf_tag(leaf)}>": 0
            for mode, kernels, leaves in (("", ARITIES, LEAF_SIZES),
                                          ("_stream", STREAM_ARITIES, LEAF_SIZES),
                                          ("_mxu", MXU_ARITIES, MXU_LEAF_SIZES))
            for k, arities in kernels.items() for a in arities
            for sfx in ("", ",bf16") for tier in ("", ",deep") for leaf in leaves}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _check(name: str, t: torch.Tensor, dtype, shape: Sequence, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(shape) != t.dim() or any(
        s is not None and s != ts for s, ts in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _box_format(cbox, compressed: bool):
    """(arity, box format) of a node table, from its row width, its dtype and
    `compressed`."""
    arity = ARITY_OF_WIDTH.get(cbox.shape[1]) if cbox.dim() == 2 else None
    if arity is None:
        raise ValueError(f"cbox: shape {tuple(cbox.shape)}, expected rows of "
                         f"{' or '.join(map(str, ARITY_OF_WIDTH))} values")
    if compressed and arity < 4:
        raise ValueError("bf16 pair rows (compressed=True) need a node arity of 4 or 8")
    if cbox.dtype == torch.bfloat16:
        if arity != 2:
            raise ValueError("a bf16 cbox is the binary table (N, 16); at arity "
                             "4 and 8 bf16 boxes are f32 pair rows (compressed=True)")
        return arity, BOX_BF16
    return arity, BOX_PAIRS if compressed else BOX_F32


def _check_inputs(cbox, cmeta, tri, attr, lamb, planes, leaf_size, compressed):
    """Validate tables and ray planes; returns (device, rows, arity, box
    format)."""
    device = cbox.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if leaf_size not in LEAF_SIZES:
        raise NotImplementedError(
            f"leaf_size {leaf_size} is not ported: the kernels hold "
            f"{' or '.join(map(str, LEAF_SIZES))}")
    arity, box = _box_format(cbox, compressed)
    _check("cbox", cbox, torch.bfloat16 if box == BOX_BF16 else torch.float32,
           (None, cbox.shape[1]), device)
    _check("cmeta", cmeta, torch.int32, (cbox.shape[0], META_WIDTH[arity]), device)
    _check("tri", tri, torch.float32, (None, LANES), device)
    if attr is not None:
        _check("attr", attr, torch.float32, tuple(tri.shape), device)
    if lamb is not None:
        _check("lamb", lamb, torch.float32, (None, 8), device)
    rows = planes[0].shape[0] if planes[0].dim() == 2 else -1
    for i, p in enumerate(planes):
        _check(f"ray plane {i}", p, torch.float32, (rows, LANES), device)
    return device, rows, arity, box


def _check_stream(stream, arity, tri, attr):
    """The streamed instances' conditions (pallas_trace.py:3070, 3174, 3284
    assert the arity; _pad_stream_rows pads the rows)."""
    if not stream:
        return
    if arity < 4:
        raise ValueError(f"streaming needs a node arity of 4 or 8, got {arity}")
    for name, t in (("tri", tri), ("attr", attr)):
        if t is not None and t.shape[0] % STREAM_BLK:
            raise ValueError(
                f"{name}: {t.shape[0]} rows; streamed tables hold whole blocks of "
                f"{STREAM_BLK} rows (ops/pack.pad_stream_rows)")


def _check_cmat(cmat, tri, device, mxu: bool, leaf_size: int) -> None:
    """A C-matrix table: torch.bfloat16, (rows, 32) or (rows, 128),
    contiguous, on the tables' device; where the MXU instance runs, with
    the rows of tri's groups (4L per group, or per four groups)."""
    if cmat is None:
        return
    width = cmat.shape[1] if isinstance(cmat, torch.Tensor) and cmat.dim() == 2 else None
    if width not in CMAT_WIDTHS or cmat.dtype != torch.bfloat16:
        raise ValueError(
            f"cmat: {getattr(cmat, 'dtype', type(cmat).__name__)} of shape "
            f"{tuple(getattr(cmat, 'shape', ()))}, expected torch.bfloat16 rows of 32 "
            "(ops/pack.split_cmat) or 128 values (ops/pack.pack_cmi4)")
    per_row = width // 32
    rows = -(-tri.shape[0] // per_row) * 4 * leaf_size
    if mxu and cmat.shape[0] != rows:
        raise ValueError(f"cmat: {cmat.shape[0]} rows, expected {rows} for "
                         f"{tri.shape[0]} leaf groups")
    if cmat.device != device:
        raise ValueError(f"cmat: on {cmat.device}, expected {device}")
    if not cmat.is_contiguous():
        raise ValueError("cmat: must be contiguous")


def _use_mxu(cmat, arity: int, stream: bool, leaf_size: int) -> bool:
    """JAX's condition for the MXU leaf (pallas_trace.py:3084, :2896): a
    C-matrix table, arity 4 or 8, leaf size 4 or 8, leaf rows not
    streamed. Otherwise the C-matrix table is ignored and the FP32 leaf
    runs, as in JAX."""
    return cmat is not None and arity >= 4 and leaf_size in MXU_LEAF_SIZES and not stream


def _instance(kernel: str, arity: int, box: int, stream: bool = False,
              deep: bool = False, mxu: bool = False, leaf_size: int = 8) -> str:
    """The LAUNCHES key of a launch, e.g. "closest<4,bf16>",
    "occluded_stream<8>", "frame_sph<4,deep>", "frame_mxu<4>" or, at leaf
    sizes 4, 2 and 1, "frame_mxu<4,l4>", "frame<4,l2>",
    "closest_stream<8,bf16,l1>"."""
    mode = "_stream" if stream else "_mxu" if mxu else ""
    return (f"{kernel}{mode}<{arity}{'' if box == BOX_F32 else ',bf16'}"
            f"{',deep' if deep else ''}{_leaf_tag(leaf_size)}>")


def use_deep_tier(need: int, arity: int) -> bool:
    """Whether a tree whose traversal needs `need` stack entries per ray
    takes the DEEP instances: it does when the standard tier's private
    stack (STACK_SIZE) is too small."""
    return need > STACK_SIZE[arity]


class _Launch(NamedTuple):
    lib: ctypes.CDLL
    counts: Optional[torch.Tensor]   # the counting instance's sums, or None
    deep: bool                       # the DEEP stack tier
    stk_ent: Optional[torch.Tensor]  # its (need, n) stack, or None
    stk_dst: Optional[torch.Tensor]


def count_names(stream: bool = False, mxu: bool = False, steps: bool = True) -> tuple:
    """The names of what counters=True returns for a launch: a pass
    (closest, closest_full, occluded) with steps, a frame without."""
    names = STREAM_COUNTS if stream else MXU_COUNTS if mxu else COUNTS
    return names + STEP_COUNTS if steps else names


def _launch_setup(cmeta, arity, stack_depth, counters, stream=False,
                  n_rays=0, mxu=False, steps=True) -> _Launch:
    """The library, a counts buffer, and the stack tier for the tree: the
    DEEP tier's stack of `need` entries for each of n_rays rays."""
    need = (stack_need(cmeta.cpu().numpy(), arity) if stack_depth is None
            else int(stack_depth))
    names = count_names(stream, mxu, steps)
    counts = (torch.zeros(len(names), dtype=torch.int64, device=cmeta.device)
              if counters else None)
    if not use_deep_tier(need, arity):
        return _Launch(load_library(), counts, False, None, None)
    return _Launch(load_library(), counts, True,
                   torch.empty((need, n_rays), dtype=torch.int32, device=cmeta.device),
                   torch.empty((need, n_rays), dtype=torch.float32, device=cmeta.device))


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {error_string(rc)} ({rc})")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _no_counters_on_cpu(counters):
    if counters:
        raise ValueError("counters are kept by the CUDA kernels only, not by "
                         "the plain versions (CPU tensors or interpret=True)")


def _cmat_args(cmat, mxu: bool):
    """The C entry points' (cmat pointer, row pitch): null and 0 for the
    FP32 instances."""
    return (_ptr(cmat), int(cmat.shape[1])) if mxu else (_ptr(None), 0)


def closest_tiles(cbox, cmeta, tri, o: Vec3, d: Vec3, leaf_size: int,
                  stack_depth: Optional[int] = None, counters: bool = False,
                  compressed: bool = False, stream: bool = False, cmat=None,
                  interpret: bool = False):
    """Closest hit over (rows, 128) ray planes -> Hit (t, idx, norm_dir)."""
    device, rows, arity, box = _check_inputs(cbox, cmeta, tri, None, None,
                                             (*o, *d), leaf_size, compressed)
    _check_stream(stream, arity, tri, None)
    mxu = _use_mxu(cmat, arity, stream, leaf_size)
    _check_cmat(cmat, tri, device, mxu, leaf_size)
    if device.type == "cpu" or interpret:
        _no_counters_on_cpu(counters)
        if mxu:
            return closest_mxu_plain(cmat, tri, o, d, leaf_size)
        return closest_plain(tri, o, d, leaf_size)
    ls = _launch_setup(cmeta, arity, stack_depth, counters, stream, rows * LANES, mxu)
    t = torch.empty((rows, LANES), dtype=torch.float32, device=device)
    idx = torch.empty((rows, LANES), dtype=torch.int32, device=device)
    nd = torch.empty((rows, LANES), dtype=torch.int32, device=device)
    cptr, cpitch = _cmat_args(cmat, mxu)
    rc = ls.lib.rt_closest(
        *(_ptr(p) for p in (*o, *d)), _ptr(cbox), _ptr(cmeta), _ptr(tri),
        _ptr(None), cptr, arity, box, int(stream), cpitch, leaf_size, rows * LANES,
        _ptr(ls.stk_ent), _ptr(ls.stk_dst), _ptr(t), _ptr(idx), _ptr(nd),
        _ptr(None), _ptr(ls.counts), _stream(device),
    )
    key = _instance("closest", arity, box, stream, ls.deep, mxu, leaf_size)
    LAUNCHES[key] += 1
    _raise_on(rc, key)
    hit = Hit(t=t, idx=idx, norm_dir=nd.bool())
    return (hit, ls.counts) if counters else hit


def closest_tiles_full(cbox, cmeta, tri, attr, o: Vec3, d: Vec3, leaf_size: int,
                       stack_depth: Optional[int] = None, counters: bool = False,
                       compressed: bool = False, stream: bool = False, cmat=None,
                       interpret: bool = False):
    """Closest hit plus the winning triangle's raw normal and kd/ks/kr ->
    HitFull."""
    device, rows, arity, box = _check_inputs(cbox, cmeta, tri, attr, None,
                                             (*o, *d), leaf_size, compressed)
    _check_stream(stream, arity, tri, attr)
    mxu = _use_mxu(cmat, arity, stream, leaf_size)
    _check_cmat(cmat, tri, device, mxu, leaf_size)
    if device.type == "cpu" or interpret:
        _no_counters_on_cpu(counters)
        if mxu:
            return closest_full_mxu_plain(cmat, tri, attr, o, d, leaf_size)
        return closest_full_plain(tri, attr, o, d, leaf_size)
    ls = _launch_setup(cmeta, arity, stack_depth, counters, stream, rows * LANES, mxu)
    t = torch.empty((rows, LANES), dtype=torch.float32, device=device)
    idx = torch.empty((rows, LANES), dtype=torch.int32, device=device)
    nd = torch.empty((rows, LANES), dtype=torch.int32, device=device)
    av = torch.empty((12, rows, LANES), dtype=torch.float32, device=device)
    cptr, cpitch = _cmat_args(cmat, mxu)
    rc = ls.lib.rt_closest(
        *(_ptr(p) for p in (*o, *d)), _ptr(cbox), _ptr(cmeta), _ptr(tri),
        _ptr(attr), cptr, arity, box, int(stream), cpitch, leaf_size, rows * LANES,
        _ptr(ls.stk_ent), _ptr(ls.stk_dst), _ptr(t), _ptr(idx), _ptr(nd),
        _ptr(av), _ptr(ls.counts), _stream(device),
    )
    key = _instance("closest_full", arity, box, stream, ls.deep, mxu, leaf_size)
    LAUNCHES[key] += 1
    _raise_on(rc, key)
    hit = HitFull(
        t=t, idx=idx, norm_dir=nd.bool(),
        n=Vec3(av[0], av[1], av[2]), kd=Vec3(av[3], av[4], av[5]),
        ks=Vec3(av[6], av[7], av[8]), kr=Vec3(av[9], av[10], av[11]),
    )
    return (hit, ls.counts) if counters else hit


def occluded_tiles(cbox, cmeta, tri, o: Vec3, d: Vec3, max_dist2, leaf_size: int,
                   stack_depth: Optional[int] = None, counters: bool = False,
                   compressed: bool = False, stream: bool = False, cmat=None,
                   interpret: bool = False):
    """Any hit with t*t < max_dist2 over (rows, 128) ray planes -> bool."""
    device, rows, arity, box = _check_inputs(
        cbox, cmeta, tri, None, None, (*o, *d, max_dist2), leaf_size, compressed
    )
    _check_stream(stream, arity, tri, None)
    mxu = _use_mxu(cmat, arity, stream, leaf_size)
    _check_cmat(cmat, tri, device, mxu, leaf_size)
    if device.type == "cpu" or interpret:
        _no_counters_on_cpu(counters)
        if mxu:
            return occluded_mxu_plain(cmat, tri, o, d, max_dist2, leaf_size)
        return occluded_plain(tri, o, d, max_dist2, leaf_size)
    ls = _launch_setup(cmeta, arity, stack_depth, counters, stream, rows * LANES, mxu)
    blocked = torch.empty((rows, LANES), dtype=torch.int32, device=device)
    cptr, cpitch = _cmat_args(cmat, mxu)
    rc = ls.lib.rt_occluded(
        *(_ptr(p) for p in (*o, *d)), _ptr(max_dist2), _ptr(cbox), _ptr(cmeta),
        _ptr(tri), cptr, arity, box, int(stream), cpitch, leaf_size, rows * LANES,
        _ptr(ls.stk_ent), _ptr(ls.stk_dst), _ptr(blocked), _ptr(ls.counts),
        _stream(device),
    )
    key = _instance("occluded", arity, box, stream, ls.deep, mxu, leaf_size)
    LAUNCHES[key] += 1
    _raise_on(rc, key)
    return (blocked.bool(), ls.counts) if counters else blocked.bool()


def frame_tiles(cbox, cmeta, tri, attr, lamb, o: Vec3, d: Vec3, *, bounces: int,
                leaf_size: int, stack_depth: Optional[int] = None,
                reverse_shadows: bool = True, counters: bool = False,
                compressed: bool = False, sph: Optional[torch.Tensor] = None,
                cmat=None, interpret: bool = False):
    """Fused whole-frame render over (rows, 128) ray planes -> unclamped
    colour planes (Vec3). `lamb` is the (num_lights + 1, 8) light table of
    ops/pack.pack_lights; `sph`, when it has rows, the (S, 16) sphere table
    of ops/pack.pack_spheres, merged after each traversal; `cmat` takes
    the MXU leaf in every traversal of the frame. reverse_shadows=False
    traces each shadow ray from the hit point to the light, with window
    dist^2, instead of from the light with window (dist - EPS)^2."""
    device, rows, arity, box = _check_inputs(cbox, cmeta, tri, attr, lamb,
                                             (*o, *d), leaf_size, compressed)
    if arity not in ARITIES["frame"]:
        raise ValueError(f"the fused frame needs a node arity of 4 or 8, got {arity}")
    if sph is not None:
        _check("sph", sph, torch.float32, (None, SPHERE_COLS), device)
    ns = 0 if sph is None else int(sph.shape[0])
    mxu = _use_mxu(cmat, arity, False, leaf_size)
    _check_cmat(cmat, tri, device, mxu, leaf_size)
    if device.type == "cpu" or interpret:
        _no_counters_on_cpu(counters)
        return frame_plain(tri, attr, lamb, o, d, bounces=bounces,
                           leaf_size=leaf_size, sph=sph, cmat=cmat if mxu else None,
                           reverse_shadows=reverse_shadows)
    ls = _launch_setup(cmeta, arity, stack_depth, counters, n_rays=rows * LANES, mxu=mxu,
                       steps=False)
    col = torch.empty((3, rows, LANES), dtype=torch.float32, device=device)
    cptr, cpitch = _cmat_args(cmat, mxu)
    rc = ls.lib.rt_frame(
        *(_ptr(p) for p in (*o, *d)), _ptr(cbox), _ptr(cmeta), _ptr(tri),
        _ptr(attr), cptr, _ptr(lamb), int(lamb.shape[0]) - 1,
        _ptr(sph if ns else None), ns, arity, box, cpitch, leaf_size, rows * LANES,
        int(bounces), int(not reverse_shadows), _ptr(ls.stk_ent), _ptr(ls.stk_dst),
        _ptr(col), _ptr(ls.counts), _stream(device),
    )
    key = _instance("frame_sph" if ns else "frame", arity, box, deep=ls.deep, mxu=mxu,
                    leaf_size=leaf_size)
    LAUNCHES[key] += 1
    _raise_on(rc, key)
    out = Vec3(col[0], col[1], col[2])
    return (out, ls.counts) if counters else out


FRAME_INFO = ("blocks_per_sm", "registers", "local_bytes", "dynamic_smem_bytes",
              "static_smem_bytes")


def frame_info(arity: int, *, leaf_size: int = 8, bf16: bool = False, deep: bool = False,
               mxu: bool = False, reverse_shadows: bool = True, num_lights: int = 1,
               spheres: int = 0) -> dict:
    """The resources of one frame instance on the current card (CUDA only):
    blocks per SM at the dynamic shared memory it launches with for
    num_lights lights and `spheres` sphere rows
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers, local
    bytes per thread (its stack frame), dynamic and static shared bytes per
    block, of the timed instance."""
    out = (ctypes.c_int * len(FRAME_INFO))()
    box = BOX_PAIRS if bf16 else BOX_F32
    rc = load_library().rt_frame_info(arity, box, leaf_size, int(deep), int(mxu),
                                      num_lights, spheres, int(not reverse_shadows), out)
    key = _instance("frame_sph" if spheres else "frame", arity, box, deep=deep, mxu=mxu,
                    leaf_size=leaf_size)
    if rc != 0:
        raise RuntimeError(f"{key}: rt_frame_info failed: {error_string(rc)} ({rc})")
    return dict(zip(FRAME_INFO, out))


def _merge_spheres(sph: torch.Tensor, n_slots: int, o: Vec3, d: Vec3,
                   hit: HitFull) -> HitFull:
    """The frame kernel's sphere merge into a HitFull (rt_sphere_closest,
    rt_sphere_attrs): the nearest sphere replaces the hit on a strict <,
    with the raw normal p - c at p = o + d * t, the row's kd / ks / kr, and
    its inside flag; its idx is n_slots + the sphere's row."""
    c = Vec3(sph[:, 0], sph[:, 1], sph[:, 2])
    ts, si, inside = nearest_sphere(c, sph[:, 3], o, d)
    better = ts < hit.t
    row = sph[si.long()]                                   # (..., 16)
    p = o + d * ts

    def pick(k, cur):
        return Vec3(*(torch.where(better, row[..., k + j], cur[j]) for j in range(3)))

    n = Vec3(*(torch.where(better, pc - row[..., j], cur)
               for j, (pc, cur) in enumerate(zip(p, hit.n))))
    return HitFull(
        t=torch.where(better, ts, hit.t),
        idx=torch.where(better, n_slots + si, hit.idx),
        norm_dir=torch.where(better, inside, hit.norm_dir),
        n=n, kd=pick(4, hit.kd), ks=pick(7, hit.ks), kr=pick(10, hit.kr),
    )


def frame_plain(tri, attr, lamb, o: Vec3, d: Vec3, *, bounces: int,
                leaf_size: int, sph: Optional[torch.Tensor] = None,
                cmat: Optional[torch.Tensor] = None,
                reverse_shadows: bool = True) -> Vec3:
    """Plain version of frame_kernel: the pass-based bounce loop
    (ops/shade.trace_rays) over the plain traversals, on any device, with
    the sphere rows of `sph` merged after each traversal as the kernel
    merges them; with `cmat` the MXU leaf's plain traversals; shadow rays
    in the direction reverse_shadows gives."""
    ds = device_scene_from_lights(lamb)
    n_slots = tri.shape[0] * leaf_size

    def closest(o, d):
        hit = (closest_full_plain(tri, attr, o, d, leaf_size) if cmat is None
               else closest_full_mxu_plain(cmat, tri, attr, o, d, leaf_size))
        return hit if sph is None or not len(sph) else _merge_spheres(sph, n_slots, o, d, hit)

    def occluded(o, d, m2):
        blocked = (occluded_plain(tri, o, d, m2, leaf_size) if cmat is None
                   else occluded_mxu_plain(cmat, tri, o, d, m2, leaf_size))
        if sph is None or not len(sph):
            return blocked
        ts, _, _ = nearest_sphere(Vec3(sph[:, 0], sph[:, 1], sph[:, 2]), sph[:, 3], o, d)
        return blocked | ((ts < T_MAX) & (ts * ts < m2))

    return trace_rays(ds, closest, occluded, o, d, bounces, reverse_shadows=reverse_shadows)


def make_tracer(packed_dev, leaf_size: int, ds=None, stack_depth: Optional[int] = None,
                dual: bool = False, compressed: bool = False, stream: bool = False,
                npop: int = 2, adaptive: bool = False, interpret: bool = False):
    """(closest, occluded) over flat (R,) ray planes, R % LANES == 0: the
    port of pallas_trace.make_tracer (:3361), on the wrappers above. JAX
    asserts whole 1,024-ray packets; the wrappers here need whole 128-lane
    rows only, so a frame of tiles such as 8x16 traces as it did before
    make_tracer.

    packed_dev: (cbox, cmeta, tri[, attr][, cmat]) tensors on one device.
    With `attr`, closest returns HitFull (closest_tiles_full: the winner's
    attributes resolved in the kernel), else Hit (closest_tiles); occluded
    returns the blocked mask (occluded_tiles). A trailing C-matrix table
    (torch.bfloat16, ops/pack.split_cmat) takes the MXU instances wherever
    the wrappers take them (_use_mxu: arity 4 or 8, leaf size 4 or 8, not
    streamed), and only with dual=True: JAX's closest_tiles,
    closest_tiles_full and occluded_tiles take their MXU leaf on the
    dual-pop kernels only (:3084, :3180, :3302), so with dual=False the
    C-matrix table is ignored and the FP32 leaf runs, as in JAX. `ds` (a
    DeviceScene) extends the pair with the scene's spheres
    (ops/spheres.wrap_tracer), after each pass. stack_depth is the stack
    entries a ray needs (ops/pack.stack_need, taken from cmeta once when
    None), not JAX's SMEM words.

    Beyond that choice of leaf test, dual, npop and adaptive pick the TPU
    kernels' pop schedule, which changes the visit order, not the hits
    (tests/test_kernel_variants.py:55-67): one thread traces one ray here,
    so they are accepted, checked as JAX asserts them (npop 2, 4, 8 or 16;
    wide pops on the dual-pop kernels at arity 4 or 8), and change nothing
    else. interpret=True runs the wrappers' plain versions on the tables'
    device, as JAX's `interpret` runs its kernels in the interpreter."""
    tables = tuple(packed_dev)
    cmat = None
    if len(tables) >= 5:
        cmat, tables = tables[-1], tables[:-1]
    cbox, cmeta, tri, *rest = tables
    attr = rest[0] if rest else None
    arity, _ = _box_format(cbox, compressed)
    if npop not in (2, 4, 8, 16) or (npop != 2 and not (dual and arity >= 4)):
        raise ValueError(f"npop {npop}: 2, 4, 8 or 16, and wide pops need the "
                         "dual-pop kernels (dual=True) at arity 4 or 8")
    if stack_depth is None:
        stack_depth = stack_need(cmeta.cpu().numpy(), arity)
    kw = dict(leaf_size=leaf_size, stack_depth=stack_depth, compressed=compressed,
              stream=stream, cmat=cmat if dual else None, interpret=interpret)

    def rows_of(o: Vec3) -> int:
        n = o.x.shape[0] if o.x.dim() == 1 else -1
        if n < 0 or n % LANES:
            raise ValueError(f"ray planes of shape {tuple(o.x.shape)}: make_tracer "
                             f"traces flat (R,) planes, R a multiple of {LANES}")
        return n // LANES

    def closest(o: Vec3, d: Vec3):
        rows = rows_of(o)
        o2, d2 = o.reshape(rows, LANES), d.reshape(rows, LANES)
        if attr is not None:
            h = closest_tiles_full(cbox, cmeta, tri, attr, o2, d2, **kw)
            return HitFull(h.t.reshape(-1), h.idx.reshape(-1), h.norm_dir.reshape(-1),
                           *(v.reshape(-1) for v in (h.n, h.kd, h.ks, h.kr)))
        h = closest_tiles(cbox, cmeta, tri, o2, d2, **kw)
        return Hit(*(p.reshape(-1) for p in h))

    def occluded(o: Vec3, d: Vec3, max_dist2: torch.Tensor) -> torch.Tensor:
        rows = rows_of(o)
        return occluded_tiles(cbox, cmeta, tri, o.reshape(rows, LANES),
                              d.reshape(rows, LANES), max_dist2.reshape(rows, LANES),
                              **kw).reshape(-1)

    if ds is not None:
        return wrap_tracer(ds, closest, occluded)
    return closest, occluded

"""Port of parallel_ray_tracer_tpu/parallel/sharded.py: rendering and the
differentiable training step with image tiles sharded over a mesh of
devices.

The reference parallelises pixels within one host (pthreads work-stealing,
cpu/src/main.c:214-264; a CUDA grid, gpu/src/gpu.cu:98-100). This module
spreads the same axis over devices, as the JAX module does:

  - the ray tiles (tile_rows x tile_cols pixels each) are split into one
    contiguous block per device of the mesh; the scene and its tables are
    copied to each device (once per mesh, Mesh.replica);
  - load balance: the tiles are first permuted round robin
    (round_robin_perm), so that each device gets tiles from every region of
    the image;
  - the forward render needs no collective within a process; across
    processes one all-gather assembles the frame on every process
    (parallel/distributed.py). The training step sums its loss and its
    vertex gradient over the devices, and all-reduces both across
    processes, JAX's psum (sharded.py:385).

A mesh is an ordered list of devices (`Mesh`, made by `make_mesh`), in
place of a jax.sharding.Mesh. Each device's block runs through the calls
that Pipeline.render makes: the fused frame kernel
(ops/cuda_trace.frame_tiles) or the pass-based tracer of
ops/cuda_trace.make_tracer under ops/shade.trace_rays, the packet traversal
in torch ops (ops/trace_bvh.make_tracer, variant="jax"), or the brute force
(ops/trace_brute.py). A CUDA device launches the kernels or raises; CPU
devices, and `interpret=True` on any device, run their plain versions.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..convert import SceneTables
from ..models.camera import Camera, default_camera, ray_basis
from ..models.device_scene import build_device_scene
from ..ops import cuda_trace, diff, trace_brute, trace_bvh
from ..ops.pack import LANES, stack_need
from ..ops.render import generate_rays_tiled, tile_image_shape, tiles_to_image
from ..ops.shade import occluded_from_closest, trace_rays
from ..ops.vecmath import Vec3
from ..pipeline import _pick_device
from ..utils.profiling import annotate
from . import distributed

VARIANTS = ("brute", "pallas", "jax")                        # make_train_step
RENDER_VARIANTS = ("fused", "pallas", "jax", "bruteforce")   # render_sharded
JAX_STACK_DEPTH = 96     # JAX make_train_step's default stack_depth


def _device(d) -> torch.device:
    """A torch.device with its index: "cuda" is the current card. CUDA
    without a card raises (pipeline._pick_device)."""
    d = _pick_device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _to(obj, device: torch.device):
    """obj with its tensors on `device`: tensors, named and plain tuples
    (DeviceScene, SceneTables, Vec3) rebuilt; anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == device else obj.to(device)
    if isinstance(obj, tuple):
        vals = [_to(x, device) for x in obj]
        if all(a is b for a, b in zip(vals, obj)):
            return obj
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


class Mesh(tuple):
    """An ordered list of devices (torch.device), one block of tiles each.

    `ranks` names the process that owns each device (all this process's
    outside a process group; in rank order under one) and `distributed`
    whether the mesh was made under a process group, whose processes then
    exchange their blocks. A mesh may name one device more than once: each
    entry renders its own block there. `replica` keeps one copy of the
    scene and its tables per device for the mesh's life."""

    def __new__(cls, devices: Sequence, ranks: Optional[Sequence[int]] = None,
                distributed_: bool = False):
        devs = tuple(_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self = super().__new__(cls, devs)
        self.rank = distributed.rank() if distributed_ else 0
        self.ranks = tuple(ranks) if ranks is not None else (self.rank,) * len(devs)
        if len(self.ranks) != len(devs) or list(self.ranks) != sorted(self.ranks):
            raise ValueError(f"ranks {self.ranks}: one a device, in rank order")
        self.distributed = distributed_
        self._replicas = {}
        return self

    @property
    def size(self) -> int:
        return len(self)

    @property
    def local(self) -> list:
        """The positions of this process's devices."""
        return [i for i, r in enumerate(self.ranks) if r == self.rank]

    @property
    def home(self) -> torch.device:
        """This process's first device: where results are assembled."""
        return self[self.local[0]]

    def replica(self, obj, device: torch.device):
        """obj on `device`: itself where its tensors lie there, else a copy
        made at the first call and kept."""
        key = (id(obj), device)
        hit = self._replicas.get(key)
        if hit is not None and hit[0] is obj:
            return hit[1]
        moved = _to(obj, device)
        if moved is not obj:
            self._replicas[key] = (obj, moved)
        return moved

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self]}, ranks={list(self.ranks)})"


def as_mesh(mesh) -> Mesh:
    """A Mesh from a Mesh, one device (a name or torch.device), a sequence
    of devices of this process, or None (the card)."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None or isinstance(mesh, (str, torch.device)):
        return Mesh([mesh])
    return Mesh(list(mesh))


def make_mesh(n_devices: Optional[int] = None, device=None, devices=None) -> Mesh:
    """The mesh of n_devices devices (JAX sharded.py:42).

    In one process: with device "cuda" (the default) the first n_devices
    visible cards, all of them when n_devices is None; asking for more
    cards than there are raises RuntimeError, never a smaller mesh. With
    device "cpu", n_devices (default 1) virtual CPU devices: the CPU named
    n times, the counterpart of XLA's xla_force_host_platform_device_count.
    `devices` names this process's devices outright (the same card may
    appear more than once).

    Under a process group (distributed.initialize) the mesh is global: each
    process's devices in rank order. Each process brings `devices`, or
    n_devices / world_size of its own (default one): CPU devices, or the
    cards from its current card on (NCCL: LOCAL_RANK's, times that count)."""
    world = distributed.world_size()
    if devices is None:
        kind = torch.device(device if device is not None else "cuda").type
        if n_devices is not None and (n_devices < 1 or n_devices % world):
            raise ValueError(f"{n_devices} devices over {world} processes")
        per = None if n_devices is None else n_devices // world
        if kind == "cpu":
            devices = ["cpu"] * (per or 1)
        elif kind == "cuda":
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if world > 1 or distributed.active():
                per = per or 1
                first = torch.cuda.current_device() * per if have else 0
            else:
                per, first = (have if per is None else per), 0
            if have < first + per or per < 1:
                raise RuntimeError(f"a mesh of {per} cards from cuda:{first}: "
                                   f"{have} visible")
            devices = [f"cuda:{first + j}" for j in range(per)]
        else:
            raise ValueError(f"device {device!r}: cuda or cpu")
    local = [str(_device(d)) for d in devices]
    if not distributed.active():
        return Mesh(local)
    every = [None] * world
    dist.all_gather_object(every, local)
    return Mesh([d for part in every for d in part],
                [r for r, part in enumerate(every) for _ in part], distributed_=True)


def round_robin_perm(ntiles: int, n_devices: int) -> np.ndarray:
    """Permutation placing tiles on devices round robin (JAX sharded.py:48).

    With contiguous blocks of the permuted tiles, device d receives tiles
    {d, d + D, d + 2D, ...} of the original order, interleaving image
    regions so that each device's ray cost evens out (the static substitute
    for the CPU reference's atomic scanline stealing,
    cpu/src/main.c:252-261)."""
    if ntiles % n_devices:
        raise ValueError(f"{ntiles} tiles do not split over {n_devices} devices")
    per = ntiles // n_devices
    # perm[k] = original tile index placed at position k.
    return np.arange(ntiles).reshape(per, n_devices).T.reshape(ntiles).astype(np.int32)


def _pad_tiles(ntiles: int, n_devices: int) -> int:
    return -(-ntiles // n_devices) * n_devices


def _on(device: torch.device):
    """The device's context: CUDA launches there go to its card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _tracers(kind: str, tracer_data, ds, leaf_size: int, stack_depth, compressed: bool,
             dual: bool, stream: bool, npop: int, npop0: int, adaptive: bool,
             fast_light: bool, K: int, interpret: bool = False):
    """(closest, occluded) at the pass-based render's kernel schedule (JAX
    sharded.py:135-155, 308-340): kind "pallas", the traversal kernels
    through cuda_trace.make_tracer on the tables `tracer_data`; "jax", the
    packet traversal (trace_bvh.make_tracer on the DeviceBVH `tracer_data`,
    one packet a tile of K rays); "brute", the brute force. npop0 != npop
    gives the first bounce its own kernel tracer (per-bounce lists; the pop
    widths change no hit here); fast_light=False finds shadows by the
    closest-hit traversal."""
    if kind == "brute":
        closest_fn, occluded_fn = trace_brute.make_tracer(ds)
    elif kind == "jax":
        closest_fn, occluded_fn = trace_bvh.make_tracer(tracer_data, ds, leaf_size,
                                                        stack_depth, packet=K)
    else:
        packed_dev = tracer_data
        kw = dict(ds=ds, stack_depth=stack_depth, compressed=compressed, dual=dual,
                  stream=stream, adaptive=adaptive, interpret=interpret)
        closest_fn, occluded_fn = cuda_trace.make_tracer(packed_dev, leaf_size, npop=npop, **kw)
        if npop0 and npop0 != npop:
            c0, o0 = cuda_trace.make_tracer(packed_dev, leaf_size, npop=npop0, **kw)
            closest_fn, occluded_fn = [c0, closest_fn], [o0, occluded_fn]
    if not fast_light:
        occluded_fn = ([occluded_from_closest(c) for c in closest_fn]
                       if isinstance(closest_fn, list) else occluded_from_closest(closest_fn))
    return closest_fn, occluded_fn


def _gather(mesh: Mesh, blocks: dict, per: int) -> torch.Tensor:
    """The blocks of every device of the mesh, in mesh order, on this
    process's home device. Across processes an all-gather exchanges them
    (gloo on CPU tensors, NCCL on CUDA tensors), each process's part padded
    to the largest part."""
    home = mesh.home
    mine = torch.cat([blocks[i].to(home) for i in sorted(blocks)])
    if not mesh.distributed:
        return mine
    world = distributed.world_size()
    counts = [mesh.ranks.count(r) for r in range(world)]
    comm = home if dist.get_backend() == "nccl" else torch.device("cpu")
    buf = F.pad(mine.to(comm), (0, 0) * (mine.dim() - 1) + (0, (max(counts) - len(blocks)) * per))
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    return torch.cat([p[:c * per] for p, c in zip(parts, counts)]).to(home)


def render_sharded(ds, tables, cam: Camera, width: int, height: int, mesh,
                   bounces: int = 4, leaf_size: Optional[int] = None,
                   stack_depth: Optional[int] = None, tile_rows: int = 32,
                   tile_cols: int = 32, variant: str = "pallas",
                   compressed: Optional[bool] = None, dual: bool = True,
                   stream: bool = False, npop: int = 2, npop0: int = 0,
                   fast_light: bool = True, reverse_shadows: bool = True,
                   adaptive: bool = False, interpret: bool = False) -> torch.Tensor:
    """Render with the image's tiles sharded over `mesh` (scene replicated)
    -> (H, W, 3) f32 in [0, 1] on this process's first mesh device (JAX
    sharded.py:195-236).

    The tiled rays are made once, padded with zero rays (a zero direction
    is dead in every kernel and plain version) to a multiple of the mesh
    size, permuted round robin and cut into one contiguous block per device.
    Each device renders its block with its copy of `ds` and `tables`:
    "fused" in one frame-kernel launch (cuda_trace.frame_tiles, with the
    tables' leaf size, box format, spheres and C-matrix table, as
    render_bvh_fused), "pallas" by the pass-based path (cuda_trace.
    make_tracer and shade.trace_rays, as render_bvh_pallas; `stream` takes
    the streamed instances), "jax" by the packet traversal in torch ops
    (trace_bvh.make_tracer, one packet a tile, as render_bvh_jax), and
    "bruteforce" by the brute force (tables may be None). The blocks are
    gathered (across processes too, on every process), unpermuted and
    cropped.

    tables: the pipeline's SceneTables, or for "jax" its DeviceBVH
    (Pipeline.dbvh, JAX's tracer_data), with the pipeline's leaf_size and
    stack_depth (Pipeline.stack_depth), both required. For the kernels,
    leaf_size and compressed, when given, must be the tables' own;
    stack_depth is the stack entries a ray needs (the tables' when None).
    dual, npop, npop0 and adaptive are JAX's kernel schedule, accepted as
    make_tracer accepts them; fast_light and reverse_shadows are the
    pipeline's shadow knobs; interpret=True runs the kernels' plain
    versions on each mesh device. With the same knobs the frame is
    Pipeline.render's: each ray is traced alone, and with "jax" each tile
    is its packet either way."""
    if variant not in RENDER_VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {RENDER_VARIANTS}")
    brute = variant == "bruteforce"
    if variant == "jax":
        if not isinstance(tables, trace_bvh.DeviceBVH):
            raise ValueError('variant="jax" needs the pipeline\'s DeviceBVH (Pipeline.dbvh)')
        if leaf_size is None or stack_depth is None:
            raise ValueError('variant="jax" needs the pipeline\'s leaf_size and stack_depth')
    elif not brute:
        if not isinstance(tables, SceneTables):
            raise ValueError(f'variant={variant!r} needs the pipeline\'s SceneTables')
        for name, given in (("leaf_size", leaf_size), ("compressed", compressed)):
            if given is not None and given != getattr(tables, name):
                raise ValueError(f"{name}={given}: the tables' is {getattr(tables, name)}")
        stack_depth = tables.stack_depth if stack_depth is None else stack_depth
    mesh = as_mesh(mesh)
    K = tile_rows * tile_cols
    if K % LANES and variant in ("fused", "pallas"):
        raise ValueError(f"a tile of {tile_rows}x{tile_cols} pixels is not a whole "
                         f"number of {LANES}-lane rows")
    _, _, nty, ntx = tile_image_shape(width, height, tile_rows, tile_cols)
    ntiles = nty * ntx
    ntiles_p = _pad_tiles(ntiles, mesh.size)
    per = ntiles_p // mesh.size
    home = mesh.home
    o, d = generate_rays_tiled(ray_basis(cam, width, height), width, height, tile_rows,
                               tile_cols, device=home)
    perm = torch.as_tensor(round_robin_perm(ntiles_p, mesh.size), dtype=torch.long,
                           device=home)

    def blocks_of(p):
        return F.pad(p.reshape(ntiles, K), (0, 0, 0, ntiles_p - ntiles))[perm]

    o_t, d_t = Vec3(*(blocks_of(p) for p in o)), Vec3(*(blocks_of(p) for p in d))
    out = {}
    for i in mesh.local:
        dev = mesh[i]
        rows = slice(i * per, (i + 1) * per)
        with _on(dev), annotate(f"render_sharded/{i}"):
            ob = Vec3(*(p[rows].reshape(-1).to(dev) for p in o_t))
            db = Vec3(*(p[rows].reshape(-1).to(dev) for p in d_t))
            ds_r = mesh.replica(ds, dev)
            if variant == "fused":
                T = mesh.replica(tables, dev)
                n = per * K // LANES
                col = cuda_trace.frame_tiles(
                    T.cbox, T.cmeta, T.tri, T.attr, T.lamb, ob.reshape(n, LANES),
                    db.reshape(n, LANES), bounces=bounces, leaf_size=T.leaf_size,
                    stack_depth=stack_depth, compressed=T.compressed, sph=T.sph,
                    cmat=T.cmat, reverse_shadows=reverse_shadows,
                    interpret=interpret).reshape(-1)
            else:
                T = None if brute else mesh.replica(tables, dev)
                pallas = variant == "pallas"
                closest_fn, occluded_fn = _tracers(
                    "brute" if brute else variant, T.packed_dev if pallas else T, ds_r,
                    T.leaf_size if pallas else leaf_size, stack_depth,
                    pallas and T.compressed, dual, stream, npop, npop0, adaptive,
                    fast_light, K, interpret)
                col = trace_rays(ds_r, closest_fn, occluded_fn, ob, db, bounces,
                                 reverse_shadows=fast_light and reverse_shadows)
            out[i] = col.clamp(0.0, 1.0).stack(-1).reshape(per, K, 3)
    img = _gather(mesh, out, per)
    img = img[torch.argsort(perm)][:ntiles].reshape(ntiles * K, 3)
    return tiles_to_image(img, width, height, tile_rows, tile_cols)


# ---------------------------------------------------------------------------
# Differentiable training step
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the processes (gloo on a CPU copy)."""
    if dist.get_backend() == "nccl":
        dist.all_reduce(t)
        return t
    c = t.cpu()
    dist.all_reduce(c)
    return c.to(t.device)


class TrainStep:
    """step(verts, o_t, d_t, target) -> (verts - lr * grad, loss): one SGD
    step of make_train_step over its mesh. The inputs are the whole frame's
    (ntiles_p, K) ray planes and (ntiles_p, K, 3) target (prepare_inputs);
    device i of the mesh takes tiles [i * per, (i + 1) * per) with its own
    copy of the vertices in the autograd graph. `forward` renders this
    process's blocks and `loss` sums their real tiles' square errors, each
    in the graph of `verts`."""

    def __init__(self, mesh: Mesh, make_tracers, consts, faces, mat_idx, slot_map,
                 bounces: int, lr: float, variant: str, reverse_shadows: bool,
                 ntiles: int, per: int, K: int):
        self.mesh = mesh
        self._make_tracers = make_tracers
        self._consts = consts
        self._faces, self._mat_idx, self._slot_map = faces, mat_idx, slot_map
        self.bounces, self.lr, self.variant = bounces, lr, variant
        self._reverse_shadows = reverse_shadows
        self._ntiles, self._per = ntiles, per
        self._n_real = ntiles * K * 3
        self.device = mesh.home

    def _block(self, i: int, verts: torch.Tensor, o_t: Vec3, d_t: Vec3) -> torch.Tensor:
        """Device i's (per, K, 3) colours in [0, 1] (sharded.py:342-366)."""
        dev = self.mesh[i]
        rows = slice(i * self._per, (i + 1) * self._per)
        kd, ks, kr, lp, kl = self.mesh.replica(self._consts, dev)
        ds = build_device_scene(verts.to(dev), self._faces, self._mat_idx, kd, ks, kr, lp, kl,
                                slot_map=self._slot_map, device=dev)
        ob, db = Vec3(*(p[rows].to(dev) for p in o_t)), Vec3(*(p[rows].to(dev) for p in d_t))
        nt, K = ob.x.shape
        of, df = ob.reshape(-1), db.reshape(-1)
        closest_fn, occluded_fn = self._make_tracers(ds, dev)
        if self.variant == "brute":
            # the brute-force oracle never reverses shadows (sharded.py:357-359)
            col = trace_rays(ds, closest_fn, occluded_fn, of, df, self.bounces)
        else:
            col = diff.trace_rays_diff(ds, closest_fn, occluded_fn, of, df, self.bounces,
                                       reverse_shadows=self._reverse_shadows)
        return col.clamp(0.0, 1.0).stack(-1).reshape(nt, K, 3)

    def forward(self, verts: torch.Tensor, o_t: Vec3, d_t: Vec3) -> torch.Tensor:
        """This process's tiles (all of them outside a process group) ->
        (tiles, K, 3) colours in [0, 1] on the home device."""
        out = []
        for i in self.mesh.local:
            with _on(self.mesh[i]):
                out.append(self._block(i, verts, o_t, d_t).to(self.device))
        return out[0] if len(out) == 1 else torch.cat(out)

    def loss(self, verts, o_t: Vec3, d_t: Vec3, target: torch.Tensor) -> torch.Tensor:
        """Mean square over the real tiles' colours (sharded.py:368-396):
        pad tiles (past ntiles) add nothing. Under a process group, this
        process's share; the step all-reduces it."""
        parts = []
        for i in self.mesh.local:
            real = min(max(self._ntiles - i * self._per, 0), self._per)
            rows = slice(i * self._per, i * self._per + real)
            with _on(self.mesh[i]):
                img = self._block(i, verts, o_t, d_t)[:real]
                err = ((img - target[rows].to(img.device)) ** 2).sum() / self._n_real
            parts.append(err.to(self.device))
        return parts[0] if len(parts) == 1 else torch.stack(parts).sum()

    def __call__(self, verts, o_t: Vec3, d_t: Vec3, target: torch.Tensor):
        v = verts.detach().requires_grad_(True)
        loss = self.loss(v, o_t, d_t, target)
        (grad,) = torch.autograd.grad(loss, v)
        loss = loss.detach()
        if self.mesh.distributed:
            loss, grad = _all_reduce(loss), _all_reduce(grad)
        with torch.no_grad():
            return v.detach() - self.lr * grad, loss


def _train_mesh(mesh, device) -> Mesh:
    """The step's mesh: `mesh` (None: `device`, else the card); a `device`
    given beside a mesh must be the mesh's first device of this process."""
    if mesh is None:
        return as_mesh(device)
    mesh = as_mesh(mesh)
    if device is not None and torch.device(device) != mesh.home:
        raise ValueError(f"mesh {mesh} and device {device} name different devices")
    return mesh


def make_train_step(scene, mesh, width: int, height: int, bounces: int = 1,
                    lr: float = 1e-2, tile_rows: int = 32, tile_cols: int = 32,
                    variant: str = "brute", tracer_data=None, leaf_size: int = 8,
                    stack_depth: Optional[int] = None, slot_map=None,
                    compressed: bool = False, dual: bool = True, stream: bool = False,
                    npop: int = 2, npop0: int = 0, fast_light: bool = True,
                    reverse_shadows: bool = True, adaptive: bool = False, device=None,
                    interpret: bool = False):
    """(step, prepare_inputs) of an SGD step on the vertex positions against
    a target image (sharded.py:239-419), over the devices of `mesh`.

    variant selects the differentiable forward:
      - "brute": the all-triangles tracer (ops/trace_brute.py) in torch ops,
        differentiated end to end; it never reverses shadows;
      - "pallas": the traversal kernels through ops/cuda_trace.make_tracer,
        wrapped by ops/diff.trace_rays_diff (the traversal frozen under
        no_grad, gradients through the analytic recompute and the
        scatter-backed material resolve). `tracer_data` is the tables'
        (cbox, cmeta, tri, attr[, cmat]) tuple (SceneTables.packed_dev): a
        trailing C-matrix table with dual=True takes the MXU instances,
        as JAX's step does; `slot_map` is the flattened BVH's slot layout,
        so hit indices address the scene planes;
      - "jax": the packet traversal in torch ops (ops/trace_bvh.make_tracer,
        one packet a tile), under the same wrapper and frozen the same way;
        `tracer_data` is the DeviceBVH (Pipeline.dbvh), with its leaf_size
        and `slot_map`, and stack_depth its packets' stack slots
        (Pipeline.stack_depth; JAX's default, 96, when None).
    Any other variant raises ValueError.

    The mesh: None (then `device`, else the card), a device, a sequence of
    devices, or a Mesh (make_mesh). The frame's tiles are padded to a
    multiple of its size and cut into one contiguous block per device, as
    JAX shards them (no permutation); each device renders its block with
    its own copy of the vertices, the constants and the tables (copied once,
    Mesh.replica), pad tiles add nothing to the loss or its gradient, and
    the partial losses and the gradient are summed over the devices, and
    all-reduced over the processes of a mesh made under a process group.
    `tracer_data` lies on the mesh's first device of this process, where
    the inputs and the updated vertices live too.

    As in JAX, the tables keep the values they were packed with while the
    step moves the vertices: the traversal's topology, the kernels' leaf
    rows and their resolved materials are those of the prepare-time scene,
    and only the recompute sees the moved vertices. Rebuild the tables (a
    new prepare) to follow the vertices; nothing here refits them. The
    scene's spheres are not part of the trained scene, as in JAX.

    The camera is JAX's fixed one (models/camera.default_camera), the rays
    are tiles of tile_rows x tile_cols in tile-major order, npop0 and npop
    give the first bounce and the rest their own tracer (per-bounce lists;
    the pop widths do not change the hits here), fast_light=False finds the
    shadows by the closest-hit traversal (ops/shade.occluded_from_closest)
    with forward shadow rays, and the any-hit shadows are traced from the
    light when reverse_shadows (and fast_light). stack_depth is the stack
    entries a ray needs (ops/pack.stack_need), computed from cmeta once
    when None; JAX's stack_depth counts SMEM words and is not the same
    number. The step is a plain function: autograd.grad, then the update
    under no_grad. On a CUDA device the kernels launch or raise, and on
    the CPU (or with interpret=True) their plain versions run."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    mesh = _train_mesh(mesh, device)
    home = mesh.home
    if variant == "pallas":
        if tracer_data is None:
            raise ValueError('variant="pallas" needs tracer_data')
        tracer_data = tuple(tracer_data)
        off = [str(t.device) for t in tracer_data if t.device != home]
        if off:
            raise ValueError(f"tracer_data lies on {off[0]}, the step runs on {home}")
        if stack_depth is None:
            arity = cuda_trace._box_format(tracer_data[0], compressed)[0]
            stack_depth = stack_need(tracer_data[1].cpu().numpy(), arity)
    elif variant == "jax":
        if not isinstance(tracer_data, trace_bvh.DeviceBVH):
            raise ValueError('variant="jax" needs a DeviceBVH as tracer_data')
        if tracer_data.device != home:
            raise ValueError(f"tracer_data lies on {tracer_data.device}, the step runs on {home}")
        stack_depth = JAX_STACK_DEPTH if stack_depth is None else stack_depth

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=home)

    consts = tuple(f32(a) for a in (scene.mats_kd, scene.mats_ks, scene.mats_kr,
                                    scene.lights_pos, scene.lights_kl))
    cam_arrays = ray_basis(default_camera(), width, height)
    K = tile_rows * tile_cols
    _, _, nty, ntx = tile_image_shape(width, height, tile_rows, tile_cols)
    ntiles = nty * ntx
    ntiles_p = _pad_tiles(ntiles, mesh.size)

    def make_tracers(ds, dev):
        data = None if variant == "brute" else mesh.replica(tracer_data, dev)
        return _tracers(variant, data, ds, leaf_size, stack_depth, compressed, dual,
                        stream, npop, npop0, adaptive, fast_light, K, interpret)

    step = TrainStep(mesh, make_tracers, consts, scene.faces, scene.mat_idx, slot_map,
                     bounces, lr, variant, fast_light and reverse_shadows, ntiles,
                     ntiles_p // mesh.size, K)

    def prepare_inputs(target_image=None):
        """(verts, o_t, d_t, target): the scene's vertices, the (ntiles_p,
        K) ray planes (zero rays in the pad tiles) and the (ntiles_p, K, 3)
        target (zeros by default), on the mesh's first device of this
        process (sharded.py:402-419)."""
        o, d = generate_rays_tiled(cam_arrays, width, height, tile_rows, tile_cols,
                                   device=home)

        def tiles(p):
            return F.pad(p.reshape(ntiles, K), (0, 0, 0, ntiles_p - ntiles))

        o_t, d_t = Vec3(*(tiles(p) for p in o)), Vec3(*(tiles(p) for p in d))
        if target_image is None:
            target = torch.zeros((ntiles_p, K, 3), dtype=torch.float32, device=home)
        else:
            target = torch.as_tensor(target_image, dtype=torch.float32, device=home)
        return f32(scene.verts), o_t, d_t, target

    return step, prepare_inputs

"""Port of parallel_ray_tracer_tpu/parallel/sharded.py: the differentiable
training step (make_train_step :239-419), on one device.

One SGD step renders the frame's tiles through the differentiable path
(ops/diff.py), takes the masked mean-square loss against a target image and
moves the vertex buffer against its gradient. The JAX step shards the tiles
over a mesh and all-reduces the loss; here the mesh is one device (None, a
device, or a sequence of one), and a mesh of more devices raises
NotImplementedError, as do the JAX package's `make_mesh`, `render_sharded`
and `round_robin_perm`, which this module does not have yet. JAX's
`interpret` has no counterpart: with device="cpu" the kernels' wrappers run
their plain versions; on a CUDA device they launch the kernels or raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.camera import default_camera, ray_basis
from ..models.device_scene import build_device_scene
from ..ops import cuda_trace, diff, trace_brute
from ..ops.pack import stack_need
from ..ops.render import generate_rays_tiled, tile_image_shape
from ..ops.shade import occluded_from_closest, trace_rays
from ..ops.vecmath import Vec3
from ..pipeline import _pick_device

VARIANTS = ("brute", "pallas")


def _one_device(mesh, device) -> torch.device:
    """The step's device: `device`, else the one device `mesh` names, else
    CUDA. A mesh of more than one device is not ported."""
    if isinstance(mesh, Sequence) and not isinstance(mesh, str):
        if len(mesh) > 1:
            raise NotImplementedError(
                f"a mesh of {len(mesh)} devices: make_train_step runs on one device")
        mesh = mesh[0] if len(mesh) else None
    if device is None:
        device = mesh
    elif mesh is not None and torch.device(mesh) != torch.device(device):
        raise ValueError(f"mesh {mesh} and device {device} name different devices")
    return _pick_device(device)


class TrainStep:
    """step(verts, o_t, d_t, target) -> (verts - lr * grad, loss): one SGD
    step of make_train_step. `forward` renders the tiles and `loss` takes
    the masked mean-square loss, each in the autograd graph of `verts`."""

    def __init__(self, make_tracers, consts, faces, mat_idx, slot_map, bounces: int,
                 lr: float, variant: str, reverse_shadows: bool, n_real: int, device):
        self._make_tracers = make_tracers
        self._consts = consts
        self._faces, self._mat_idx, self._slot_map = faces, mat_idx, slot_map
        self.bounces, self.lr, self.variant = bounces, lr, variant
        self._reverse_shadows = reverse_shadows
        self._n_real = n_real
        self.device = device

    def forward(self, verts: torch.Tensor, o_t: Vec3, d_t: Vec3) -> torch.Tensor:
        """(ntiles, K) rays -> (ntiles, K, 3) colours in [0, 1] (sharded.py:342-366)."""
        kd, ks, kr, lp, kl = self._consts
        ds = build_device_scene(verts, self._faces, self._mat_idx, kd, ks, kr, lp, kl,
                                slot_map=self._slot_map, device=self.device)
        nt, K = o_t.x.shape
        of, df = o_t.reshape(-1), d_t.reshape(-1)
        closest_fn, occluded_fn = self._make_tracers(ds)
        if self.variant == "brute":
            # the brute-force oracle never reverses shadows (sharded.py:357-359)
            col = trace_rays(ds, closest_fn, occluded_fn, of, df, self.bounces)
        else:
            col = diff.trace_rays_diff(ds, closest_fn, occluded_fn, of, df, self.bounces,
                                       reverse_shadows=self._reverse_shadows)
        return col.clamp(0.0, 1.0).stack(-1).reshape(nt, K, 3)

    def loss(self, verts, o_t: Vec3, d_t: Vec3, target: torch.Tensor) -> torch.Tensor:
        """Mean square over the real tiles' colours (sharded.py:368-376)."""
        return ((self.forward(verts, o_t, d_t) - target) ** 2).sum() / self._n_real

    def __call__(self, verts, o_t: Vec3, d_t: Vec3, target: torch.Tensor):
        v = verts.detach().requires_grad_(True)
        loss = self.loss(v, o_t, d_t, target)
        (grad,) = torch.autograd.grad(loss, v)
        with torch.no_grad():
            return v.detach() - self.lr * grad, loss.detach()


def make_train_step(scene, mesh, width: int, height: int, bounces: int = 1,
                    lr: float = 1e-2, tile_rows: int = 32, tile_cols: int = 32,
                    variant: str = "brute", tracer_data=None, leaf_size: int = 8,
                    stack_depth: Optional[int] = None, slot_map=None,
                    compressed: bool = False, dual: bool = True, stream: bool = False,
                    npop: int = 2, npop0: int = 0, fast_light: bool = True,
                    reverse_shadows: bool = True, adaptive: bool = False, device=None):
    """(step, prepare_inputs) of an SGD step on the vertex positions against
    a target image (sharded.py:239-419), on one device.

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
        so hit indices address the scene planes.
    "jax" (the packet traversal of ops/trace_bvh.py) is not ported and
    raises NotImplementedError; any other variant raises ValueError.

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
    under no_grad.

    The device is `device`, else the one device `mesh` names, else CUDA;
    a mesh of more than one device raises NotImplementedError. The tables
    must lie on that device: on a CUDA device the kernels launch or raise,
    and on the CPU their plain versions run."""
    if variant == "jax":
        raise NotImplementedError(
            'variant="jax" needs ops/trace_bvh.py, which the port does not have yet')
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    device = _one_device(mesh, device)
    if variant == "pallas":
        if tracer_data is None:
            raise ValueError('variant="pallas" needs tracer_data')
        tracer_data = tuple(tracer_data)
        off = [str(t.device) for t in tracer_data if t.device != device]
        if off:
            raise ValueError(f"tracer_data lies on {off[0]}, the step runs on {device}")
        if stack_depth is None:
            arity = cuda_trace._box_format(tracer_data[0], compressed)[0]
            stack_depth = stack_need(tracer_data[1].cpu().numpy(), arity)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    consts = tuple(f32(a) for a in (scene.mats_kd, scene.mats_ks, scene.mats_kr,
                                    scene.lights_pos, scene.lights_kl))
    cam_arrays = ray_basis(default_camera(), width, height)
    K = tile_rows * tile_cols
    _, _, nty, ntx = tile_image_shape(width, height, tile_rows, tile_cols)
    ntiles = nty * ntx

    def make_tracers(ds):
        """(closest, occluded) at the kernel schedule of the pass-based render
        (sharded.py:308-340)."""
        if variant == "pallas":
            kw = dict(ds=ds, stack_depth=stack_depth, compressed=compressed, dual=dual,
                      stream=stream, adaptive=adaptive)
            closest_fn, occluded_fn = cuda_trace.make_tracer(tracer_data, leaf_size,
                                                             npop=npop, **kw)
            if npop0 and npop0 != npop:
                c0, o0 = cuda_trace.make_tracer(tracer_data, leaf_size, npop=npop0, **kw)
                closest_fn, occluded_fn = [c0, closest_fn], [o0, occluded_fn]
        else:
            closest_fn, occluded_fn = trace_brute.make_tracer(ds)
        if not fast_light:
            occluded_fn = ([occluded_from_closest(c) for c in closest_fn]
                           if isinstance(closest_fn, list) else occluded_from_closest(closest_fn))
        return closest_fn, occluded_fn

    step = TrainStep(make_tracers, consts, scene.faces, scene.mat_idx, slot_map, bounces, lr,
                     variant, fast_light and reverse_shadows, ntiles * K * 3, device)

    def prepare_inputs(target_image=None):
        """(verts, o_t, d_t, target): the scene's vertices, the (ntiles, K)
        ray planes and the (ntiles, K, 3) target (zeros by default), on the
        step's device."""
        o, d = generate_rays_tiled(cam_arrays, width, height, tile_rows, tile_cols,
                                   device=device)
        o_t, d_t = o.reshape(ntiles, K), d.reshape(ntiles, K)
        if target_image is None:
            target = torch.zeros((ntiles, K, 3), dtype=torch.float32, device=device)
        else:
            target = torch.as_tensor(target_image, dtype=torch.float32, device=device)
        return f32(scene.verts), o_t, d_t, target

    return step, prepare_inputs

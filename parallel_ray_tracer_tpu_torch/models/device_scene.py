"""Port of parallel_ray_tracer_tpu/models/device_scene.py: the scene as SoA
tensor planes on one device.

The triangle planes (v0 v1 v2 n0 mat_idx) and the material table (kd ks kr)
serve the gather path: the brute-force tracer and the shading of plain
`Hit`s, which the pass-based renderer takes when the scene has spheres
(ops/spheres.wrap_tracer). The sphere planes (sph_c sph_r sph_mat) serve
the sphere tests, and `lamb` is the packed light table (ops/pack.pack_lights)
that the fused frame kernel reads; lights_pos, lights_kl and ambient are
its planes. Inputs given as tensors stay in their autograd graph: the
planes built from vertices, materials, lights and spheres passed as tensors
carry gradients back to them (ops/diff.py), as the JAX scene does; numpy
inputs give the same planes as ever.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.pack import pack_lights
from ..ops.vecmath import Vec3, from_array, take
from .scene import Scene


class DeviceScene(NamedTuple):
    # Triangle planes (T,): in BVH slot order with slot_map, degenerate
    # all-zero triangles in the padding slots.
    v0: Vec3
    v1: Vec3
    v2: Vec3
    n0: Vec3                # unit normal for norm_dir=0; the other is -n0
    mat_idx: torch.Tensor   # (T,) i32 into the material table
    # Material table (M,).
    kd: Vec3
    ks: Vec3
    kr: Vec3
    # Point lights (L,), ambient scalars.
    lights_pos: Vec3
    lights_kl: Vec3
    ambient: Vec3
    # Spheres (S,).
    sph_c: Vec3
    sph_r: torch.Tensor
    sph_mat: torch.Tensor
    lamb: torch.Tensor      # (L+1, 8) f32 light + ambient table

    @property
    def num_triangles(self) -> int:
        return int(self.v0.x.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.lamb.shape[0]) - 1

    @property
    def num_spheres(self) -> int:
        return int(self.sph_r.shape[0])

    @property
    def device(self) -> torch.device:
        return self.lamb.device


def _f32(a, device) -> torch.Tensor:
    """f32 on `device`: a tensor by torch ops (its graph kept), anything
    else through numpy."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _planes(a, device) -> Vec3:
    return from_array(_f32(a, device).reshape(-1, 3))


def build_device_scene(verts, faces, mat_idx, mats_kd, mats_ks, mats_kr,
                       lights_pos, lights_kl, ambient=(0.5, 0.5, 0.5),
                       perm: Optional[np.ndarray] = None,
                       pad_to: Optional[int] = None,
                       slot_map: Optional[np.ndarray] = None,
                       spheres_center=None, spheres_radius=None,
                       spheres_mat=None, device="cuda") -> DeviceScene:
    """Assemble the device planes from a vertex buffer and its topology
    (device_scene.py:59-165).

    `perm` reorders triangles, `pad_to` appends degenerate all-zero
    triangles; `slot_map` (exclusive with both) is the flattened BVH's slot
    layout (ops/bvh_flat.py): slot s holds triangle slot_map[s], and -1
    slots become degenerate triangles, so a traversal's hit index
    addresses these planes. n0 is e1 x e2 normalised, and zero where
    |e1 x e2| is 0 (degenerate and padding slots).

    verts, mats_kd/ks/kr, lights_pos/kl, ambient, spheres_center and
    spheres_radius may be tensors (on any device; they are moved to
    `device`): the planes then stay in their autograd graph, and
    gradients of anything computed from the planes reach them."""
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    mat_idx = np.asarray(mat_idx, np.int32)
    if slot_map is not None:
        if perm is not None or pad_to is not None:
            raise ValueError("slot_map excludes perm and pad_to")
        slot_map = np.asarray(slot_map, np.int32)
        safe = np.maximum(slot_map, 0)
        faces = np.where(slot_map[:, None] >= 0, faces[safe], 0)
        mat_idx = np.where(slot_map >= 0, mat_idx[safe], 0)
    elif perm is not None:
        faces = faces[perm]
        mat_idx = mat_idx[perm]
    if pad_to is not None and pad_to > faces.shape[0]:
        pad = pad_to - faces.shape[0]
        faces = np.concatenate([faces, np.zeros((pad, 3), np.int32)], axis=0)
        mat_idx = np.concatenate([mat_idx, np.zeros(pad, np.int32)], axis=0)

    vt = _f32(verts, device).reshape(-1, 3)
    tv = take(vt, torch.as_tensor(faces, dtype=torch.long, device=device))  # (T, 3, 3)
    v0, v1, v2 = from_array(tv[:, 0]), from_array(tv[:, 1]), from_array(tv[:, 2])
    n = (v1 - v0).cross(v2 - v0)
    mag2 = n.mag2()
    # The square root in f64, rounded once to f32: correctly rounded on
    # every device (torch's vectorised f32 sqrt on the CPU is not always).
    mag = torch.sqrt(mag2.clamp(min=1e-30).double()).float()
    zero = Vec3(n.x * 0, n.y * 0, n.z * 0)
    n0 = (n / mag).where(mag2 > 0, zero)

    if spheres_center is None:
        spheres_center = np.zeros((0, 3), np.float32)
    if spheres_radius is None:
        spheres_radius = np.zeros((0,), np.float32)
    if spheres_mat is None:
        spheres_mat = np.zeros((0,), np.int32)
    lamb = _f32(pack_lights(lights_pos, lights_kl, ambient), device)
    return DeviceScene(
        v0=v0, v1=v1, v2=v2, n0=n0,
        mat_idx=torch.as_tensor(mat_idx, dtype=torch.int32, device=device),
        kd=_planes(mats_kd, device), ks=_planes(mats_ks, device),
        kr=_planes(mats_kr, device),
        sph_c=_planes(spheres_center, device),
        sph_r=_f32(spheres_radius, device).reshape(-1),
        sph_mat=torch.as_tensor(np.asarray(spheres_mat, np.int32).reshape(-1),
                                device=device),
        **light_planes(lamb),
    )


def light_planes(lamb: torch.Tensor) -> dict:
    """The light fields of a DeviceScene: `lamb` and its planes (views)."""
    nl = int(lamb.shape[0]) - 1
    return dict(
        lights_pos=Vec3(lamb[:nl, 0], lamb[:nl, 1], lamb[:nl, 2]),
        lights_kl=Vec3(lamb[:nl, 3], lamb[:nl, 4], lamb[:nl, 5]),
        ambient=Vec3(lamb[nl, 0], lamb[nl, 1], lamb[nl, 2]),
        lamb=lamb,
    )


def device_scene_from_host(scene: Scene, ambient=(0.5, 0.5, 0.5), perm=None,
                           pad_to=None, slot_map=None, device="cuda") -> DeviceScene:
    return build_device_scene(
        scene.verts, scene.faces, scene.mat_idx, scene.mats_kd, scene.mats_ks,
        scene.mats_kr, scene.lights_pos, scene.lights_kl, ambient=ambient,
        perm=perm, pad_to=pad_to, slot_map=slot_map,
        spheres_center=scene.spheres_center, spheres_radius=scene.spheres_radius,
        spheres_mat=scene.spheres_mat, device=device,
    )


def device_scene_from_lights(lamb: torch.Tensor) -> DeviceScene:
    """A scene of lights only (no triangles, materials or spheres) from a
    packed (nl+1, 8) light table: what the shading of attribute-bearing
    hits (HitFull) reads, as in the fused frame's plain version."""
    empty = torch.zeros((0, 3), dtype=torch.float32, device=lamb.device)
    none = from_array(empty)
    return DeviceScene(
        v0=none, v1=none, v2=none, n0=none,
        mat_idx=torch.zeros((0,), dtype=torch.int32, device=lamb.device),
        kd=none, ks=none, kr=none, sph_c=none,
        sph_r=torch.zeros((0,), dtype=torch.float32, device=lamb.device),
        sph_mat=torch.zeros((0,), dtype=torch.int32, device=lamb.device),
        **light_planes(lamb),
    )

"""Copy of parallel_ray_tracer_tpu/models/procgen.py: the procedural
substitute scenes for the reference assets whose OBJs are not in the repo,
built deterministically from a seed on the port's models/scene.py.

  - dragon: a high-poly displaced torus knot (default ~180k triangles) over a
    reflective floor; 2 lights, 6 materials.
  - two_cars: two transformed instances of the car_only geometry (~64k
    triangles); 2 lights. Needs a car_only OBJ folder.
  - sportscar: the car_only body on a glossy showroom floor; 4 lights.
    Needs a car_only OBJ folder.

Same seed, same arrays as the JAX package's module. These are stand-ins for
benchmarking and tests, not replicas of the original artwork.

Two scenes of the port's own, for the checks of its kernels:
  - chain_scene: small triangles at geometrically growing distances, whose
    BVH (largest-axis midpoint splits, bvh_max_depth 64) is deep enough
    that its traversal stack passes the standard tier at every arity;
  - with_spheres: a scene plus spheres placed from its bounding box with
    a seed, on materials of their own (mirror, diffuse, green).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from .scene import Scene, load_scene


def _surface_mesh(fn, nu: int, nv: int, close_u=True, close_v=True):
    """Tessellate a parametric surface fn(u, v in [0,1)) -> (N,3) verts +
    (M,3) faces (two triangles per quad)."""
    u = np.arange(nu, dtype=np.float64) / (nu if close_u else nu - 1)
    v = np.arange(nv, dtype=np.float64) / (nv if close_v else nv - 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = fn(uu.reshape(-1), vv.reshape(-1)).astype(np.float32)

    iu = np.arange(nu if close_u else nu - 1)
    iv = np.arange(nv if close_v else nv - 1)
    giu, giv = np.meshgrid(iu, iv, indexing="ij")
    i00 = (giu % nu) * nv + (giv % nv)
    i10 = ((giu + 1) % nu) * nv + (giv % nv)
    i01 = (giu % nu) * nv + ((giv + 1) % nv)
    i11 = ((giu + 1) % nu) * nv + ((giv + 1) % nv)
    f1 = np.stack([i00, i10, i11], axis=-1).reshape(-1, 3)
    f2 = np.stack([i00, i11, i01], axis=-1).reshape(-1, 3)
    faces = np.concatenate([f1, f2], axis=0).astype(np.int32)
    return verts, faces


def _torus_knot_surface(p=2, q=3, R=2.2, r0=0.72, seed=1):
    """Displaced (p,q)-torus-knot tube — the 'dragon-class' organic blob."""
    rng = np.random.RandomState(seed)
    # Random low-frequency displacement spectrum (deterministic per seed).
    n_modes = 10
    amp = rng.rand(n_modes) * 0.12
    fu = rng.randint(1, 14, n_modes)
    fv = rng.randint(1, 7, n_modes)
    ph = rng.rand(n_modes) * 2 * math.pi

    def fn(u, v):
        tu = 2 * math.pi * u
        # Knot centerline.
        cx = (R + math.cos(0) + np.cos(q * tu)) * np.cos(p * tu)
        cy = (R + np.cos(q * tu)) * np.sin(p * tu)
        cz = -np.sin(q * tu)
        # Frenet-ish frame by finite differences.
        eps = 1e-3
        tu2 = tu + eps
        dx = (R + np.cos(q * tu2)) * np.cos(p * tu2) - (R + np.cos(q * tu)) * np.cos(p * tu)
        dy = (R + np.cos(q * tu2)) * np.sin(p * tu2) - (R + np.cos(q * tu)) * np.sin(p * tu)
        dz = -np.sin(q * tu2) + np.sin(q * tu)
        tl = np.sqrt(dx * dx + dy * dy + dz * dz) + 1e-12
        dx, dy, dz = dx / tl, dy / tl, dz / tl
        # Normal: project 'up' off the tangent.
        nx = -dy
        ny = dx
        nz = np.zeros_like(dx)
        nl = np.sqrt(nx * nx + ny * ny + nz * nz) + 1e-12
        nx, ny, nz = nx / nl, ny / nl, nz / nl
        bx = dy * nz - dz * ny
        by = dz * nx - dx * nz
        bz = dx * ny - dy * nx

        tv = 2 * math.pi * v
        disp = np.zeros_like(u)
        for k in range(n_modes):
            disp = disp + amp[k] * np.sin(fu[k] * tu + ph[k]) * np.cos(fv[k] * tv)
        rr = r0 * (1.0 + disp)
        px = cx + rr * (np.cos(tv) * nx + np.sin(tv) * bx)
        py = cy + rr * (np.cos(tv) * ny + np.sin(tv) * by)
        pz = cz + rr * (np.cos(tv) * nz + np.sin(tv) * bz)
        return np.stack([px, py, pz], axis=-1)

    return fn


def dragon_scene(
    target_triangles: int = 180_000, seed: int = 1
) -> Scene:
    """High-poly BVH-stress scene: displaced torus knot + reflective floor."""
    # 2 tris per quad on an (nu, nv) closed grid -> 2 * nu * nv triangles.
    nv = max(24, int(math.sqrt(target_triangles / 2 / 4)))
    nu = max(48, (target_triangles // 2) // nv)
    body_v, body_f = _surface_mesh(
        _torus_knot_surface(seed=seed), nu, nv, close_u=True, close_v=True
    )
    # Scale/position in front of the default camera (at (0,-9,3) looking +y).
    body_v = body_v * 0.85
    body_v = body_v[:, [0, 1, 2]]
    body_v[:, 2] += 2.2

    floor_v = np.array(
        [[-12, -12, 0], [12, -12, 0], [12, 12, 0], [-12, 12, 0]], np.float32
    )
    floor_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)

    verts = np.concatenate([body_v, floor_v], axis=0)
    faces = np.concatenate([body_f, floor_f + body_v.shape[0]], axis=0)

    # 6 materials (reference dragon mtl count): body shades by height band.
    z = body_v[:, 2][body_f[:, 0]]
    band = np.clip(((z - 0.2) / 4.0 * 5).astype(np.int32), 0, 4)
    mat_idx = np.concatenate([band, np.full(2, 5, np.int32)])

    kd = np.array(
        [
            [0.10, 0.35, 0.12],
            [0.12, 0.42, 0.16],
            [0.16, 0.50, 0.20],
            [0.22, 0.58, 0.26],
            [0.30, 0.66, 0.32],
            [0.35, 0.35, 0.38],   # floor
        ],
        np.float32,
    )
    ks = np.array(
        [[0.25, 0.25, 0.2], [0.25, 0.25, 0.2], [0.3, 0.3, 0.25],
         [0.3, 0.3, 0.25], [0.35, 0.35, 0.3], [0.2, 0.2, 0.2]],
        np.float32,
    )
    kr = np.array(
        [[0, 0, 0], [0, 0, 0], [0.05, 0.05, 0.05], [0.05, 0.05, 0.05],
         [0.1, 0.1, 0.1], [0.35, 0.35, 0.35]],
        np.float32,
    )
    lights_pos = np.array([[6.0, -8.0, 9.0], [-7.0, -3.0, 7.0]], np.float32)
    lights_kl = np.array([[70.0, 68.0, 62.0], [30.0, 32.0, 40.0]], np.float32)
    return Scene(
        verts=verts, faces=faces, mat_idx=mat_idx,
        mats_kd=kd, mats_ks=ks, mats_kr=kr,
        lights_pos=lights_pos, lights_kl=lights_kl,
    )


def _transform(verts: np.ndarray, rot_z: float, scale: float, offset) -> np.ndarray:
    c, s = math.cos(rot_z), math.sin(rot_z)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (verts * scale) @ rot.T + np.asarray(offset, np.float32)


def two_cars_scene(car_asset_dir: str, seed: int = 1) -> Scene:
    """Two transformed instances of the car_only geometry; 2 lights."""
    base = load_scene(car_asset_dir)
    v1 = _transform(base.verts, rot_z=0.35, scale=1.0, offset=(-3.4, 2.2, 0.0))
    v2 = _transform(base.verts, rot_z=-0.5, scale=1.0, offset=(3.2, -1.2, 0.0))
    verts = np.concatenate([v1, v2], axis=0)
    faces = np.concatenate(
        [base.faces, base.faces + base.verts.shape[0]], axis=0
    )
    mat_idx = np.concatenate([base.mat_idx, base.mat_idx])
    lights_pos = np.array([[5.0, -7.0, 8.0], [-6.0, -2.0, 7.0]], np.float32)
    lights_kl = np.array([[55.0, 55.0, 50.0], [25.0, 27.0, 35.0]], np.float32)
    return Scene(
        verts=verts, faces=faces, mat_idx=mat_idx,
        mats_kd=base.mats_kd, mats_ks=base.mats_ks, mats_kr=base.mats_kr,
        lights_pos=lights_pos, lights_kl=lights_kl,
    )


def sportscar_scene(car_asset_dir: str, seed: int = 1) -> Scene:
    """car_only body on a glossy showroom floor; 4 lights."""
    base = load_scene(car_asset_dir)
    floor_v = np.array(
        [[-14, -14, -0.01], [14, -14, -0.01], [14, 14, -0.01], [-14, 14, -0.01]],
        np.float32,
    )
    floor_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    verts = np.concatenate([base.verts, floor_v], axis=0)
    faces = np.concatenate([base.faces, floor_f + base.verts.shape[0]], axis=0)
    floor_mat = base.mats_kd.shape[0]
    mat_idx = np.concatenate(
        [base.mat_idx, np.full(2, floor_mat, np.int32)]
    )
    kd = np.concatenate([base.mats_kd, [[0.25, 0.25, 0.28]]], axis=0).astype(np.float32)
    ks = np.concatenate([base.mats_ks, [[0.3, 0.3, 0.3]]], axis=0).astype(np.float32)
    kr = np.concatenate([base.mats_kr, [[0.45, 0.45, 0.45]]], axis=0).astype(np.float32)
    lights_pos = np.array(
        [[6, -8, 9], [-6, -8, 9], [6, 6, 9], [-6, 6, 9]], np.float32
    )
    lights_kl = np.array(
        [[40, 40, 38], [38, 38, 40], [30, 30, 28], [28, 28, 30]], np.float32
    )
    return Scene(
        verts=verts, faces=faces, mat_idx=mat_idx,
        mats_kd=kd, mats_ks=ks, mats_kr=kr,
        lights_pos=lights_pos, lights_kl=lights_kl,
    )


def chain_scene(n: int = 56, ratio: float = 2.5) -> Scene:
    """n triangles in the planes y = ratio**k, k = 0..n-1, each centred on
    the y axis with half-size 0.3 * ratio**(k/3), and one light.

    With ratio > 2 a midpoint split on the largest axis (heuristic 1)
    splits off only the farthest triangle, so the tree is a chain about
    n - 8 levels deep (48 at n = 56; pass bvh_max_depth = 64). The half
    size grows slower than the distance so that e1 x e2 and its square stay
    finite in f32."""
    k = np.arange(n, dtype=np.float64)
    y = ratio ** k
    s = 0.3 * ratio ** (k / 3.0)
    verts = np.stack([
        np.stack([-s, y, -s], 1), np.stack([s, y, -s], 1), np.stack([0 * s, y, s], 1),
    ], 1).reshape(-1, 3).astype(np.float32)
    return Scene(
        verts=verts,
        faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3),
        mat_idx=(np.arange(n) % 2).astype(np.int32),
        mats_kd=np.asarray([[0.8, 0.3, 0.2], [0.2, 0.4, 0.8]], np.float32),
        mats_ks=np.asarray([[0.3, 0.3, 0.3], [0.1, 0.1, 0.1]], np.float32),
        mats_kr=np.zeros((2, 3), np.float32),
        lights_pos=np.asarray([[3.0, -6.0, 5.0]], np.float32),
        lights_kl=np.asarray([[30.0, 30.0, 30.0]], np.float32),
    )


def with_spheres(scene: Scene, n: int = 8, seed: int = 7) -> Scene:
    """`scene` plus n spheres drawn with `seed` inside a sub-box of its
    bounding box (fractions 0.15-0.85 of x, 0.40-0.85 of y, 0.42-0.60 of z:
    in front of the default camera for the car scenes), radii 0.6-1.2.
    Three materials are appended: a mirror (kr 0.8), a red diffuse and a
    green diffuse one; spheres 0-2 and 7 are mirrors, 3-4 red, 5-6 green.
    The triangles keep their materials."""
    tv = scene.triangle_vertices().reshape(-1, 3)
    lo, hi = tv.min(0), tv.max(0)
    rng = np.random.RandomState(seed)
    u = rng.uniform((0.15, 0.40, 0.42), (0.85, 0.85, 0.60), (n, 3))
    radii = rng.uniform(0.6, 1.2, n).astype(np.float32)
    m = scene.mats_kd.shape[0]

    def add(table, rows):
        return np.concatenate([table, np.asarray(rows, np.float32)]).astype(np.float32)

    mats = np.asarray([m, m, m, m + 1, m + 1, m + 2, m + 2, m] * (n // 8 + 1),
                      np.int32)[:n]
    return dataclasses.replace(
        scene,
        mats_kd=add(scene.mats_kd, [[0.05, 0.05, 0.05], [0.7, 0.2, 0.2], [0.2, 0.7, 0.3]]),
        mats_ks=add(scene.mats_ks, [[0.3, 0.3, 0.3], [0.3, 0.3, 0.3], [0.0, 0.0, 0.0]]),
        mats_kr=add(scene.mats_kr, [[0.8, 0.8, 0.8], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]),
        spheres_center=(lo + u * (hi - lo)).astype(np.float32),
        spheres_radius=radii, spheres_mat=mats,
    )


def substitute_scene(name: str, asset_roots, seed: int = 1) -> Optional[Scene]:
    """Build a substitute Scene for a stripped asset, or None if unknown."""
    import os

    def find_car():
        for root in asset_roots:
            p = os.path.join(root, "car_only")
            if os.path.isfile(os.path.join(p, "triangles.obj")):
                return p
        raise FileNotFoundError("car_only assets required for substitutes")

    if name == "dragon":
        return dragon_scene(seed=seed)
    if name == "two_cars":
        return two_cars_scene(find_car(), seed=seed)
    if name == "sportscar":
        return sportscar_scene(find_car(), seed=seed)
    return None

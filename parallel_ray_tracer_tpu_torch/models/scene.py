"""Copy of parallel_ray_tracer_tpu/models/scene.py (numpy only).

Scene layer: OBJ/MTL/light parsing into SoA NumPy arrays.

Replaces the reference's AoS `triangle_t` loader (cpu/src/triangle.c:74-123)
with the GPU-style split layout taken to its conclusion: a material table plus
per-triangle material indices (gpu/src/triangle.cu:91-116) and pure SoA float
planes, which is what the TPU VPU wants.

Parsing matches the reference's exact OBJ/MTL subset:
  - OBJ: `v x y z` vertices, `f i j k` triangle faces (1-based), `usemtl name`
    (cpu/src/triangle.c:82-115). Faces referencing an unknown material keep the
    previously active one; before any `usemtl`, materials are all zeros.
  - MTL: `newmtl`, with Kd/Ks/Kr searched within the 5 lines following the
    `newmtl` line, at most 128 materials (cpu/src/triangle.c:54-72).
  - lights.obj: whitespace `x y z r g b` per line (cpu/src/light.c:17-24).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Scene:
    """SoA scene arrays (all float32 / int32, NumPy host-side).

    verts:    (V, 3) unique vertex positions (differentiable parameters).
    faces:    (T, 3) int32 vertex indices per triangle.
    mat_idx:  (T,)   int32 material index per triangle.
    mats_kd/ks/kr: (M, 3) material table.
    lights_pos/kl: (L, 3) point lights.
    """

    verts: np.ndarray
    faces: np.ndarray
    mat_idx: np.ndarray
    mats_kd: np.ndarray
    mats_ks: np.ndarray
    mats_kr: np.ndarray
    lights_pos: np.ndarray
    lights_kl: np.ndarray
    # Sphere primitives (first-class here; vestigial in the reference —
    # assets/car_only/spheres.obj is empty, cpu/src/raytracer.c:61 mentions
    # them in a comment only). Format: see load_spheres.
    spheres_center: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.float32)
    )
    spheres_radius: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.float32)
    )
    spheres_mat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32)
    )

    @property
    def num_triangles(self) -> int:
        return int(self.faces.shape[0])

    @property
    def num_spheres(self) -> int:
        return int(self.spheres_radius.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.lights_pos.shape[0])

    @property
    def num_materials(self) -> int:
        return int(self.mats_kd.shape[0])

    def triangle_vertices(self) -> np.ndarray:
        """(T, 3, 3): per-triangle vertex coordinates (gathered from verts)."""
        return self.verts[self.faces]

    def centroids(self) -> np.ndarray:
        """(T, 3): (a+b+c)/3 per triangle (cpu/src/triangle.c:21-23)."""
        tv = self.triangle_vertices()
        return tv.mean(axis=1).astype(np.float32)

    def normals(self) -> np.ndarray:
        """(T, 2, 3): both-direction unit normals (cpu/src/triangle.c:14-19).

        norm[0] = normalize(cross(e1, e2)); norm[1] = -norm[0].
        """
        tv = self.triangle_vertices()
        e1 = tv[:, 1] - tv[:, 0]
        e2 = tv[:, 2] - tv[:, 0]
        n = np.cross(e1, e2)
        mag = np.linalg.norm(n, axis=1, keepdims=True)
        # Degenerate triangles get a zero normal instead of NaN.
        n = np.where(mag > 0, n / np.maximum(mag, 1e-30), 0.0)
        return np.stack([n, -n], axis=1).astype(np.float32)


def parse_materials(mtl_text: str, max_materials: int = 128):
    """Parse the reference MTL subset (cpu/src/triangle.c:54-72).

    Kd/Ks/Kr are only recognized within the 5 lines after each `newmtl`.
    Returns (name -> index, kd, ks, kr arrays).
    """
    lines = mtl_text.splitlines()
    names: List[str] = []
    kd: List[Tuple[float, float, float]] = []
    ks: List[Tuple[float, float, float]] = []
    kr: List[Tuple[float, float, float]] = []
    by_name: Dict[str, int] = {}

    for i, line in enumerate(lines):
        if line.startswith("newmtl") and len(names) < max_materials:
            parts = line.split()
            name = parts[1] if len(parts) > 1 else ""
            cur_kd = cur_ks = cur_kr = (0.0, 0.0, 0.0)
            for j in range(i + 1, min(i + 6, len(lines))):
                lj = lines[j]
                if lj.startswith("Kd"):
                    cur_kd = _parse3(lj)
                elif lj.startswith("Ks"):
                    cur_ks = _parse3(lj)
                elif lj.startswith("Kr"):
                    cur_kr = _parse3(lj)
            # Reference keeps the first entry on duplicate names (the lookup at
            # cpu/src/triangle.c:103-109 breaks on first match).
            if name not in by_name:
                by_name[name] = len(names)
            names.append(name)
            kd.append(cur_kd)
            ks.append(cur_ks)
            kr.append(cur_kr)

    return (
        by_name,
        np.asarray(kd, dtype=np.float32).reshape(-1, 3),
        np.asarray(ks, dtype=np.float32).reshape(-1, 3),
        np.asarray(kr, dtype=np.float32).reshape(-1, 3),
    )


def _parse3(line: str) -> Tuple[float, float, float]:
    parts = line.split()
    vals = [float(p) for p in parts[1:4]]
    while len(vals) < 3:
        vals.append(0.0)
    return (vals[0], vals[1], vals[2])


def load_obj(obj_text: str, mtl_text: str) -> Scene:
    """Parse OBJ + MTL text into a Scene (lights empty)."""
    by_name, kd, ks, kr = parse_materials(mtl_text)

    verts: List[Tuple[float, float, float]] = []
    faces: List[Tuple[int, int, int]] = []
    mat_idx: List[int] = []

    # Material slot 0 is the implicit "no material yet" all-zeros entry, so
    # faces before any usemtl shade black like the reference's zero-initialized
    # current_{ks,kd,kr} (cpu/src/triangle.c:94).
    kd = np.concatenate([np.zeros((1, 3), np.float32), kd], axis=0)
    ks = np.concatenate([np.zeros((1, 3), np.float32), ks], axis=0)
    kr = np.concatenate([np.zeros((1, 3), np.float32), kr], axis=0)
    current = 0

    for line in obj_text.splitlines():
        if line.startswith("v "):
            verts.append(_parse3(line))
        elif line.startswith("usemtl"):
            parts = line.split()
            name = parts[1] if len(parts) > 1 else ""
            if name in by_name:
                current = by_name[name] + 1
            # Unknown name: keep current material (reference behavior).
        elif line.startswith("f"):
            parts = line.split()
            # Reference sscanf("f %d %d %d") — plain indices, 1-based, no
            # negative handling (cpu/src/triangle.c:110-113). Tolerate v/vt/vn
            # slash syntax by taking the leading integer.
            idx = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
            faces.append((idx[0], idx[1], idx[2]))
            mat_idx.append(current)

    return Scene(
        verts=np.asarray(verts, dtype=np.float32).reshape(-1, 3),
        faces=np.asarray(faces, dtype=np.int32).reshape(-1, 3),
        mat_idx=np.asarray(mat_idx, dtype=np.int32).reshape(-1),
        mats_kd=kd,
        mats_ks=ks,
        mats_kr=kr,
        lights_pos=np.zeros((0, 3), np.float32),
        lights_kl=np.zeros((0, 3), np.float32),
    )


def load_lights(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse `x y z r g b` per line (cpu/src/light.c:17-24)."""
    pos: List[Tuple[float, float, float]] = []
    kl: List[Tuple[float, float, float]] = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 6:
            continue
        vals = [float(p) for p in parts[:6]]
        pos.append((vals[0], vals[1], vals[2]))
        kl.append((vals[3], vals[4], vals[5]))
    return (
        np.asarray(pos, dtype=np.float32).reshape(-1, 3),
        np.asarray(kl, dtype=np.float32).reshape(-1, 3),
    )


def load_spheres(text: str):
    """Parse sphere rows `cx cy cz r [mat_index]` (one per line).

    The reference ships an empty assets/car_only/spheres.obj and never
    parses it; this format makes the file meaningful (mat_index refers to
    the same material table as triangles; defaults to 0).
    """
    centers: List[Tuple[float, float, float]] = []
    radii: List[float] = []
    mats: List[int] = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 4:
            continue
        try:
            vals = [float(p) for p in parts[:4]]
        except ValueError:
            continue
        centers.append((vals[0], vals[1], vals[2]))
        radii.append(vals[3])
        mats.append(int(float(parts[4])) if len(parts) > 4 else 0)
    return (
        np.asarray(centers, np.float32).reshape(-1, 3),
        np.asarray(radii, np.float32).reshape(-1),
        np.asarray(mats, np.int32).reshape(-1),
    )


def load_scene(asset_dir: str) -> Scene:
    """Load `<dir>/{triangles.obj, triangles.mtl, lights.obj[, spheres.obj]}`."""
    with open(os.path.join(asset_dir, "triangles.obj")) as f:
        obj_text = f.read()
    with open(os.path.join(asset_dir, "triangles.mtl")) as f:
        mtl_text = f.read()
    scene = load_obj(obj_text, mtl_text)
    lights_path = os.path.join(asset_dir, "lights.obj")
    if os.path.exists(lights_path):
        with open(lights_path) as f:
            scene.lights_pos, scene.lights_kl = load_lights(f.read())
    spheres_path = os.path.join(asset_dir, "spheres.obj")
    if os.path.exists(spheres_path):
        with open(spheres_path) as f:
            c, r, m = load_spheres(f.read())
        scene.spheres_center, scene.spheres_radius, scene.spheres_mat = c, r, m
    return scene


_SNAPSHOT_FIELDS = (
    "verts", "faces", "mat_idx", "mats_kd", "mats_ks", "mats_kr",
    "lights_pos", "lights_kl", "spheres_center", "spheres_radius",
    "spheres_mat",
)


def save_scene_npz(scene: Scene, path: str) -> None:
    """Persist a parsed Scene as a compressed npz snapshot.

    Snapshots make the repo self-contained: the bundled car_only/car_boxed
    geometry renders without the reference checkout present (the OBJ text
    parse and the snapshot load produce identical arrays — tested).
    """
    np.savez_compressed(
        path, **{f: getattr(scene, f) for f in _SNAPSHOT_FIELDS}
    )


def load_scene_npz(path: str) -> Scene:
    """Load a Scene from a save_scene_npz snapshot."""
    with np.load(path) as z:
        return Scene(**{f: z[f] for f in _SNAPSHOT_FIELDS})


def synthetic_scene(num_triangles: int, seed: int = 1) -> Scene:
    """Random-triangle stress scene (cpu/src/main.c:115-131).

    a = U[0,1)^3 * 10 - 5; b = a + U[0,1)^3; c = b + U[0,1)^3.
    Material: ks = 1, kd = kr = 0; no lights. Uses NumPy RNG (we intentionally
    do not replicate C rand()).
    """
    rng = np.random.RandomState(seed)
    r0 = rng.random_sample((num_triangles, 3)).astype(np.float32)
    r1 = rng.random_sample((num_triangles, 3)).astype(np.float32)
    r2 = rng.random_sample((num_triangles, 3)).astype(np.float32)
    a = r0 * 10.0 - 5.0
    b = a + r1
    c = b + r2
    verts = np.stack([a, b, c], axis=1).reshape(-1, 3)
    faces = np.arange(num_triangles * 3, dtype=np.int32).reshape(-1, 3)
    return Scene(
        verts=verts,
        faces=faces,
        mat_idx=np.zeros(num_triangles, np.int32),
        mats_kd=np.zeros((1, 3), np.float32),
        mats_ks=np.ones((1, 3), np.float32),
        mats_kr=np.zeros((1, 3), np.float32),
        lights_pos=np.zeros((0, 3), np.float32),
        lights_kl=np.zeros((0, 3), np.float32),
    )

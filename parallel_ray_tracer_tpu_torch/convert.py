"""Carry prepared scene tables across into the port's tensors.

`packed_from_numpy` takes the packed arrays as numpy (for the JAX package's
prepared state, `np.asarray(pipe.packed_dev[i])`, or the port's own packers)
and uploads them, so that both packages can trace the very same tables.
`device_scene_from_numpy` does the same for the scene planes of a
DeviceScene (the JAX package's `pipe.ds`), and `train_inputs_from_numpy`
for the training state of the JAX package's `make_train_step`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .models.device_scene import DeviceScene, light_planes
from .ops.pack import ARITY_OF_WIDTH, META_WIDTH, pack_lights, stack_need
from .ops.vecmath import Vec3

# 16-bit node tables hold bf16 bits: JAX's ml_dtypes bfloat16 array, or the
# bits as uint16 / int16 (ops/pack.cbox_to_bf16).
_BF16_DTYPES = ("bfloat16", "uint16", "int16")


class SceneTables(NamedTuple):
    """Device-resident tables the traversal kernels read (ops/pack.py)."""

    cbox: torch.Tensor      # (N, 16 | 32 | 64) f32, or (N, 16) bf16
    cmeta: torch.Tensor     # (N, 8 | 8 | 16) i32
    tri: torch.Tensor       # (G+1, 128) f32
    attr: torch.Tensor      # (G+1, 128) f32
    lamb: torch.Tensor      # (nl+1, 8) f32
    leaf_size: int
    stack_depth: int        # entries one ray's traversal stack needs
    arity: int              # node arity: 2, 4 or 8, by the cbox row width
    compressed: bool = False  # cbox rows are bf16 (min|max) pairs (arity 4, 8)
    sph: Optional[torch.Tensor] = None  # (S, 16) f32 sphere table, or None
    # The MXU leaf's C-matrix table, bf16: (rows, 32) [hi | lo]
    # (ops/pack.split_cmat) or (rows, 128) (ops/pack.pack_cmi4); None: the
    # FP32 leaf test.
    cmat: Optional[torch.Tensor] = None

    @property
    def packed_dev(self) -> tuple:
        """(cbox, cmeta, tri, attr[, cmat]): the tables as make_tracer takes
        them (JAX's pipe.packed_dev)."""
        return (self.cbox, self.cmeta, self.tri, self.attr) + (
            () if self.cmat is None else (self.cmat,))


def _upload_cbox(cbox, device, compressed: bool):
    """cbox as a tensor: f32, or a 16-bit table kept as bf16 by a bit view.
    Returns (tensor, arity)."""
    cbox = np.asarray(cbox)
    width = cbox.shape[1] if cbox.ndim == 2 else None
    arity = ARITY_OF_WIDTH.get(width)
    if cbox.dtype.itemsize == 2:
        if cbox.dtype.name not in _BF16_DTYPES:
            raise ValueError(f"cbox of dtype {cbox.dtype} is no bf16 table")
        if arity != 2:
            raise ValueError(f"a 16-bit cbox is the binary table (N, 16), got {cbox.shape}")
        bits = np.ascontiguousarray(cbox).view(np.int16)
        t = torch.tensor(bits, device=device).view(torch.bfloat16)
    else:
        t = torch.tensor(np.ascontiguousarray(cbox, np.float32), device=device)
    if compressed and arity not in (4, 8):
        raise ValueError("bf16 pair rows (compressed=True) need a node arity of 4 or 8")
    return t, arity


def packed_from_numpy(cbox, cmeta, tri, attr, lamb, *, device, leaf_size: int = 8,
                      compressed: bool = False, sph=None, cmat=None) -> SceneTables:
    """Upload packed numpy tables to `device` as contiguous tensors. The
    node arity follows the cbox row width: 16 -> 2, 32 -> 4, 64 -> 8.

    compressed=True marks the rows of a width-4 or width-8 table as bf16
    (min|max) pairs (ops/pack.pack_box_bf16_pairs). A 16-bit cbox is a
    binary bf16 table and stays 16-bit (torch.bfloat16); it is never
    widened to f32. The bad combinations raise ValueError, as JAX asserts
    them (pallas_trace.py:3069, 3173, 3283). `sph` is the (S, 16) sphere
    table of ops/pack.pack_spheres (None: no spheres). `cmat` is the MXU
    leaf's split C-matrix table as bf16 bits or values ((rows, 32) of
    ops/pack.split_cmat or (rows, 128) of pack_cmi4; JAX's packed_dev[4]),
    uploaded as torch.bfloat16 (None: the FP32 leaf test)."""
    cmeta = np.ascontiguousarray(cmeta, np.int32)
    tri = np.ascontiguousarray(tri, np.float32)
    attr = np.ascontiguousarray(attr, np.float32)
    lamb = np.ascontiguousarray(lamb, np.float32)
    cbox_t, arity = _upload_cbox(cbox, device, compressed)
    if arity is None or cmeta.shape != (cbox_t.shape[0], META_WIDTH[arity]):
        raise ValueError(
            "expected node tables (N, 16) / (N, 8), (N, 32) / (N, 8) or "
            f"(N, 64) / (N, 16), got {tuple(cbox_t.shape)} / {cmeta.shape}"
        )
    if tri.ndim != 2 or tri.shape[1] != 128 or attr.shape != tri.shape:
        raise ValueError(f"expected (G+1, 128) rows, got {tri.shape} / {attr.shape}")
    if lamb.ndim != 2 or lamb.shape[1] != 8:
        raise ValueError(f"expected an (nl+1, 8) light table, got {lamb.shape}")
    if sph is not None:
        sph = np.ascontiguousarray(sph, np.float32)
        if sph.ndim != 2 or sph.shape[1] != 16:
            raise ValueError(f"expected an (S, 16) sphere table, got {sph.shape}")

    def up(a):
        return torch.tensor(a, device=device)  # copies: the input may be read-only

    cmat_t = None
    if cmat is not None:
        cmat = np.asarray(cmat)
        if (cmat.dtype.name not in _BF16_DTYPES or cmat.ndim != 2
                or cmat.shape[1] not in (32, 128)):
            raise ValueError(f"expected a bf16 (rows, 32) or (rows, 128) C-matrix "
                             f"table, got {cmat.dtype} {cmat.shape}")
        cmat_t = up(np.ascontiguousarray(cmat).view(np.int16)).view(torch.bfloat16)

    return SceneTables(
        cbox=cbox_t, cmeta=up(cmeta), tri=up(tri), attr=up(attr),
        lamb=up(lamb), leaf_size=int(leaf_size),
        stack_depth=stack_need(cmeta, arity), arity=arity,
        compressed=bool(compressed),
        sph=None if sph is None or not len(sph) else up(sph), cmat=cmat_t,
    )


def train_inputs_from_numpy(verts, o_t, d_t, target, *, device):
    """The training state of the JAX package's make_train_step as the port's:
    its prepare_inputs() output (verts, o_t, d_t, target), given as
    numpy-convertible arrays (o_t, d_t as (x, y, z) triples of (ntiles, K)
    planes), uploaded to `device` value for value, so that both packages
    step the same vertices against the same target on the same rays."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return (f32(verts), Vec3(*(f32(p) for p in o_t)), Vec3(*(f32(p) for p in d_t)),
            f32(target))


def device_scene_from_numpy(ds, *, device) -> DeviceScene:
    """Upload the planes of a DeviceScene given as numpy-convertible arrays
    (the JAX package's DeviceScene, whose Vec3 fields are (x, y, z) triples)
    to `device`, value for value. The light table `lamb` is packed from its
    lights and ambient (ops/pack.pack_lights)."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def vec(v):
        return Vec3(*(f32(c) for c in v))

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    def rows(v):
        return np.stack([np.asarray(c, np.float32) for c in v], axis=-1)

    lamb = pack_lights(rows(ds.lights_pos), rows(ds.lights_kl),
                       [np.asarray(c, np.float32) for c in ds.ambient])
    return DeviceScene(
        v0=vec(ds.v0), v1=vec(ds.v1), v2=vec(ds.v2), n0=vec(ds.n0),
        mat_idx=i32(ds.mat_idx), kd=vec(ds.kd), ks=vec(ds.ks), kr=vec(ds.kr),
        sph_c=vec(ds.sph_c), sph_r=f32(ds.sph_r), sph_mat=i32(ds.sph_mat),
        **light_planes(lamb.to(device)),
    )

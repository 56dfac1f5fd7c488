"""Carry prepared scene tables across into the port's tensors.

`packed_from_numpy` takes the packed arrays as numpy (for the JAX package's
prepared state, `np.asarray(pipe.packed_dev[i])`, or the port's own packers)
and uploads them, so that both packages can trace the very same tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops.pack import ARITY_OF_WIDTH, META_WIDTH, stack_need


class SceneTables(NamedTuple):
    """Device-resident tables the traversal kernels read (ops/pack.py)."""

    cbox: torch.Tensor      # (N, 16 | 32 | 64) f32
    cmeta: torch.Tensor     # (N, 8 | 8 | 16) i32
    tri: torch.Tensor       # (G+1, 128) f32
    attr: torch.Tensor      # (G+1, 128) f32
    lamb: torch.Tensor      # (nl+1, 8) f32
    leaf_size: int
    stack_depth: int        # entries one ray's traversal stack needs
    arity: int              # node arity: 2, 4 or 8, by the cbox row width


def packed_from_numpy(cbox, cmeta, tri, attr, lamb, *, device, leaf_size: int = 8) -> SceneTables:
    """Upload packed numpy tables to `device` as contiguous tensors. The
    node arity follows the cbox row width: 16 -> 2, 32 -> 4, 64 -> 8."""
    cbox = np.ascontiguousarray(cbox, np.float32)
    cmeta = np.ascontiguousarray(cmeta, np.int32)
    tri = np.ascontiguousarray(tri, np.float32)
    attr = np.ascontiguousarray(attr, np.float32)
    lamb = np.ascontiguousarray(lamb, np.float32)
    arity = ARITY_OF_WIDTH.get(cbox.shape[1]) if cbox.ndim == 2 else None
    if arity is None or cmeta.shape != (cbox.shape[0], META_WIDTH[arity]):
        raise ValueError(
            "expected node tables (N, 16) / (N, 8), (N, 32) / (N, 8) or "
            f"(N, 64) / (N, 16), got {cbox.shape} / {cmeta.shape}"
        )
    if tri.ndim != 2 or tri.shape[1] != 128 or attr.shape != tri.shape:
        raise ValueError(f"expected (G+1, 128) rows, got {tri.shape} / {attr.shape}")
    if lamb.ndim != 2 or lamb.shape[1] != 8:
        raise ValueError(f"expected an (nl+1, 8) light table, got {lamb.shape}")

    def up(a):
        return torch.tensor(a, device=device)  # copies: the input may be read-only

    return SceneTables(
        cbox=up(cbox), cmeta=up(cmeta), tri=up(tri), attr=up(attr),
        lamb=up(lamb), leaf_size=int(leaf_size),
        stack_depth=stack_need(cmeta, arity), arity=arity,
    )

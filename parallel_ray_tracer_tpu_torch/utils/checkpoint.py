"""Port of parallel_ray_tracer_tpu/utils/checkpoint.py: checkpoint and resume
as npz snapshots of nested containers of arrays.

  - `save_pytree` / `load_pytree`: a tree of dicts, tuples and lists whose
    leaves are numpy arrays, tensors or numbers, in one .npz written
    atomically (a temporary file, then os.replace), so an interrupted save
    never spoils the previous checkpoint.
  - `TileRenderCheckpoint`: a frame rendered in bands of rows; each finished
    band lands in the checkpoint, and a rerun resumes at the first missing
    band.

The file is the JAX package's: leaves `leaf_0` ... `leaf_{n-1}` in JAX's
flattening order (dict keys sorted, sequences in order, None holds no
leaf) and a trailing `__treedef__` entry with the tree's structure as text.
JAX's loader counts the leaves as the file's entries less one and rebuilds
the tree from a template, as `load_pytree` does here, so a file either
package writes loads in the other. jax.tree is not available here: the
flattening is this module's own.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Callable, List, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, out: List[Any]) -> str:
    """Append tree's leaves to `out` in JAX's order; return the structure as
    JAX prints a PyTreeDef's body ('*' for a leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        parts = [f"{k!r}: {_flatten(tree[k], out)}" for k in sorted(tree)]
        return "{" + ", ".join(parts) + "}"
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x, out) for x in tree]
        if isinstance(tree, list):
            return "[" + ", ".join(parts) + "]"
        if _is_namedtuple(tree):
            return f"{type(tree).__name__}(" + ", ".join(parts) + ")"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    out.append(tree)
    return "*"


def _unflatten(like, leaves) -> Any:
    """A tree shaped like `like` whose leaves come from the iterator
    `leaves`: a tensor leaf of `like` takes the loaded array as a tensor of
    its dtype on its device, any other leaf the array itself."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (tuple, list)):
        vals = [_unflatten(x, leaves) for x in like]
        if _is_namedtuple(like):
            return type(like)(*vals)
        return type(like)(vals)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device)
    return arr


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree: Any) -> None:
    """Atomically persist a tree of arrays as npz plus its structure."""
    leaves: List[Any] = []
    treedef = f"PyTreeDef({_flatten(tree, leaves)})"
    payload = {f"leaf_{i}": _as_numpy(x) for i, x in enumerate(leaves)}
    payload["__treedef__"] = np.frombuffer(json.dumps(treedef).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str, like: Any) -> Any:
    """Restore a tree saved by save_pytree (of either package), shaped like
    `like`. A file whose leaf count is not like's raises ValueError."""
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    n = len(_leaves_of(like))
    if n != len(leaves):
        raise ValueError(f"{path} holds {len(leaves)} leaves, the template {n}")
    return _unflatten(like, iter(leaves))


def _leaves_of(tree) -> List[Any]:
    out: List[Any] = []
    _flatten(tree, out)
    return out


class TileRenderCheckpoint:
    """Resumable banded rendering of a large frame (checkpoint.py:54-99).

    render_band(y0, rows) -> (rows, W, 3); finished bands accumulate in the
    checkpoint file, and `run` resumes from the first missing band.
    """

    def __init__(self, path: str, width: int, height: int, band_rows: int):
        self.path = path
        self.width = width
        self.height = height
        self.band_rows = band_rows
        self.n_bands = -(-height // band_rows)

    def _state_like(self):
        return {
            "done": np.zeros(self.n_bands, np.bool_),
            "image": np.zeros((self.height, self.width, 3), np.float32),
        }

    def load(self):
        """The saved state, or a fresh one where there is no file or the
        file is of another frame size."""
        if os.path.exists(self.path):
            state = load_pytree(self.path, self._state_like())
            if state["image"].shape == (self.height, self.width, 3):
                return state
        return self._state_like()

    def run(
        self,
        render_band: Callable[[int, int], Any],
        progress: Optional[Callable[[int, int], None]] = None,
    ) -> np.ndarray:
        state = self.load()
        for b in range(self.n_bands):
            if state["done"][b]:
                continue
            y0 = b * self.band_rows
            rows = min(self.band_rows, self.height - y0)
            state["image"][y0 : y0 + rows] = _as_numpy(render_band(y0, rows))[:rows]
            state["done"][b] = True
            save_pytree(self.path, state)
            if progress:
                progress(b + 1, self.n_bands)
        return state["image"]

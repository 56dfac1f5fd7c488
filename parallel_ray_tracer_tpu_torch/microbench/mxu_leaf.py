"""Kernel A (row 15a): what one 8-triangle leaf visit costs on the card.

Port of the harness `pallas_run` of scripts/microbench_mxu_leaf.py (:161,
pallas_call :162) and its stage bodies (`vpu_kernel` :312, `v1_kernel`
:341, `v2_kernel` :387, `v4_kernel` :478, `v5_kernel` :590,
`v6_kernel_t1` :625, `v6_kernel_t2` :652). On the TPU one 1,024-ray
packet visits K of G = 512 resident groups in a ring and keeps each ray's
smallest t. Here every thread of a full grid traces one ray of the fixture
(thread i: ray i % n_src) through K visits of the same ring, from an offset
set by its lane: `distinct` D groups per warp (D = 1, the packet's case:
every lane wants the same group; D = 32: each lane its own), so the
tensor-core modes serve D batches a visit. `leaf_visits` launches
csrc/microbench_leaf.cu's mb_leaf_kernel and returns t and, with `full`, the
winner's slot g * 8 + j (-1 on a miss); `leaf_plain` is its plain version.

Modes: "mt" the FP32 leaf (rt_mt on tri rows; vpu_kernel), "f32" the
C-matrix product on the FP32 pipe (v2_kernel in f32), "bf16" one bf16
tensor-core pass (v2_kernel with dtype=bfloat16), "bf16x3" the production
leaf (v5_kernel, v6_kernel_t2). Layouts of the bf16 table (v6):
"interleaved" [hi | lo] rows (ops/pack.split_cmat, production), "two_tables"
hi and lo tables, "four_group" (ops/pack.pack_cmi4). `c_in_a` puts the C
rows in the mma's A operand and the rays in B (v1's question), against the
production placement (rays in A).

The plain versions use ops/intersect.mt_rows (the FP32 leaf's arithmetic,
so "mt" and "f32" are held to the bit) and ops/trace_plain's bf16 halves
(`_ray_halves`, `_mxu_quants`: products of bf16 values as f32 matmuls, TF32
off), so the tensor-core modes are held to bounds: the tensor cores sum in
their own order.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._build import load_library
from ..ops.cuda_trace import _check, _ptr, _raise_on, _stream
from ..ops.intersect import EPSILON, T_MAX, mt_rows
from ..ops.pack import pack_cmi4, split_cmat
from ..ops.trace_plain import _full_f32_matmul, _mxu_quants, _ray_halves
from ..ops.vecmath import Vec3
from . import LAUNCHES, fixtures

MODES = {"mt": 0, "f32": 1, "bf16": 2, "bf16x3": 3}
LAYOUTS = {"interleaved": 0, "two_tables": 1, "four_group": 2}
MXU_MODES = ("bf16", "bf16x3")
# (mode, full, layout, c_in_a) with an instance in csrc/microbench_leaf.cu.
INSTANCES = frozenset(
    [(m, f, "interleaved", False) for m in MODES for f in (False, True)]
    + [("bf16x3", False, "two_tables", False), ("bf16x3", False, "four_group", False),
       ("bf16x3", False, "interleaved", True)])
DISTINCT = (1, 2, 4, 8, 32)
BLOCK = 128                   # threads per block, RT_BLOCK
# Operations one ray's leaf visit needs (chip_smoke.py's counts): rt_mt's 47
# FP32 operations per triangle; the MXU epilogue's 14 per triangle and the
# tensor-core product of the ray's K = 10 live features with the group's 32
# C rows, per bf16 pass.
OPS_MT = 47
OPS_EPILOGUE = 14
MMA_OPS_PER_PASS = 2 * 32 * 10
F32_PRODUCT_OPS = 2 * 32 * 16


class LeafTables(NamedTuple):
    planes: Tuple[torch.Tensor, ...]   # ox, oy, oz, dx, dy, dz: (n_src,) f32
    tri: torch.Tensor                  # (G, 128) f32 tri rows
    cf32: torch.Tensor                 # (G * 32, 16) f32 C rows
    cmat: torch.Tensor                 # (G * 32, 32) bf16 [hi | lo]
    chi: torch.Tensor                  # (G * 32, 16) bf16 hi
    clo: torch.Tensor                  # (G * 32, 16) bf16 lo
    cmi4: torch.Tensor                 # (ceil(G / 4) * 32, 128) bf16


def _bf16(bits: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)
    return t.to(device)


def leaf_tables(planes, tri: np.ndarray, cmat: np.ndarray, device) -> LeafTables:
    """Tables on `device` from numpy: 6 ray planes (any shape, flattened),
    (G, 128) tri rows and the (G * 32, 16) f32 C table, in every layout."""
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    split = split_cmat(cmat)
    return LeafTables(
        planes=tuple(f32(p).reshape(-1) for p in planes), tri=f32(tri), cf32=f32(cmat),
        cmat=_bf16(split, device), chi=_bf16(split[:, :16], device),
        clo=_bf16(split[:, 16:], device), cmi4=_bf16(pack_cmi4(cmat), device))


def rand_tables(device, seed: int = 0) -> LeafTables:
    """The script's timing fixture (rand_fixture). The kernels build R from
    the rays, as the production leaf does (rt_mxu_rays), so the fixture's
    random R table is not read."""
    fx = fixtures.rand_fixture(seed)
    return leaf_tables(fx.planes, fx.tri, fx.cmat, device)


def accuracy_tables(dense: bool, device) -> LeafTables:
    """accuracy_check's one group of 8 triangles and its 1,024 rays."""
    fx = fixtures.accuracy_fixture(dense)
    planes = [fx.o[:, k] for k in range(3)] + [fx.d[:, k] for k in range(3)]
    return leaf_tables(planes, fixtures.tri_row(fx.v0, fx.e1, fx.e2),
                       fixtures.build_cmat(fx.v0, fx.e1, fx.e2), device)


def _check_args(tab: LeafTables, mode, full, layout, c_in_a, distinct, iters, n):
    if (mode, bool(full), layout, bool(c_in_a)) not in INSTANCES:
        raise ValueError(f"no leaf instance for mode={mode!r}, full={full}, "
                         f"layout={layout!r}, c_in_a={c_in_a}")
    device = tab.tri.device
    G = tab.tri.shape[0]
    if G & (G - 1) or G < 1:
        raise ValueError(f"{G} groups: the ring needs a power of two")
    if distinct not in DISTINCT or distinct > G:
        raise ValueError(f"distinct={distinct}: one of {DISTINCT}, at most {G}")
    n_src = tab.planes[0].numel()
    if n_src % 32:
        raise ValueError(f"{n_src} rays: a multiple of 32 (whole warps)")
    if n % BLOCK or iters < 0:
        raise ValueError(f"n={n}, iters={iters}: n a multiple of {BLOCK}, iters >= 0")
    for i, p in enumerate(tab.planes):
        _check(f"ray plane {i}", p, torch.float32, (n_src,), device)
    _check("tri", tab.tri, torch.float32, (G, 128), device)
    _check("cf32", tab.cf32, torch.float32, (G * 32, 16), device)
    _check("cmat", tab.cmat, torch.bfloat16, (G * 32, 32), device)
    _check("chi", tab.chi, torch.bfloat16, (G * 32, 16), device)
    _check("clo", tab.clo, torch.bfloat16, (G * 32, 16), device)
    _check("cmi4", tab.cmi4, torch.bfloat16, (-(-G // 4) * 32, 128), device)
    return device, G, n_src


def leaf_visits(tab: LeafTables, mode: str, *, iters: int, n: Optional[int] = None,
                full: bool = False, layout: str = "interleaved", c_in_a: bool = False,
                distinct: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, idx) of n threads after `iters` leaf visits: (n,) f32 and (n,)
    i32 (-1 without `full` or on a miss). CPU tables run leaf_plain."""
    n = tab.planes[0].numel() if n is None else n
    device, G, n_src = _check_args(tab, mode, full, layout, c_in_a, distinct, iters, n)
    if device.type == "cpu":
        return leaf_plain(tab, mode, iters=iters, n=n, full=full, distinct=distinct)
    table, clo, pitch = {"interleaved": (tab.cmat, None, 32),
                         "two_tables": (tab.chi, tab.clo, 16),
                         "four_group": (tab.cmi4, None, 128)}[layout]
    t = torch.empty(n, dtype=torch.float32, device=device)
    idx = torch.empty(n, dtype=torch.int32, device=device)
    rc = load_library().mb_leaf(
        *(_ptr(p) for p in tab.planes), n_src, _ptr(tab.tri), _ptr(tab.cf32), _ptr(table),
        _ptr(clo), pitch, G, MODES[mode], int(full), LAYOUTS[layout], int(c_in_a),
        distinct, iters, n, _ptr(t), _ptr(idx), _stream(device))
    LAUNCHES["leaf"] += 1
    _raise_on(rc, f"mb_leaf_kernel<{mode}>")
    return t, idx


# ---- the plain version -------------------------------------------------------

def ring_windows(G: int, distinct: int, iters: int, device=None) -> torch.Tensor:
    """(32, min(iters, G)) the groups each lane visits, in order (a visit past
    G repeats one already made, which never wins a strict < nor moves a
    minimum)."""
    lane = torch.arange(32, device=device)
    off = (lane // (32 // distinct)) * (G // distinct)
    v = torch.arange(min(iters, G), device=device)
    return (off[:, None] + v[None, :]) & (G - 1)


def features(o: Vec3, d: Vec3) -> torch.Tensor:
    """(n, 16) feature rows R = [d, o x d, o, 1, 0 x 6] (mb_features)."""
    one, zero = torch.ones_like(d.x), torch.zeros_like(d.x)
    return torch.stack([d.x, d.y, d.z, o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z,
                        o.x * d.y - o.y * d.x, o.x, o.y, o.z, one] + [zero] * 6, dim=1)


def divided_test(q: torch.Tensor) -> torch.Tensor:
    """t of the divided hit test (_hit_rows) on (..., 4) quantities (det,
    t_num, u_num, v_num); T_MAX on a miss."""
    det = q[..., 0]
    invdet = 1.0 / det
    tt, u, v = q[..., 1] * invdet, q[..., 2] * invdet, q[..., 3] * invdet
    hit = ((det.abs() >= EPSILON) & (tt > EPSILON) & (u >= 0.0) & (v >= 0.0)
           & ((u + v) <= 1.0))
    return torch.where(hit, tt, torch.full_like(tt, T_MAX))


def _slot_rows(c: torch.Tensor) -> torch.Tensor:
    """(Gu * 32, 16) group-major C rows (row 8q + j) -> (Gu * 8, 4, 16) rows
    per slot j."""
    return c.reshape(-1, 4, 8, 16).permute(0, 2, 1, 3).reshape(-1, 4, 16)


def group_tests(tab: LeafTables, mode: str, rays: Tuple[Vec3, Vec3],
                groups: torch.Tensor) -> torch.Tensor:
    """(n, Gu, 8) t of every ray against every triangle of `groups`."""
    o, d = rays
    if mode == "mt":
        rows = tab.tri[groups, : 12 * 8].reshape(-1, 8, 12)
        t, _ = mt_rows(Vec3(*(p[:, None, None] for p in o)),
                       Vec3(*(p[:, None, None] for p in d)), rows)
        return t
    gu = groups.numel()
    if mode == "f32":
        c = tab.cf32.reshape(-1, 32, 16)[groups]
        r = features(o, d)
        q = torch.zeros((r.shape[0], gu, 32), dtype=torch.float32, device=r.device)
        for k in range(16):          # in order, as the kernel sums
            q = q + c[None, :, :, k] * r[:, None, None, k]
        return divided_test(q.reshape(-1, gu, 4, 8).transpose(-1, -2))
    rows = tab.cmat.reshape(-1, 32, 32)[groups].reshape(-1, 32).float()
    hi, lo = _slot_rows(rows[:, :16]), _slot_rows(rows[:, 16:])
    with _full_f32_matmul():
        rh, rl = _ray_halves(o, d)
        if mode == "bf16":
            q = (rh @ hi.reshape(-1, 16).T).reshape(rh.shape[0], -1, 4)
        else:
            q = _mxu_quants(rh, rl, hi, lo)
    return divided_test(q.reshape(rh.shape[0], gu, 8, 4))


def leaf_plain(tab: LeafTables, mode: str, *, iters: int, n: Optional[int] = None,
               full: bool = False, distinct: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of leaf_visits: each source ray against the groups
    of its lane's window, the group's winner the first minimal j, then the
    first minimal t in visit order; tiled to n threads."""
    G = tab.tri.shape[0]
    n_src = tab.planes[0].numel()
    n = n_src if n is None else n
    device = tab.tri.device
    ray = torch.arange(n, device=device) % n_src
    if iters == 0:
        t = torch.full((n_src,), T_MAX, dtype=torch.float32, device=device)
        return t[ray], torch.full((n,), -1, dtype=torch.int32, device=device)
    win = ring_windows(G, distinct, iters, device)               # (32, V)
    groups, pos = torch.unique(win, return_inverse=True)
    o, d = Vec3(*tab.planes[:3]), Vec3(*tab.planes[3:])
    tg, jg = group_tests(tab, mode, (o, d), groups).min(dim=2)   # (n_src, Gu)
    cols = pos[torch.arange(n_src, device=device) % 32]          # (n_src, V)
    tv = tg.gather(1, cols)
    t, first = tv.min(dim=1)
    if full:
        g = win[torch.arange(n_src, device=device) % 32].gather(1, first[:, None])[:, 0]
        j = jg.gather(1, cols).gather(1, first[:, None])[:, 0]
        idx = torch.where(t < T_MAX, g * 8 + j, -1).to(torch.int32)
    else:
        idx = torch.full((n_src,), -1, dtype=torch.int32, device=device)
    return t[ray], idx[ray]


# ---- the accuracy table --------------------------------------------------------

ACCURACY_KINDS = ("bf16", "bf16x3", "f32")


def accuracy(dense: bool, device) -> Dict[str, Dict]:
    """accuracy_check's table on `device`: per product kind (one bf16 pass,
    bf16x3, the f32 product), the reference hits of the FP32 leaf (rt_mt),
    the rays whose hit or miss differs, and the largest relative t error
    where both hit. On the card every t comes from kernel A (one visit of
    the one group), on the CPU from its plain version."""
    tab = accuracy_tables(dense, device)
    t_ref, _ = leaf_visits(tab, "mt", iters=1)
    hit_ref = t_ref < T_MAX
    out = {}
    for kind in ACCURACY_KINDS:
        tm, _ = leaf_visits(tab, kind, iters=1)
        hit = tm < T_MAX
        both = hit_ref & hit
        rel = (tm - t_ref).abs()[both] / t_ref[both].clamp(min=1e-6)
        out[kind] = {"hits_ref": int(hit_ref.sum()), "disagree": int((hit_ref != hit).sum()),
                     "max_rel_t_err": float(rel.max()) if rel.numel() else 0.0}
    return out


# ---- the stages ----------------------------------------------------------------

class Config(NamedTuple):
    mode: str
    full: bool = False
    layout: str = "interleaved"
    c_in_a: bool = False
    distinct: int = 1


# What each stage asks the card (the script's stage of the same name asked
# the TPU): v1 the operand placement, v2 the product's pipe and precision,
# v3 the accuracy with random directions, v4 the cost of winner tracking,
# v5 the accuracy with dense hits and the cost against the lanes served per
# batch (distinct groups per warp), v6 the table's layout.
STAGES: Dict[str, Dict] = {
    "v1": {"configs": [Config("mt"), Config("bf16x3"), Config("bf16x3", c_in_a=True),
                       Config("bf16x3", distinct=32), Config("bf16x3", c_in_a=True, distinct=32)]},
    "v2": {"configs": [Config(m) for m in MODES]},
    "v3": {"accuracy": False, "configs": []},
    "v4": {"configs": [Config(m, full=True) for m in MODES]},
    "v5": {"accuracy": True,
           "configs": [Config(m, full=True, distinct=dd) for dd in DISTINCT
                       for m in ("mt", "bf16x3")]},
    "v6": {"configs": [Config("bf16x3", layout=lay) for lay in LAYOUTS]},
}
CPU_ITERS = 2


def config_record(c: Config) -> Dict:
    return {"mode": c.mode, "full": c.full,
            "layout": c.layout if c.mode in MXU_MODES else None,
            "placement": (("c_in_a" if c.c_in_a else "rays_in_a")
                          if c.mode in MXU_MODES else None),
            "distinct": c.distinct}


def visit_ops(c: Config) -> Dict[str, float]:
    """Operations one ray's visit needs, by pipe: FP32 and tensor-core."""
    if c.mode == "mt":
        return {"fp32": 8 * OPS_MT, "tensor": 0}
    if c.mode == "f32":
        return {"fp32": F32_PRODUCT_OPS + 8 * OPS_EPILOGUE, "tensor": 0}
    passes = 1 if c.mode == "bf16" else 3
    return {"fp32": 8 * OPS_EPILOGUE, "tensor": passes * MMA_OPS_PER_PASS}


def run(stages: List[str], device, n: int, timing=None) -> List[Dict]:
    """Records of the given stages. With `timing` (microbench._timing) each
    configuration's marginal cost per visit over n threads on the card;
    without it (the CPU), the plain version at CPU_ITERS visits and its
    hits, no times."""
    tab = rand_tables(device)
    done: Dict[Config, Dict] = {}
    out = []
    for name in stages:
        st = STAGES[name]
        if "accuracy" in st:
            out.append({"stage": name, "accuracy": "dense" if st["accuracy"] else "random",
                        "table": accuracy(st["accuracy"], device)})
        for c in st["configs"]:
            if c not in done:
                kw = dict(full=c.full, layout=c.layout, c_in_a=c.c_in_a, distinct=c.distinct)
                rec = config_record(c)
                if timing is None:
                    t, _ = leaf_visits(tab, c.mode, iters=CPU_ITERS, n=n, **kw)
                    rec.update(iters=CPU_ITERS, n=n, hits=int((t < T_MAX).sum()))
                else:
                    m = timing.measure(lambda k: leaf_visits(tab, c.mode, iters=k, n=n, **kw))
                    rec.update(n=n, ns_per_visit_step=m["ns"],
                               ns_per_ray_visit=m["ns"] / n,
                               ns_per_1024_rays=m["ns"] * 1024 / n, marginal=m)
                done[c] = rec
            out.append(dict(done[c], stage=name))
    return out

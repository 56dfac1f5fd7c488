"""Kernel D (row 15d): does an FP32 inner visit overlap a tensor-core leaf
step on the card?

Port of `_run` of scripts/microbench_overlap.py (:160, pallas_call :168)
with the loop bodies of its `main` (:193): `_inner8` :101 (8 arity-4 inner
visits) alone, the MXU closest-hit and any-hit leaf steps of 4 groups
alone (`_mxu_leaf_closest_n`, `_mxu_leaf_occluded_n`), and both in one
iteration with 4, 6 and 8 groups. `overlap_iters` launches
csrc/microbench_overlap.cu's mb_overlap_kernel (the production rt_visit,
rt_mxu_next, rt_mxu_load, rt_mxu_quants and rt_mxu_*_tile) and returns
each thread's loop index e, t, idx, nd, stack count sp and the stack's top
entry and distance (top, topd) after K iterations; `overlap_plain` is its
plain version. The TPU ran one packet
with a packet-wide loop index driven by ray (0, 0); here each warp is a
packet, driven by its lane 0, so e is the same for the warp's lanes while
each lane tests and pushes for its own ray. `run` times every body and
reports the overlap harvested, (inner + leaf - both) / (inner + leaf -
max(inner, leaf)), as the script's `main` does: 100% if a "both" iteration
costs only the larger of the two, 0% if it costs their sum.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .._build import load_library
from ..ops.cuda_trace import _check, _ptr, _raise_on, _stream
from ..ops.intersect import EPSILON, T_MAX, clip_inv_dir
from ..ops.trace_plain import _full_f32_matmul, _ray_halves
from ..ops.vecmath import Vec3
from . import LAUNCHES, fixtures
from .mxu_leaf import BLOCK, OPS_EPILOGUE, MMA_OPS_PER_PASS, _bf16, divided_test

# body: (inner visits, leaf step: 0 none, 1 closest, 2 any hit, groups)
BODIES = {"inner8": (True, 0, 0), "leaf4_closest": (False, 1, 4),
          "leaf4_occluded": (False, 2, 4), "both_closest": (True, 1, 4),
          "both_occluded": (True, 2, 4), "both_closest6": (True, 1, 6),
          "both_occluded6": (True, 2, 6), "both_occluded8": (True, 2, 8)}
# The value of the never-written stack[0] that the script's chain reads: the
# Pallas interpreter's uninitialized int scratch (INT32_MIN).
UNWRITTEN = -(1 << 31)
INNER_VISITS = 8
# Each thread's outputs, in the order of mb_overlap's pointers.
OUTPUTS = ("e", "t", "idx", "nd", "sp", "top", "topd")
FLOAT_OUT = ("t", "topd")
OPS_BOX_TEST = 25
# Blocks of 128 threads per SM for the timing: a full SM (2,048 threads),
# and one warp per SM sub-partition (4 warps) for overlap within a warp.
OCCUPANCY = (16, 1)


class OverlapTables(NamedTuple):
    planes: tuple                 # ox, oy, oz, dx, dy, dz: (n_src,) f32
    cbox: torch.Tensor            # (N, 32) f32
    cmeta: torch.Tensor           # (N, 8) i32
    cmat: torch.Tensor            # (G * 32, 32) bf16 [hi | lo]


def overlap_tables(device, planes: Optional[list] = None) -> OverlapTables:
    """The script's fixtures on `device`; `planes` replaces its rays."""
    planes = fixtures.overlap_rays() if planes is None else planes
    qbox, meta = fixtures.overlap_boxes()
    return OverlapTables(
        tuple(torch.as_tensor(np.ascontiguousarray(p, np.float32), device=device).reshape(-1)
              for p in planes),
        torch.as_tensor(qbox, device=device), torch.as_tensor(meta, device=device),
        _bf16(fixtures.overlap_cmat(), device))


def _check_args(tab: OverlapTables, body: str, iters: int, n: int):
    if body not in BODIES:
        raise ValueError(f"body {body!r}: one of {sorted(BODIES)}")
    device = tab.cbox.device
    n_src = tab.planes[0].numel()
    if n_src % 32 or n % BLOCK or iters < 0:
        raise ValueError(f"n_src={n_src}, n={n}, iters={iters}: n_src a multiple of 32, "
                         f"n of {BLOCK}, iters >= 0")
    for i, p in enumerate(tab.planes):
        _check(f"ray plane {i}", p, torch.float32, (n_src,), device)
    _check("cbox", tab.cbox, torch.float32, (None, 32), device)
    _check("cmeta", tab.cmeta, torch.int32, (tab.cbox.shape[0], 8), device)
    _check("cmat", tab.cmat, torch.bfloat16, (None, 32), device)
    if tab.cmat.shape[0] % 32:
        raise ValueError("cmat: whole groups of 32 rows")
    return device, n_src


def overlap_iters(tab: OverlapTables, body: str, iters: int,
                  n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """{e, t, idx, nd, sp, top, topd}: (n,) per thread after `iters`
    iterations of `body`. CPU tables run overlap_plain."""
    n = tab.planes[0].numel() if n is None else n
    device, n_src = _check_args(tab, body, iters, n)
    if device.type == "cpu":
        return overlap_plain(tab, body, iters, n)
    inner, leaf, ng = BODIES[body]
    out = {k: torch.empty(n, dtype=torch.float32 if k in FLOAT_OUT else torch.int32,
                          device=device) for k in OUTPUTS}
    rc = load_library().mb_overlap(
        *(_ptr(p) for p in tab.planes), n_src, _ptr(tab.cbox), _ptr(tab.cmeta),
        _ptr(tab.cmat), tab.cbox.shape[0], tab.cmat.shape[0] // 32, int(inner), leaf, ng,
        iters, n, *(_ptr(out[k]) for k in OUTPUTS), _stream(device))
    LAUNCHES["overlap"] += 1
    _raise_on(rc, f"mb_overlap_kernel<{body}>")
    return out


# ---- the plain version -------------------------------------------------------

def _slab(lo, hi, inv: Vec3, oi: Vec3) -> torch.Tensor:
    """rt_slab with t_cut = T_MAX: each box's entry distance, or T_MAX."""
    for a, (iv, oa) in enumerate(zip(inv, oi)):
        t1 = lo[..., a] * iv[:, None] - oa[:, None]
        t2 = hi[..., a] * iv[:, None] - oa[:, None]
        lo_t, hi_t = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo_t if a == 0 else torch.maximum(tmin, lo_t)
        tmax = hi_t if a == 0 else torch.minimum(tmax, hi_t)
    ok = (tmax >= tmin) & (tmax > 0.0) & (tmin < T_MAX)
    return torch.where(ok, tmin, torch.full_like(tmin, T_MAX))


def _leaf_quants(tab: OverlapTables, rh, rl, g_ray: torch.Tensor) -> torch.Tensor:
    """(n, 8, 4) quantities of each ray against its warp's group g_ray[i]:
    Ch.Rh + Ch.Rl + Cl.Rh as f32 products of bf16 values."""
    rows = tab.cmat.reshape(-1, 32, 32)[g_ray].float()
    hi, lo = rows[..., :16], rows[..., 16:]
    q = (torch.einsum("nrk,nk->nr", hi, rh) + torch.einsum("nrk,nk->nr", hi, rl)) \
        + torch.einsum("nrk,nk->nr", lo, rh)
    return q.reshape(-1, 4, 8).transpose(1, 2)


def overlap_plain(tab: OverlapTables, body: str, iters: int,
                  n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The plain version of overlap_iters: each warp of 32 source rays
    iterated with the loop index of its lane 0; tiled to n threads."""
    inner, leaf, ng = BODIES[body]
    device = tab.cbox.device
    n_src = tab.planes[0].numel()
    n = n_src if n is None else n
    N, G = tab.cbox.shape[0], tab.cmat.shape[0] // 32
    o, d = Vec3(*tab.planes[:3]), Vec3(*tab.planes[3:])
    inv = clip_inv_dir(d)
    oi = Vec3(o.x * inv.x, o.y * inv.y, o.z * inv.z)
    warp = torch.arange(n_src, device=device) // 32
    lane0 = torch.arange(0, n_src, 32, device=device)
    e = torch.zeros(n_src // 32, dtype=torch.int64, device=device)
    t = torch.full((n_src,), T_MAX, dtype=torch.float32, device=device)
    idx = torch.full((n_src,), -1, dtype=torch.int64, device=device)
    nd = torch.zeros(n_src, dtype=torch.int64, device=device)
    sp = torch.zeros(n_src, dtype=torch.int64, device=device)
    top = torch.zeros(n_src, dtype=torch.int64, device=device)
    topd = torch.zeros(n_src, dtype=torch.float32, device=device)
    boxes = tab.cbox[:, :24].reshape(N, 4, 6)
    valid = tab.cmeta[:, 4:] > 0
    eps = float(np.float32(EPSILON))
    eps2 = float(np.float32(EPSILON) * np.float32(EPSILON))
    with _full_f32_matmul():
        rh, rl = _ray_halves(o, d)
        for _ in range(iters):
            if leaf:
                m2 = t * t
                for q in range(ng):
                    g = ((e + 11 * q) % G)[warp]
                    qv = _leaf_quants(tab, rh, rl, g)
                    det, tn = qv[..., 0], qv[..., 1]
                    if leaf == 1:
                        tmin, jmin = divided_test(qv).min(dim=1)
                        better = tmin < t
                        t = torch.where(better, tmin, t)
                        idx = torch.where(better, g * 8 + jmin, idx)
                        neg = (det.gather(1, jmin[:, None])[:, 0] < 0.0).long()
                        nd = torch.where(better, neg, nd)
                    else:
                        d2 = det * det
                        pu, pv = qv[..., 2] * det, qv[..., 3] * det
                        hit = ((d2 >= eps2) & (tn * det > eps * d2) & (pu >= 0.0) & (pv >= 0.0)
                               & (pu + pv <= d2) & (tn * tn < m2[:, None] * d2))
                        nd = torch.where(hit.any(dim=1), 1, nd)
            if inner:
                e0 = e + 1 if leaf else e
                sp = torch.full((n_src,), 8, dtype=torch.int64, device=device)
                top = torch.zeros_like(top)
                topd = torch.zeros_like(topd)
                for k in range(INNER_VISITS):
                    node = ((e0 + 37 * k) % N)[warp]
                    b = boxes[node]
                    ms = torch.where(valid[node], _slab(b[..., :3], b[..., 3:], inv, oi), T_MAX)
                    pushed = ms < T_MAX
                    sp = sp + pushed.sum(1)
                    # the nearest child is pushed last: the new top of the stack
                    near_d, near = ms.min(dim=1)
                    some = pushed.any(dim=1)
                    top = torch.where(some, tab.cmeta[node, near].long(), top)
                    topd = torch.where(some, near_d, topd)
            chain = idx if leaf == 1 else nd
            if not inner:
                en = e + chain[lane0] + 1
            elif not leaf:
                en = e + sp[lane0] + UNWRITTEN
            else:
                en = e + sp[lane0] + chain[lane0] + UNWRITTEN
            e = en.abs() % N
    ray = torch.arange(n, device=device) % n_src
    res = {"e": e[warp], "t": t, "idx": idx, "nd": nd, "sp": sp, "top": top, "topd": topd}
    return {k: res[k][ray].to(torch.float32 if k in FLOAT_OUT else torch.int32)
            for k in OUTPUTS}


# ---- timing --------------------------------------------------------------------

CPU_ITERS = 3


def iteration_ops(body: str) -> Dict[str, float]:
    """Operations one ray's iteration needs, by pipe: the box tests of the
    inner visits and the leaf step's epilogue on the FP32 pipe, the bf16x3
    products (K = 10 live features) on the tensor cores."""
    inner, leaf, ng = BODIES[body]
    return {"fp32": (INNER_VISITS * 4 * OPS_BOX_TEST if inner else 0) + ng * 8 * OPS_EPILOGUE,
            "tensor": ng * 3 * MMA_OPS_PER_PASS}


def harvested(r: Dict[str, float]) -> Dict[str, Dict]:
    """The script's overlap figure for the closest and the any-hit step."""
    out = {}
    for k in ("closest", "occluded"):
        s = r["inner8"] + r[f"leaf4_{k}"]
        m = max(r["inner8"], r[f"leaf4_{k}"])
        b = r[f"both_{k}"]
        out[k] = {"sum": s, "max": m, "both": b, "overlap_harvested": (s - b) / max(s - m, 1e-9)}
    return out


def run(device, timing=None, sms: int = 0) -> List[Dict]:
    """Records of every body. On the card (`timing` given): ns per iteration
    of the whole grid at each OCCUPANCY (blocks of 128 per SM), and the
    overlap harvested at each. On the CPU: the plain version at CPU_ITERS
    iterations, no times."""
    tab = overlap_tables(device)
    n_src = tab.planes[0].numel()
    out = []
    if timing is None:
        for body in BODIES:
            r = overlap_plain(tab, body, CPU_ITERS)
            out.append({"body": body, "iters": CPU_ITERS, "n": n_src,
                        "e_lane0": r["e"][::32].tolist(), "sp_sum": int(r["sp"].sum()),
                        "hits": int((r["t"] < T_MAX).sum()), "nd_sum": int(r["nd"].sum())})
        return out
    for occ in OCCUPANCY:
        n = sms * occ * BLOCK
        ns = {}
        for body in BODIES:
            m = timing.measure(lambda k: overlap_iters(tab, body, k, n))
            ns[body] = m["ns"]
            out.append({"body": body, "blocks_per_sm": occ, "n": n, "ns_per_iteration": m["ns"],
                        "ns_per_warp_iteration": m["ns"] * 32 / n, "marginal": m})
        out.append({"overlap": harvested(ns), "blocks_per_sm": occ, "n": n})
    return out

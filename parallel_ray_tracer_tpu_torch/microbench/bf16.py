"""Rows 15e-15h: does the card issue packed bf16x2 at the rate of f32?

Port of scripts/microbench_bf16.py. The script asked the TPU whether its
VPU issues a (16, 128) bf16 tile at the rate of an (8, 128) f32 tile; here
the question is whether one packed __nv_bfloat162 instruction costs what
one f32 instruction costs, so that it covers twice the elements
(csrc/microbench_bf16.cu):

| wrapper | kernel (csrc/microbench_bf16.cu) | replaces (scripts/microbench_bf16.py) |
| ------- | -------------------------------- | ------------------------------------- |
| `chain`, ilp 1 | `mb_chain_kernel<T, OP, W, 1>` | `_chain_bench` :85 (pallas_call :101), row 15e |
| `chain`, ilp 4 | `mb_chain_kernel<T, OP, W, 4>` | `_chain_bench_ilp` :116 (:140), row 15f |
| `slab`, f32    | `mb_slab_kernel<false>`        | `_slab_pair_f32` :155 (:185), row 15g |
| `slab`, bf16   | `mb_slab_kernel<true>`         | `_slab_pair_bf16` :200 (:255), row 15h |

`chain(a, b, op, iters, ilp, blocks)` runs K = iters iterations of 40
dependent ops a = op(a, b) on one R x 128 tile (f32, or bf16 as bf16x2
pairs), with `ilp` independent chains from a + k summed at the end, in
`blocks` blocks that each work the tile; it returns each block's final
tile. `chain_plain` is its plain version (one tile). The script's output is
the tile's maximum (`script_output`).

`slab(rows, planes, fmt, iters, n)` runs the two-child slab probe with the
warp as the packet and returns each warp's loop index e after `iters`
iterations; `slab_plain` is its plain version for any packet size (1,024:
the script's packet; 32: the kernel's). The script's own output, acc + e,
is T_MAX whatever e is (acc stays T_MAX), so e is what is compared.

Each wrapper runs its plain version for tensors on the CPU and launches
its kernel, or raises, for tensors on the card; it counts its launches in
microbench.LAUNCHES ("chain", "slab") and per instance in
microbench.INSTANCE_LAUNCHES. `run` is the `bf16` command of the entry point.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .._build import load_library
from ..ops.cuda_trace import _check, _ptr, _raise_on, _stream
from ..ops.intersect import T_MAX, clip_inv_dir
from ..ops.vecmath import Vec3
from . import count_launch, fixtures

N_OPS = 40                  # n_ops of the script's chains
CHAIN_THREADS = 512         # MB_CHAIN_THREADS: threads holding one tile
OPS = {"fms": 0, "mnx": 1}
# Operations per element of one chain op: a * b - b is two, min(max(a, b),
# b + a) three.
OPS_PER_ELEMENT = {"fms": 2, "mnx": 3}
# Each case of the script's `main` (its keys): (op, tile rows R, bf16, ILP),
# and the two bf16 ILP cases its ILP set lacks (in_script False), which give
# the bf16x2 / f32 ratio under ILP 4.
CHAIN_CASES = {
    "fms_f32_8x128": ("fms", 8, False, 1),
    "fms_f32_16x128": ("fms", 16, False, 1),
    "fms_bf16_8x128": ("fms", 8, True, 1),
    "fms_bf16_16x128": ("fms", 16, True, 1),
    "fms_bf16_32x128": ("fms", 32, True, 1),
    "minmax_f32_8x128": ("mnx", 8, False, 1),
    "minmax_bf16_16x128": ("mnx", 16, True, 1),
    "fms_f32_8x128_ilp": ("fms", 8, False, 4),
    "fms_f32_16x128_ilp": ("fms", 16, False, 4),
    "fms_f32_32x128_ilp": ("fms", 32, False, 4),
    "minmax_f32_8x128_ilp": ("mnx", 8, False, 4),
    "minmax_f32_16x128_ilp": ("mnx", 16, False, 4),
    "fms_bf16_16x128_ilp": ("fms", 16, True, 4),
    "minmax_bf16_16x128_ilp": ("mnx", 16, True, 4),
}
NOT_IN_SCRIPT = ("fms_bf16_16x128_ilp", "minmax_bf16_16x128_ilp")
SLAB_CASES = {"slab2_f32": False, "slab2_bf16_packed": True}
# The bf16x2 / f32 ratios the command reports: the script's line (mul-sub,
# serial) and its counterparts.
RATIOS = {
    "fms_serial": ("fms_bf16_16x128", "fms_f32_8x128"),
    "fms_ilp4": ("fms_bf16_16x128_ilp", "fms_f32_8x128_ilp"),
    "minmax_serial": ("minmax_bf16_16x128", "minmax_f32_8x128"),
    "minmax_ilp4": ("minmax_bf16_16x128_ilp", "minmax_f32_8x128_ilp"),
    "slab": ("slab2_bf16_packed", "slab2_f32"),
}
# The pallas_call each kernel instance replaces (scripts/microbench_bf16.py).
SCRIPT_LINE = {"chain1": 101, "chain4": 140, "slab_f32": 185, "slab_bf16": 255}
# Operations per ray and iteration of the slab probe: f32, two rt_slab
# tests of 25 FP32 operations; bf16, one packed test of 22 bf16x2
# instructions (6 mul, 6 sub, 6 min/max, 4 min/max) covering both children,
# then 3 f32 operations a child (2 compares, 1 select). The packet
# reductions are not counted.
SLAB_OPS = {False: {"fp32": 50, "bf16x2": 0}, True: {"fp32": 6, "bf16x2": 22}}


def chain_instance(op: str, rows: int, bf16: bool, ilp: int) -> str:
    return f"chain<{'bf16x2' if bf16 else 'f32'},{op},{rows}x128{',ilp4' if ilp == 4 else ''}>"


def slab_instance(bf16: bool) -> str:
    return f"slab<{'bf16x2' if bf16 else 'f32'}>"


INSTANCES = frozenset(chain_instance(*c) for c in CHAIN_CASES.values())


# ---- the chains (rows 15e, 15f) ----------------------------------------------------


def chain_inputs(rows: int, bf16: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The script's a = _rand and b = _rand * 0.5 of an (rows, 128) tile, as
    torch tensors (f32 or bfloat16) on `device`. Both come from the same
    seed, so b = a / 2 (exactly, in either type)."""
    a = fixtures.bf16_rand((rows, 128), bf16)
    t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if bf16 else torch.from_numpy(a)
    return t.to(device), (t * 0.5).to(device)


def _words(a: torch.Tensor) -> int:
    return a.numel() // (2 if a.dtype == torch.bfloat16 else 1) // CHAIN_THREADS


def _check_chain(a, b, op, ilp) -> str:
    if op not in OPS or ilp not in (1, 4):
        raise ValueError(f"op {op!r}, ilp {ilp}: one of {sorted(OPS)}, ilp 1 or 4")
    if a.dtype not in (torch.float32, torch.bfloat16) or a.dim() != 2 or a.shape[1] != 128:
        raise ValueError(f"a: (R, 128) f32 or bfloat16, got {a.dtype} {tuple(a.shape)}")
    _check("b", b, a.dtype, tuple(a.shape), a.device)
    _check("a", a, a.dtype, tuple(a.shape), a.device)
    name = chain_instance(op, a.shape[0], a.dtype == torch.bfloat16, ilp)
    if name not in INSTANCES:
        raise ValueError(f"{name}: no such instance; built: {sorted(INSTANCES)}")
    return name


def _chain_op(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == "fms":
        return a * b - b
    return torch.minimum(torch.maximum(a, b), b + a)


def chain_plain(a: torch.Tensor, b: torch.Tensor, op: str, iters: int,
                ilp: int = 1) -> torch.Tensor:
    """The tile after `iters` iterations of N_OPS ops on each of `ilp`
    chains (a + k), summed in order; every torch op rounds to the tile's
    type. (The kernel's min/max drop a NaN where torch's keep it; the
    min-max chains make none.)"""
    chains = [a if k == 0 else a + k for k in range(ilp)]
    for _ in range(iters):
        for _ in range(N_OPS):
            chains = [_chain_op(op, c, b) for c in chains]
    acc = chains[0]
    for c in chains[1:]:
        acc = acc + c
    return acc


def chain(a: torch.Tensor, b: torch.Tensor, op: str, iters: int, ilp: int = 1,
          blocks: int = 1) -> torch.Tensor:
    """(blocks, R, 128): each block's tile after `iters` iterations. CPU
    tiles run chain_plain (every block's tile is the same)."""
    name = _check_chain(a, b, op, ilp)
    if iters < 0 or blocks < 1:
        raise ValueError(f"iters={iters}, blocks={blocks}")
    if a.device.type == "cpu":
        return chain_plain(a, b, op, iters, ilp)[None].expand(blocks, *a.shape).clone()
    out = torch.empty((blocks, *a.shape), dtype=a.dtype, device=a.device)
    rc = load_library().mb_chain(_ptr(a), _ptr(b), int(a.dtype == torch.bfloat16), OPS[op],
                                 _words(a), ilp, iters, blocks, _ptr(out), _stream(a.device))
    count_launch(name, "chain")
    _raise_on(rc, f"mb_chain_kernel {name}")
    return out


def script_output(tile: torch.Tensor) -> float:
    """The script's out[0, 0]: the tile's maximum as f32."""
    return float(tile.float().max())


# ---- the slab pair (rows 15g, 15h) --------------------------------------------------


def slab_inputs(device) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The script's f32 node rows (_box_rows(float32), which `main` passes to
    both probes) and its six (8, 128) ray planes (_rand: all six the same
    values), flattened to 1,024 rays."""
    rows = torch.from_numpy(fixtures.bf16_box_rows()).to(device)
    plane = torch.from_numpy(fixtures.bf16_rand(fixtures.PACKET).reshape(-1)).to(device)
    return rows, tuple(plane.clone() for _ in range(6))


def _check_slab(rows, planes, iters, n):
    device = rows.device
    _check("rows", rows, torch.float32, (fixtures.BF16_NODES, 16), device)
    n_src = planes[0].numel()
    for k, p in enumerate(planes):
        _check(f"ray plane {k}", p, torch.float32, (n_src,), device)
    if n_src % 32 or n % 128 or n % n_src or iters < 0:
        raise ValueError(f"n_src={n_src}, n={n}, iters={iters}: n_src a multiple of 32, "
                         "n of 128 and of n_src, iters >= 0")
    return device, n_src


def _slab_f32(lo, hi, inv: Vec3, oi: Vec3) -> torch.Tensor:
    """pallas_trace._slab_masked (rt_slab) with t_cut = T_MAX, per ray."""
    for k, (iv, oa) in enumerate(zip(inv, oi)):
        t1 = lo[:, k] * iv - oa
        t2 = hi[:, k] * iv - oa
        lo_t, hi_t = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo_t if k == 0 else torch.maximum(tmin, lo_t)
        tmax = hi_t if k == 0 else torch.minimum(tmax, hi_t)
    ok = (tmax >= tmin) & (tmax > 0.0) & (tmin < T_MAX)
    return torch.where(ok, tmin, torch.full_like(tmin, T_MAX))


def slab_plain(rows: torch.Tensor, planes, bf16: bool, iters: int, packet: int,
               n: int = 0) -> torch.Tensor:
    """e of each packet of `packet` consecutive rays after `iters`
    iterations (int32), tiled to n // packet packets when n is given (thread
    i on ray i % n_src). f32: both children's _slab_masked tests; bf16: the
    script's packed test, every product, difference, minimum and maximum in
    bf16, the compares in f32."""
    n_src = planes[0].numel()
    n_pk = n_src // packet
    o, d = Vec3(*planes[:3]), Vec3(*planes[3:])
    if bf16:
        o2 = torch.stack(list(o), 1).bfloat16()
        inv2 = (1.0 / torch.stack(list(d), 1).bfloat16().float()).bfloat16()
        oi2 = o2 * inv2
    else:
        inv = clip_inv_dir(d)
        oi = Vec3(o.x * inv.x, o.y * inv.y, o.z * inv.z)
    of_ray = torch.arange(n_src, device=rows.device) // packet
    e = torch.zeros(n_pk, dtype=torch.int64, device=rows.device)
    tmax_f = torch.tensor(T_MAX, dtype=torch.float32, device=rows.device)
    for _ in range(iters):
        row = rows[e][of_ray]                                     # (n_src, 16)
        if bf16:
            lo = torch.stack([row[:, 0:3], row[:, 6:9]], 1).bfloat16()   # (n_src, 2, 3)
            hi = torch.stack([row[:, 3:6], row[:, 9:12]], 1).bfloat16()
            t1 = lo * inv2[:, None] - oi2[:, None]
            t2 = hi * inv2[:, None] - oi2[:, None]
            tmin = torch.minimum(t1, t2).amax(dim=2).float()
            tmax = torch.maximum(t1, t2).amin(dim=2).float()
            v = torch.where((tmax >= tmin) & (tmax > 0.0), tmin, tmax_f)
            vl, vr = v[:, 0], v[:, 1]
        else:
            vl = _slab_f32(row[:, 0:3], row[:, 3:6], inv, oi)
            vr = _slab_f32(row[:, 6:9], row[:, 9:12], inv, oi)
        ml = vl.view(n_pk, packet).amin(1)
        mr = vr.view(n_pk, packet).amin(1)
        e = (e + 1 + (ml < mr).long()) % fixtures.BF16_NODES
    e = e.to(torch.int32)
    return e.repeat(n // n_src) if n else e


def slab(rows: torch.Tensor, planes, bf16: bool, iters: int, n: int = 0) -> torch.Tensor:
    """(n // 32,) int32: each warp's e after `iters` iterations, thread i on
    ray i % n_src (n defaults to n_src). CPU tables run slab_plain with
    32-ray packets."""
    n = n or planes[0].numel()
    device, n_src = _check_slab(rows, planes, iters, n)
    if device.type == "cpu":
        return slab_plain(rows, planes, bf16, iters, 32, n)
    out = torch.empty(n // 32, dtype=torch.int32, device=device)
    rc = load_library().mb_slab(_ptr(rows), *(_ptr(p) for p in planes), n_src, int(bf16),
                                iters, n, _ptr(out), _stream(device))
    name = slab_instance(bf16)
    count_launch(name, "slab")
    _raise_on(rc, f"mb_slab_kernel {name}")
    return out


# ---- the bf16 command ------------------------------------------------------------------

CPU_ITERS = 3
BLOCKS_PER_SM = 4           # 2,048 threads per SM in blocks of 512


def chain_ops(case: str, iters: int, blocks: int) -> Dict[str, float]:
    """Element operations of `iters` iterations over `blocks` tiles, by
    type (bf16 on the packed path)."""
    op, rows, bf16, ilp = CHAIN_CASES[case]
    ops = iters * N_OPS * ilp * rows * 128 * blocks * OPS_PER_ELEMENT[op]
    return {"bf16x2" if bf16 else "fp32": float(ops)}


def run(device, timing=None, sms: int = 0) -> List[Dict]:
    """Records of every chain case and both slab formats. On the card
    (`timing` given): the marginal ns per iteration of the whole grid, ns
    per op (40 per chain and iteration, as the script divides by n_ops and
    by its ILP), ns per op per 1,024 elements, and the
    bf16x2 / f32 ratios of RATIOS (per tile op, as the script's line). On
    the CPU: the plain versions at CPU_ITERS iterations, no times."""
    out, ns = [], {}
    blocks = sms * BLOCKS_PER_SM if timing else 1
    for case, (op, rows, bf16, ilp) in CHAIN_CASES.items():
        a, b = chain_inputs(rows, bf16, device)
        rec = {"case": case, "op": op, "shape": [rows, 128], "dtype": "bf16" if bf16 else "f32",
               "ilp": ilp, "in_script": case not in NOT_IN_SCRIPT,
               "instance": chain_instance(op, rows, bf16, ilp)}
        if timing is None:
            tile = chain(a, b, op, CPU_ITERS, ilp)[0]
            rec.update(iters=CPU_ITERS, script_output=script_output(tile),
                       finite_frac=float(torch.isfinite(tile.float()).float().mean()))
        else:
            m = timing.measure(lambda k: chain(a, b, op, k, ilp, blocks))
            elems = blocks * rows * 128
            per_op = m["ns"] / (N_OPS * ilp)        # the script's ns per op, at its ILP
            ns[case] = per_op
            rec.update(blocks=blocks, elements=elems, ns_per_iteration=m["ns"], ns_per_op=per_op,
                       ns_per_op_per_1024=per_op * 1024 / elems,
                       element_ops_per_s=elems * OPS_PER_ELEMENT[op] / per_op * 1e9,
                       marginal=m)
        out.append(rec)
    rows_t, planes = slab_inputs(device)
    n = sms * BLOCKS_PER_SM * CHAIN_THREADS if timing else planes[0].numel()
    for case, bf16 in SLAB_CASES.items():
        rec = {"case": case, "dtype": "bf16" if bf16 else "f32", "instance": slab_instance(bf16),
               "n": n}
        if timing is None:
            rec.update(iters=CPU_ITERS, e=slab(rows_t, planes, bf16, CPU_ITERS).tolist(),
                       e_packet_1024=int(slab_plain(rows_t, planes, bf16, CPU_ITERS, 1024)[0]))
        else:
            m = timing.measure(lambda k: slab(rows_t, planes, bf16, k, n))
            ns[case] = m["ns"]
            rec.update(ns_per_iteration=m["ns"], ns_per_visit_per_1024=m["ns"] * 1024 / n,
                       marginal=m)
        out.append(rec)
    if timing is not None:
        out.append({"ratios_bf16x2_over_f32": {k: ns[x] / ns[y] for k, (x, y) in RATIOS.items()},
                    "script_line": "bf16(16,128) / f32(8,128) mul-sub ratio: "
                                   f"{ns['fms_bf16_16x128'] / ns['fms_f32_8x128']:.2f}"})
    return out

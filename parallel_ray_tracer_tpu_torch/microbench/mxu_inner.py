"""Row 15m: does a tensor-core (mma.sync m16n8k16) inner-node test beat the
FP32 slab test, at the same 32 children an iteration?

Port of scripts/microbench_mxu_inner.py: `_run` :108 (pallas_call :141)
with the bodies of its `main` :275. The slab plane distances are linear in
the ray features S = [inv, oi], so a visit's distances are one bf16x3
product W S (`_mxu_quants` :214), W's rows built at pack time (`w_table`
:68), and the min/max chain runs on the product (`_node_minmax` :230).
csrc/microbench_mxu_inner.cu's mb_mxu_inner_kernel runs each body; e = |e'|
% 512 after each iteration:

| body | script (line) | one iteration |
| ---- | ------------- | ------------- |
| I | `body_vpu4(True)` :183 | 8 BVH4 nodes: 32 rt_slab per ray, packet minima, per node rt_sort<4> and 4 pushes (`_push` :175); e' = e + 1 + sp |
| J | `body_mxu(8, 4, True)` :248 | 4 BVH8 nodes: 3 bf16 mma products (144 mma a warp), the min/max chain, warp minima, rt_sort<8>, 8 pushes a node |
| K | `body_mxu(4, 8, True)` :248 | 8 BVH4 nodes, the same with rt_sort<4> |
| M | `body_vpu4(False)` :183 | I's slabs, one minimum over all; e' = e + 1 + (s < 0), acc += s |
| L | `body_mxu(8, 4, False)` :248 | J's products and minima, s the sum of the node minima |

I and M run at packet 1 (one ray a thread: the port's visit) and 32 (the
warp as the script's packet); mma is a warp instruction, so J, K and L run
at packet 32 only. `probe(tab, body, iters, packet)` launches the instance
and returns each thread's e, acc and `top` (the entry below the final stack
pointer, which keeps the pushes live); `mxu_inner_plain` is the plain
version for any packet (1,024: the script's), its products f32 matmuls of
the bf16 halves (exact products, one rounding of each sum: see
ops/trace_plain._full_f32_matmul). The wrappers run the plain version for
tensors on the CPU and launch the kernel, or raise, for tensors on the
card; they count launches in microbench.LAUNCHES ("mxu_inner") and per
instance in microbench.INSTANCE_LAUNCHES. `run` is the `mxu_inner` command.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .._build import load_library
from ..ops.cuda_trace import _check, _ptr, _raise_on, _stream
from ..ops.trace_plain import _full_f32_matmul
from . import count_launch, fixtures, sass
from .inner import BLOCK, THREADS_PER_SM, Packets, Stack, sort4

N_NODES = fixtures.MXU_INNER_NODES
# body: (MbMxuBody code, arity, npop)
BODIES = {"I": (0, 4, 8), "J": (2, 8, 4), "K": (2, 4, 8), "M": (1, 4, 8), "L": (3, 8, 4)}
# The script's `_run` names (:279-288).
LABELS = {"I": "I VPU 8x BVH4 + sorts + pushes", "J": "J MXU 4x BVH8 + sorts + pushes",
          "K": "K MXU 8x BVH4 + sorts + pushes", "M": "M VPU vector part only",
          "L": "L MXU BVH8 vector part only"}
SCRIPT_LINES = {"I": 183, "J": 248, "K": 248, "M": 183, "L": 248}
MXU_BODIES = ("J", "K", "L")
PACKETS = {b: ((32,) if b in MXU_BODIES else (1, 32)) for b in BODIES}
# Stack stores one iteration makes (the SASS keeps one STL per push).
PUSHES = {"I": 32, "J": 32, "K": 32}
# The H100 questions: (numerator, denominator) at packet 32.
QUESTIONS = {"J_over_I": ("J", "I"), "K_over_I": ("K", "I"), "L_over_M": ("L", "M")}


def instance(body: str, packet: int) -> str:
    return f"mxu_inner<{body},p{packet}>"


INSTANCES = frozenset(instance(b, p) for b in BODIES for p in PACKETS[b])


class MxuTables(NamedTuple):
    planes: tuple           # ox, oy, oz, dx, dy, dz: (n_src,) f32
    cbox: torch.Tensor      # (512, 32) f32 BVH4 rows (the script's qbox)
    cmeta: torch.Tensor     # (512, 8) i32 (meta4)
    w8: torch.Tensor        # (512 * 48, 32) bf16 [h | l]
    meta8: torch.Tensor     # (512, 16) i32
    w4: torch.Tensor        # (512 * 24, 32) bf16 [h | l]


def mxu_tables(device, planes: Optional[list] = None, grow: float = 0.0) -> MxuTables:
    """The script's tables and rays on `device`; `planes` replaces its rays,
    `grow` widens its boxes (fixtures.mxu_inner_tables)."""
    planes = fixtures.overlap_rays() if planes is None else planes
    t = fixtures.mxu_inner_tables(grow)
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    bf = lambda bits: torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).to(device)
    return MxuTables(tuple(dev(np.asarray(p, np.float32).reshape(-1)) for p in planes),
                     dev(t.qbox), dev(t.meta4), bf(t.w8), dev(t.meta8), bf(t.w4))


def _check_tables(tab: MxuTables, iters: int, n: int):
    device = tab.cbox.device
    n_src = tab.planes[0].numel()
    if n_src % 32 or n % (32 if device.type == "cpu" else BLOCK) or iters < 0:
        raise ValueError(f"n_src={n_src}, n={n}, iters={iters}: n_src a multiple of 32, "
                         f"n of {BLOCK} (on the CPU: of 32), iters >= 0")
    for i, p in enumerate(tab.planes):
        _check(f"ray plane {i}", p, torch.float32, (n_src,), device)
    _check("qbox", tab.cbox, torch.float32, (N_NODES, 32), device)
    _check("meta4", tab.cmeta, torch.int32, (N_NODES, 8), device)
    _check("w8", tab.w8, torch.bfloat16, (N_NODES * 48, 32), device)
    _check("meta8", tab.meta8, torch.int32, (N_NODES, 16), device)
    _check("w4", tab.w4, torch.bfloat16, (N_NODES * 24, 32), device)
    return device


def probe(tab: MxuTables, body: str, iters: int, packet: int,
          n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """{e, acc, top}: (n,) per thread after `iters` iterations of `body` at
    `packet` (thread i on ray i % n_src). CPU tables run mxu_inner_plain."""
    if body not in BODIES:
        raise ValueError(f"body {body!r}: one of {sorted(BODIES)}")
    name = instance(body, packet)
    if name not in INSTANCES:
        raise ValueError(f"{name}: no such instance; built: {sorted(INSTANCES)}")
    n = tab.planes[0].numel() if n is None else n
    device = _check_tables(tab, iters, n)
    if device.type == "cpu":
        return mxu_inner_plain(tab, body, iters, packet, n)
    out = {"e": torch.empty(n, dtype=torch.int32, device=device),
           "acc": torch.empty(n, dtype=torch.float32, device=device),
           "top": torch.empty(n, dtype=torch.int32, device=device)}
    code, arity, npop = BODIES[body]
    rc = load_library().mb_mxu_inner(
        *(_ptr(p) for p in tab.planes), tab.planes[0].numel(), _ptr(tab.cbox), _ptr(tab.cmeta),
        _ptr(tab.w8), _ptr(tab.meta8), _ptr(tab.w4), code, arity, npop, packet, iters, n,
        _ptr(out["e"]), _ptr(out["acc"]), _ptr(out["top"]), _stream(device))
    count_launch(name, "mxu_inner")
    _raise_on(rc, f"mb_mxu_inner_kernel {name}")
    return out


# ---- the plain version ------------------------------------------------------------------

# pallas_trace._sortn's 8-network (rt_sort<8>): swaps on a strict >.
SORT8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (1, 2), (5, 6),
         (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6), (2, 4), (3, 5), (3, 4))


def sort8(ms: List[torch.Tensor], es: List[torch.Tensor]):
    ms, es = list(ms), list(es)
    for i, j in SORT8:
        sw = ms[i] > ms[j]
        ms[i], ms[j] = torch.where(sw, ms[j], ms[i]), torch.where(sw, ms[i], ms[j])
        es[i], es[j] = torch.where(sw, es[j], es[i]), torch.where(sw, es[i], es[j])
    return ms, es


def rows_of(e: torch.Tensor, npop: int) -> torch.Tensor:
    """(q, npop) nodes of each packet's iteration at e."""
    return (e[:, None] + 37 * torch.arange(npop, device=e.device)) % N_NODES


def _features(pk: Packets):
    """S's bf16 halves as f32, (n_src, 16): [inv, oi, 0 x 10] split as
    _split_bf16 splits it."""
    f = torch.stack([*pk.inv, *pk.oi], dim=1)
    f = torch.cat([f, torch.zeros(f.shape[0], 10, dtype=f.dtype, device=f.device)], dim=1)
    hi = f.bfloat16()
    return hi.float(), (f - hi.float()).bfloat16().float()


def _node_minima(tab: MxuTables, pk: Packets, rows: torch.Tensor, arity: int, sh, sl):
    """(q, npop, arity) packet minima of each node's children from the
    products (Ch.Sh + Ch.Sl) + Cl.Sh and `_node_minmax`."""
    q, npop = rows.shape
    r = 6 * arity
    w = tab.w8 if arity == 8 else tab.w4
    idx = (rows[:, :, None] * r + torch.arange(r, device=rows.device)).reshape(q, npop * r)
    ch, cl = w[idx, :16].float(), w[idx, 16:].float()              # (q, npop r, 16)
    shp = sh.view(q, pk.packet, 16).transpose(1, 2)                  # (q, 16, packet)
    slp = sl.view(q, pk.packet, 16).transpose(1, 2)
    out = (torch.bmm(ch, shp) + torch.bmm(ch, slp)) + torch.bmm(cl, shp)
    blk = out.view(q, npop, 6, arity, pk.packet)
    tx1, tx2, ty1, ty2, tz1, tz2 = blk.unbind(2)
    tmin, tmax = torch.minimum(tx1, tx2), torch.maximum(tx1, tx2)
    tmin = torch.maximum(tmin, torch.minimum(ty1, ty2))
    tmax = torch.minimum(tmax, torch.maximum(ty1, ty2))
    tmin = torch.maximum(tmin, torch.minimum(tz1, tz2))
    tmax = torch.minimum(tmax, torch.maximum(tz1, tz2))
    ok = (tmax >= tmin) & (tmax > 0.0)
    return torch.where(ok, tmin, pk.tmax).amin(-1)


def mxu_inner_plain(tab: MxuTables, body: str, iters: int, packet: int,
                    n: Optional[int] = None, visited: Optional[list] = None
                    ) -> Dict[str, torch.Tensor]:
    """e, acc and top of each packet of `packet` source rays after `iters`
    iterations of `body`, for n threads (thread i on ray i % n_src).
    `visited`, when given, gets each iteration's e (read_bytes)."""
    _, arity, npop = BODIES[body]
    pk = Packets(tab, packet)
    dev = tab.cbox.device
    e = torch.zeros(pk.q, dtype=torch.int64, device=dev)
    acc = torch.zeros(pk.q, dtype=torch.float32, device=dev)
    st = Stack(pk.q, 33, dev)
    sp = torch.zeros_like(e)
    meta = tab.meta8 if arity == 8 else tab.cmeta
    if body in MXU_BODIES:
        sh, sl = _features(pk)
    with _full_f32_matmul() if dev.type == "cuda" else nullcontext():
        for _ in range(iters):
            if visited is not None:
                visited.append(e)
            rows = rows_of(e, npop)
            if body in MXU_BODIES:
                ms_all = _node_minima(tab, pk, rows, arity, sh, sl)              # (q, npop, A)
            else:
                v = pk.slab(pk.boxes[rows].reshape(pk.q, 32, 6)[pk.of_ray])
                v = v.view(pk.q, packet, npop, arity)
                ms_all = v.amin(1)
            if body in ("M", "L"):
                if body == "M":
                    s = ms_all.amin(dim=(1, 2))
                else:
                    s = torch.zeros_like(acc)
                    for j in range(npop):
                        s = s + ms_all[:, j].amin(-1)
                en = e + 1 + (s < 0).long()
                acc = acc + s
            else:
                sp = torch.zeros_like(e)
                for j in range(npop):
                    ms = [ms_all[:, j, k] for k in range(arity)]
                    es = [meta[rows[:, j], k].long() for k in range(arity)]
                    ms, es = sort4(ms, es) if arity == 4 else sort8(ms, es)
                    for k in reversed(range(arity)):
                        st.store(sp, es[k])
                        sp = sp + (ms[k] < pk.tmax).long()
                en = e + 1 + sp
            e = en.abs() % N_NODES
    top = st.top(sp, 0) if iters and body in PUSHES else torch.zeros_like(e)
    n = pk.n_src if n is None else n
    return {"e": pk.per_thread(e, n).to(torch.int32), "acc": pk.per_thread(acc, n),
            "top": pk.per_thread(top, n).to(torch.int32)}


# ---- the bound's work -----------------------------------------------------------------------

# FP32 operations: a slab test (25), a 4-sort (5 compare-exchanges of 5) and
# an 8-sort (19 of 5); the MXU bodies' chain per child and ray: the two adds
# of the three products and `_node_minmax`'s 10 min/max and 2 compares.
OPS_BOX_TEST, OPS_SORT4, OPS_SORT8, OPS_MINMAX = 25, 25, 95, 14
# Tensor-core operations per ray of one W row: bf16x3, 3 products of the 6
# live features (the 10 zero features are not work), 2 operations each.
MMA_OPS_PER_ROW = 3 * 2 * 6


def iteration_ops(body: str) -> Dict[str, float]:
    """Operations one ray's iteration of `body` needs, by pipe."""
    _, arity, npop = BODIES[body]
    sorts = npop * (OPS_SORT8 if arity == 8 else OPS_SORT4) if body in PUSHES else 0
    if body in MXU_BODIES:
        return {"fp32": 32 * OPS_MINMAX + sorts, "tensor": npop * 6 * arity * MMA_OPS_PER_ROW}
    return {"fp32": 32 * OPS_BOX_TEST + sorts, "tensor": 0}


def read_bytes(tab: MxuTables, body: str, visited: List[torch.Tensor]) -> int:
    """Bytes of the tables one run of `body` must read, each element once:
    the rays, and of each node its iterations visit, its box floats (I, M:
    24) or W rows (J, L: 48, K: 24, of 64 bytes), and its encodings where
    it pushes; `visited` is each iteration's e from mxu_inner_plain."""
    _, arity, npop = BODIES[body]
    rays = 4 * sum(p.numel() for p in tab.planes)
    if not visited:
        return rays
    nodes = int(torch.unique(rows_of(torch.cat(visited), npop)).numel())
    per = 6 * arity * 64 if body in MXU_BODIES else 96
    return rays + nodes * (per + (4 * arity if body in PUSHES else 0))


# ---- the mxu_inner command ------------------------------------------------------------------

CPU_ITERS = 3


def answers(ns: Dict[str, float]) -> Dict[str, float]:
    """The H100 questions' ratios of ns per iteration per 1,024 rays at
    packet 32: J / I, K / I (tensor-core against FP32 visits, sorts and
    pushes included) and L / M (the vector parts), and I at packet 32 over
    packet 1."""
    out = {k: ns[instance(a, 32)] / ns[instance(b, 32)] for k, (a, b) in QUESTIONS.items()}
    out["I_p32_over_p1"] = ns[instance("I", 32)] / ns[instance("I", 1)]
    return out


def run(device, timing=None, sms: int = 0, card: str = "") -> List[Dict]:
    """Records of every instance. On the card (`timing` given): the marginal
    ns per iteration of a grid of THREADS_PER_SM threads per SM, per 1,024
    rays, with SASS counts and the SM clock, each also as the script's
    line; then the answers. On the CPU: the plain version at CPU_ITERS
    iterations with the kernels' packets and the script's, no times."""
    tab = mxu_tables(device)
    out = []
    if timing is None:
        for body in BODIES:
            for p in PACKETS[body]:
                r = probe(tab, body, CPU_ITERS, p)
                rec = {"instance": instance(body, p), "label": LABELS[body], "iters": CPU_ITERS,
                       "e_first": int(r["e"][0]), "acc_first": float(r["acc"][0]),
                       "top_first": int(r["top"][0]), "e_distinct": int(r["e"].unique().numel())}
                if p == 32:
                    q = mxu_inner_plain(tab, body, CPU_ITERS, 1024)
                    rec.update(e_packet_1024=int(q["e"][0]), acc_packet_1024=float(q["acc"][0]))
                out.append(rec)
        return out
    n = sms * THREADS_PER_SM
    counts = sass.instance_counts("microbench_mxu_inner.cu")
    ns = {}
    for body in BODIES:
        for p in PACKETS[body]:
            name = instance(body, p)
            m = timing.measure(lambda k: probe(tab, body, k, p, n))
            ns[name] = m["ns"] * 1024 / n
            out.append({"instance": name, "body": body, "packet": p, "n": n,
                        "label": LABELS[body], "body_line": SCRIPT_LINES[body],
                        "ns_per_iteration": m["ns"], "ns_per_1024_rays": ns[name],
                        "script_line": f"{LABELS[body]:56s} {ns[name]:8.3f} ns/iter "
                                       f"per 1,024 rays (packet {p})",
                        "sass": counts.get(name), "ops_per_ray_iteration": iteration_ops(body),
                        "card": card, "marginal": m})
    ans = answers(ns)
    out.append({"answers": ans, "card": card, "unit": "ratio of ns per iteration per 1,024 rays",
                "script_line": "tensor-core / FP32 inner visit at packet 32: " + ", ".join(
                    f"{k} {ans[k]:.3f}" for k in QUESTIONS)
                + f"; I packet 32 / packet 1: {ans['I_p32_over_p1']:.3f}"})
    return out

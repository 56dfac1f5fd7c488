"""Row 15j: the glue of a wide-pop inner visit on the card, item by item.

Port of scripts/microbench_glue.py: `_run` :132 (pallas_call :135) with its
`_loop_kernel` :103 and its 14 body factories, each at npop 4 and 8 (arity
4). The kernel is row 15i's mb_inner_kernel (csrc/microbench_inner.cuh;
instances in csrc/microbench_glue.cu), at packet 1 (the port's per-ray
visit) and packet 32 (the warp as the script's packet).

| body | script (line) | what one iteration does beyond the npop loads and slabs |
| ---- | ------------- | ------------------------------------------------------- |
| full | `body_full` :214 | per node: packet minima, sort, every child to both stacks (inner, leaf), pointers bumped by kind |
| nosort | `body_nosort` :236 | full without the sort networks |
| nopush | `body_nopush` :256 | full with the pushes replaced by a checksum |
| nopush1 | `body_nopush1` :272 | full with one stack |
| noextract | `body_noextract` :290 | one packet minimum over everything, one meta int |
| vec | `body_vec` :300 | one packet minimum over everything |
| sel1stack | `body_sel1stack` :321 | one two-ended stack: one store per child at a selected address |
| ranksel | `body_ranksel` :385 | pushes to rank-computed slots (`_rank_dests` :344), no sort, two-ended stack |
| rankdual | `body_rankdual` :404 | rank-computed slots, both stacks |
| full_x2 | `body_full_x2` :465 | full, minima by one reduction over all children |
| x2_only | `body_x2_nosortpush` :499 | that extraction alone, checksummed |
| full_x4 | `body_full_x4` :526 | full, a full reduction per child |
| full_xs | `body_full_xs` :570 | full, encodings from the `meta_s` table in shared memory |
| xb | `body_xb` :612 | unsorted, hit bits packed in a mask, `meta_s` in shared memory |

Warp forms of the extraction strategies at packet 32 (the kernel's
docstring): production, one warp reduction per child; x2, one
reduce-scatter butterfly over all children, then one shuffle per child; x4,
a full shuffle butterfly per child; xb, one ballot per child into a mask.
At packet 1 there is nothing to reduce. full_x2, full_x4 and full_xs
compute full's values, xb nosort's: the plain version is shared.

`probe(tab, body, npop, iters, packet)` launches the instance (full also
with `stack="shared"`, its two stacks in shared memory; full_xs and xb
with `meta="global"`, their global-memory twin at the same block size and
shared memory) and returns each thread's e, acc (0: the script adds 0.0)
and top; `glue_plain` is the plain version. `components` is the script's
table of differences (:686-690, :715-729). `run` is the `glue` command
(`probes_only`: full, full_xs, xb, as `--probes-only`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import sass
from .inner import (BIG_BLOCK, BLOCK, N_NODES, PACKETS, THREADS_PER_SM, Instance, Packets,
                    ProbeTables, Stack, _check_tables, iteration_ops as _inner_ops, launch,
                    outputs, probe_tables, smem_bytes, sort4, timed_record, timing_runs)

# body: MbBody code (csrc/microbench_inner.cuh)
BODIES = {"full": 20, "nosort": 21, "nopush": 22, "nopush1": 23, "noextract": 24, "vec": 25,
          "sel1stack": 26, "ranksel": 27, "rankdual": 28, "full_x2": 29, "x2_only": 30,
          "full_x4": 31, "full_xs": 32, "xb": 33}
SCRIPT_LINES = {"full": 214, "nosort": 236, "nopush": 256, "nopush1": 272, "noextract": 290,
                "vec": 300, "sel1stack": 321, "ranksel": 385, "rankdual": 404, "full_x2": 465,
                "x2_only": 499, "full_x4": 526, "full_xs": 570, "xb": 612}
LABELS = {"full": "full production visit", "full_xs": "full, es from SMEM mirror",
          "xb": "packed ok-mask, SMEM es, no sort", "nosort": "no sort network",
          "nopush": "no stack pushes", "nopush1": "single-stack pushes",
          "noextract": "no per-child extracts", "vec": "vector work only",
          "sel1stack": "two-ended single stack", "ranksel": "rank push + single stack",
          "rankdual": "rank push, dual stacks", "full_x2": "full, X2 grouped vector extract",
          "x2_only": "X2 extraction alone", "full_x4": "full, per-child full reduce"}
NPOPS = (4, 8)
PROBES_ONLY = ("full", "full_xs", "xb")
SMEM_META = {"full_xs": "meta_s", "xb": "meta_s"}
STACK_BODIES = ("full",)
# The plain version each body shares.
SEMANTICS = {"full_x2": "full", "full_x4": "full", "full_xs": "full", "xb": "nosort"}
TWO_END, DUMP = 500, 511
# The script's `components` (:715-729): name -> (minuend, subtrahend).
COMPONENTS = {"sort_networks_ns": ("full", "nosort"), "stack_pushes_ns": ("full", "nopush"),
              "dual_vs_single_stack_ns": ("full", "nopush1"),
              "extracts_sort_push_ns": ("full", "noextract"),
              "scalar_total_ns": ("full", "vec"), "sel1stack_saving_ns": ("full", "sel1stack"),
              "ranksel_saving_ns": ("full", "ranksel"),
              "rankdual_saving_ns": ("full", "rankdual"), "x2_saving_ns": ("full", "full_x2"),
              "x4_saving_ns": ("full", "full_x4"), "xs_saving_ns": ("full", "full_xs"),
              "xb_saving_ns": ("full", "xb")}


def stack_ints(npop: int) -> int:
    """Ints of one thread's shared stack columns: two stacks of entries
    8..8 + 4 npop."""
    return 2 * (4 * npop + 1)


def glue_instances() -> List[Instance]:
    """Every row-15j instance built in csrc/microbench_glue.cu."""
    out = []
    for npop in NPOPS:
        for body in BODIES:
            for p in PACKETS:
                if body in SMEM_META:
                    out += [Instance("glue", body, npop, p, "local", m, BIG_BLOCK)
                            for m in ("shared", "global")]
                    continue
                out.append(Instance("glue", body, npop, p, "local", "global", BLOCK))
                if body in STACK_BODIES:
                    out.append(Instance("glue", body, npop, p, "shared", "global", BLOCK))
    return out


INSTANCES = frozenset(i.name for i in glue_instances())


def resolve(body: str, npop: int, packet: int, stack: str, meta: Optional[str]) -> Instance:
    if body not in BODIES:
        raise ValueError(f"body {body!r}: one of {sorted(BODIES)}")
    meta = meta or ("shared" if body in SMEM_META else "global")
    block = BIG_BLOCK if body in SMEM_META else BLOCK
    inst = Instance("glue", body, npop, packet, stack, meta, block)
    if inst.name not in INSTANCES:
        raise ValueError(f"{inst.name}: no such instance; built: {sorted(INSTANCES)}")
    return inst


def probe(tab: ProbeTables, body: str, npop: int, iters: int, packet: int,
          n: Optional[int] = None, stack: str = "local", meta: Optional[str] = None,
          smem_at_least: int = 0) -> Dict[str, torch.Tensor]:
    """{e, acc, top}: (n,) per thread after `iters` iterations of `body` at
    `npop` and `packet`; see inner.probe. CPU tables run glue_plain."""
    inst = resolve(body, npop, packet, stack, meta)
    n = tab.planes[0].numel() if n is None else n
    device = _check_tables(tab, iters, n, inst.block)
    if device.type == "cpu":
        return glue_plain(tab, body, npop, iters, packet, n)
    smem = max(smem_bytes(inst, SMEM_META.get(body), stack_ints(npop), tab), smem_at_least)
    return launch(tab, inst, BODIES[body], SMEM_META.get(body), iters, n, smem)


# ---- the plain version -------------------------------------------------------------------


def _ranks(ms, es, tmax):
    """_rank_dests :344: per child, the valid children of its kind that push
    before it (farther, ties by child index)."""
    ok = [m < tmax for m in ms]
    inner = [ok[k] & (es[k] >= 0) for k in range(4)]
    leaf = [ok[k] & (es[k] < 0) for k in range(4)]
    ri, rl = [], []
    for k in range(4):
        a = b = 0
        for j in range(4):
            if j == k:
                continue
            gt = ms[j] >= ms[k] if j < k else ms[j] > ms[k]
            a = a + (gt & inner[j]).long()
            b = b + (gt & leaf[j]).long()
        ri.append(a)
        rl.append(b)
    return inner, leaf, ri, rl


def glue_plain(tab: ProbeTables, body: str, npop: int, iters: int, packet: int,
               n: Optional[int] = None, visited: Optional[list] = None
               ) -> Dict[str, torch.Tensor]:
    """e, acc (always 0) and top of each packet of `packet` source rays after
    `iters` iterations of `body`, for n threads. `visited`, when given, gets
    each iteration's e (read_bytes)."""
    sem = SEMANTICS.get(body, body)
    pk = Packets(tab, packet)
    dev = tab.cbox.device
    e = torch.zeros(pk.q, dtype=torch.int64, device=dev)
    ist, lst = Stack(pk.q, 512, dev), Stack(pk.q, 512, dev)
    isp = lsp = None
    tmax = pk.tmax
    for _ in range(iters):
        if visited is not None:
            visited.append(e)
        ens = [(e + 3 * i) % N_NODES for i in range(npop)]
        if sem in ("vec", "noextract"):
            m0 = torch.cat([pk.slabs(x) for x in ens], dim=2).amin(dim=(1, 2))
            en = e + 1 + (m0 < 0).long()
            if sem == "noextract":
                en = en + pk.meta(ens[0], 0)
            e = en.abs() % N_NODES
            continue
        ms = [pk.mins(x) for x in ens]
        es = [[pk.meta(x, k) for k in range(4)] for x in ens]
        chk = torch.zeros_like(e)
        if sem == "x2_only":
            s = torch.zeros(pk.q, dtype=torch.float32, device=dev)
            for i in range(npop):
                for k in range(4):
                    s = s + ms[i][k]
                    chk = chk + es[i][k]
            en = e + chk + (s < 0).long()
        elif sem in ("ranksel", "rankdual"):
            isp = torch.full_like(e, 8)
            lsp = torch.full_like(e, TWO_END if sem == "ranksel" else 8)
            for i in reversed(range(npop)):
                inner, leaf, ri, rl = _ranks(ms[i], es[i], tmax)
                for k in range(4):
                    if sem == "ranksel":
                        dest = torch.where(inner[k], isp + ri[k],
                                           torch.where(leaf[k], lsp - rl[k], DUMP))
                        ist.store(dest, es[i][k])
                    else:
                        ist.store(torch.where(inner[k], isp + ri[k], DUMP), es[i][k])
                        lst.store(torch.where(leaf[k], lsp + rl[k], DUMP), es[i][k])
                isp = isp + sum(x.long() for x in inner)
                n_leaf = sum(x.long() for x in leaf)
                lsp = lsp - n_leaf if sem == "ranksel" else lsp + n_leaf
                chk = chk + es[i][0]
            en = e + isp + lsp + chk
        else:
            isp = torch.full_like(e, 8)
            lsp = torch.full_like(e, TWO_END if sem == "sel1stack" else 8)
            for i in reversed(range(npop)):
                m, x = (ms[i], es[i]) if sem == "nosort" else sort4(ms[i], es[i])
                for k in reversed(range(4)):
                    ok, lc = m[k] < tmax, x[k] < 0
                    if sem == "nopush":
                        chk = chk + torch.where(ok, x[k], 0)
                    elif sem == "nopush1":
                        ist.store(isp, x[k])
                        isp = isp + ok.long()
                    elif sem == "sel1stack":
                        ist.store(torch.where(lc, lsp, isp), x[k])
                        isp = isp + (ok & ~lc).long()
                        lsp = lsp - (ok & lc).long()
                    else:   # full, nosort
                        ist.store(isp, x[k])
                        isp = isp + (ok & ~lc).long()
                        lst.store(lsp, x[k])
                        lsp = lsp + (ok & lc).long()
                if sem != "nopush":
                    chk = chk + x[0]
            en = {"nopush": e + chk, "nopush1": e + isp + chk}.get(sem, e + isp + lsp + chk)
        e = en.abs() % N_NODES
    top = torch.zeros_like(e)
    if iters and sem in ("sel1stack", "ranksel"):
        top = ist.top(isp, 8) + torch.where(lsp < TWO_END, ist.at(lsp + 1), 0)
    elif iters and sem == "nopush1":
        top = ist.top(isp, 8)
    elif iters and sem in ("full", "nosort", "rankdual"):
        top = ist.top(isp, 8) + lst.top(lsp, 8)
    return outputs(pk, n, e, torch.zeros(pk.q, dtype=torch.float32, device=dev), top)


# ---- the glue command -----------------------------------------------------------------

CPU_ITERS = 3


def iteration_ops(body: str, npop: int) -> Dict[str, float]:
    """FP32 operations one ray's iteration needs: npop x 4 slab tests, and a
    4-sort network per node for the sorted bodies."""
    slabs = npop * 4 * _inner_ops("B")["fp32"] // 4
    sorted_ = body not in ("nosort", "xb", "noextract", "vec", "ranksel", "rankdual",
                           "x2_only")
    return {"fp32": slabs + (npop * _inner_ops("F")["fp32"] if sorted_ else 0), "tensor": 0}


def read_bytes(tab: ProbeTables, body: str, npop: int, visited: List[torch.Tensor]) -> int:
    """Bytes of the tables one run of `body` must read, each element once:
    the rays, the 24 box floats of each node row (e + 3i) % 4096 the run
    visits and their 4 encodings (cmeta, or meta_s for full_xs and xb); vec
    reads no encoding, noextract the first of row e. `visited` is each
    iteration's e from glue_plain."""
    rays = 4 * sum(p.numel() for p in tab.planes)
    if not visited:
        return rays
    e = torch.cat(visited)
    rows = int(torch.unique(torch.cat([(e + 3 * i) % N_NODES for i in range(npop)])).numel())
    meta = {"vec": 0, "noextract": int(torch.unique(e).numel())}.get(body, 4 * rows)
    return rays + 4 * (24 * rows + meta)


def pushes(body: str, npop: int) -> int:
    """Stack stores one ray's iteration makes (trap 1: the SASS keeps one
    STL, or STS for shared stacks, per push): every child to each of the
    body's stacks."""
    stacks = {"full": 2, "nosort": 2, "rankdual": 2, "nopush1": 1, "sel1stack": 1,
              "ranksel": 1}.get(SEMANTICS.get(body, body), 0)
    return stacks * 4 * npop


def components(ns: Dict[str, float]) -> Dict[str, float]:
    """The script's differences of the bodies' ns (those it has)."""
    return {k: ns[a] - ns[b] for k, (a, b) in COMPONENTS.items() if a in ns and b in ns}


def run(device, timing=None, sms: int = 0, card: str = "",
        probes_only: bool = False) -> List[Dict]:
    """Records of every instance (probes_only: full, full_xs and xb). On the
    card: ns per iteration and per 1,024 rays at THREADS_PER_SM threads per
    SM, occupancy, SASS counts; full's local stacks also at the shared-stack
    instance's shared memory, full_xs and xb beside their global twins; then
    the components per npop and packet, as the script prints them. On the
    CPU: the plain versions at CPU_ITERS iterations, no times."""
    tab = probe_tables(device)
    bodies = PROBES_ONLY if probes_only else tuple(BODIES)
    out = []
    if timing is None:
        for npop in NPOPS:
            for body in bodies:
                for p in PACKETS:
                    r = probe(tab, body, npop, CPU_ITERS, p)
                    rec = {"instance": resolve(body, npop, p, "local", None).name,
                           "label": f"W{npop} {LABELS[body]}", "iters": CPU_ITERS,
                           "e_first": int(r["e"][0]), "e_distinct": int(r["e"].unique().numel())}
                    if p == 32:
                        rec["e_packet_1024"] = int(glue_plain(tab, body, npop, CPU_ITERS,
                                                              1024)["e"][0])
                    out.append(rec)
        return out
    n = sms * THREADS_PER_SM
    counts = sass.instance_counts("microbench_glue.cu")
    for npop in NPOPS:
        for p in PACKETS:
            ns = {}
            for body in bodies:
                insts = [i for i in glue_instances()
                         if i.body == body and i.npop == npop and i.packet == p]
                for inst in insts:
                    for smem, twin_of in timing_runs(inst, SMEM_META, STACK_BODIES,
                                                     stack_ints(npop), tab):
                        rec = timed_record(
                            timing, inst,
                            lambda k: probe(tab, body, npop, k, p, n, inst.stack, inst.meta,
                                            smem), smem, BODIES[body], n, counts, card)
                        rec.update(label=f"W{npop} {LABELS[body]}",
                                   script_line=SCRIPT_LINES[body], twin_of=twin_of,
                                   ops_per_ray_iteration=iteration_ops(body, npop))
                        out.append(rec)
                        if twin_of is None and inst == resolve(body, npop, p, "local", None):
                            ns[body] = rec["ns_per_1024_rays"]
            out.append({"components": components(ns), "npop": npop, "packet": p,
                        "unit": "ns per iteration per 1,024 rays"})
    return out

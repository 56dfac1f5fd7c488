"""Row 15k: does a warp whose lanes split the children between them beat one
rt_slab per child per ray?

Port of scripts/microbench_tiled.py: `_run` :78 (pallas_call :103) with the
bodies of its `main` :272. One iteration loads the 8 node rows (e + 37 i) %
4096 (arity 4: 32 children, child c = 4 i + k), tests each child against
the packet, takes each child's packet minimum and sums the minima in child
order into s; e = |e + 1 + (s < 0)| % 4096, acc += s. The script's variants
lay that work out in different ways on the TPU's vector unit and give the
same per-child minima; csrc/microbench_tiled.cu's mb_tiled_kernel runs each
in its H100 form, the packet being the warp (packet 32) or one ray (packet
1, the port's per-ray visit):

| body | script (line) | H100 form |
| ---- | ------------- | --------- |
| current (A) | `body_current` :139 | per ray, one rt_slab per child; a warp minimum per child |
| stacked (B) | `body_stacked` :188 | child-parallel: lane c loads child c and tests it against the warp's 32 rays (shuffled in); child c's minimum ends in lane c |
| chunk1, chunk2, chunk4 (H, F, G) | `make_body_chunked(1, 2, 4)` :233 | the same with 4, 8, 16 children a chunk: 32 / CH lanes a child, each against CH rays, a butterfly over them; 32 / CH chunks |
| current_noreduce (C) | :199 | A with one minimum over all |
| stacked_noreduce (D) | :211 | B with one minimum over all |
| construct_only (E) | :255 | B's loads and layout; s = s + p[0, 0] + p[255, 7] per plane |
| loads_only | :264 | the 8 row loads; s = s + row[0] + row[5] (packet 32: lane i loads row i) |

The rows and rays are microbench_overlap.py's (the script's `_boxes` and
`_rays`: the same seeds and construction), so the tables are row 15i's
(inner.probe_tables). `probe(tab, body, iters, packet)` launches the
instance and returns each thread's e and acc after K iterations;
`tiled_plain` is the plain version for any packet (1,024: the script's),
shared as SEMANTICS says. The wrappers run the plain version for tensors on
the CPU and launch the kernel, or raise, for tensors on the card; they count
launches in microbench.LAUNCHES ("tiled") and per instance in
microbench.INSTANCE_LAUNCHES. `run` is the `tiled` command.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .._build import load_library
from ..ops.cuda_trace import _ptr, _raise_on, _stream
from . import count_launch, fixtures, sass
from .inner import BLOCK, N_NODES, THREADS_PER_SM, Packets, ProbeTables, _check_tables, probe_tables

NPOP, ARITY = 8, 4
NCH = NPOP * ARITY
# body: (MbTiledBody code, children a chunk; 0 where the body has no chunks)
BODIES = {"loads_only": (5, 0), "current": (0, 0), "stacked": (1, 32),
          "current_noreduce": (2, 0), "stacked_noreduce": (3, 32), "construct_only": (4, 32),
          "chunk2": (1, 8), "chunk4": (1, 16), "chunk1": (1, 4)}
# The script's `_run` names (:277-293).
LABELS = {"loads_only": "loads+extracts only (8 rows)",
          "current": "A current per-child slabs + block mins",
          "stacked": "B stacked (256,128) slabs + block mins",
          "current_noreduce": "C per-child slabs, global reduce only",
          "stacked_noreduce": "D stacked slabs, global reduce only",
          "construct_only": "E plane construction only (192 splats)",
          "chunk2": "F chunked (64,128) x4 slabs + block mins",
          "chunk4": "G chunked (128,128) x2 slabs + block mins",
          "chunk1": "H chunked (32,128) x8 slabs + block mins"}
SCRIPT_LINES = {"loads_only": 264, "current": 139, "stacked": 188, "current_noreduce": 199,
                "stacked_noreduce": 211, "construct_only": 255, "chunk2": 233, "chunk4": 233,
                "chunk1": 233}
# The packets of each body's instances: the child-parallel forms are warp forms.
PACKETS = {b: ((1, 32) if b in ("current", "current_noreduce", "loads_only") else (32,))
           for b in BODIES}
# The plain version each body shares.
SEMANTICS = {"stacked": "current", "chunk1": "current", "chunk2": "current", "chunk4": "current",
             "stacked_noreduce": "current_noreduce"}
# The H100 question: each child-parallel form against A at packet 32.
CHILD_PARALLEL = ("stacked", "chunk1", "chunk2", "chunk4")


def instance(body: str, packet: int) -> str:
    return f"tiled<{body},p{packet}>"


INSTANCES = frozenset(instance(b, p) for b in BODIES for p in PACKETS[b])


def grown_tables(device) -> ProbeTables:
    """The script's tables with every box widened by fixtures.GROW: most
    warp packets hit all 32 children, so the sums are finite and e
    branches (the checks' second fixture)."""
    tab = probe_tables(device)
    return tab._replace(cbox=torch.as_tensor(fixtures.grown_boxes(tab.cbox.cpu().numpy()),
                                              device=device))


def _resolve(body: str, packet: int) -> str:
    if body not in BODIES:
        raise ValueError(f"body {body!r}: one of {sorted(BODIES)}")
    name = instance(body, packet)
    if name not in INSTANCES:
        raise ValueError(f"{name}: no such instance; built: {sorted(INSTANCES)}")
    return name


def probe(tab: ProbeTables, body: str, iters: int, packet: int,
          n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """{e, acc}: (n,) per thread after `iters` iterations of `body` at
    `packet` (thread i on ray i % n_src). CPU tables run tiled_plain."""
    name = _resolve(body, packet)
    n = tab.planes[0].numel() if n is None else n
    device = _check_tables(tab, iters, n, BLOCK)
    if device.type == "cpu":
        return tiled_plain(tab, body, iters, packet, n)
    out = {"e": torch.empty(n, dtype=torch.int32, device=device),
           "acc": torch.empty(n, dtype=torch.float32, device=device)}
    code, ch = BODIES[body]
    rc = load_library().mb_tiled(*(_ptr(p) for p in tab.planes), tab.planes[0].numel(),
                                 _ptr(tab.cbox), code, ch, packet, iters, n, _ptr(out["e"]),
                                 _ptr(out["acc"]), _stream(device))
    count_launch(name, "tiled")
    _raise_on(rc, f"mb_tiled_kernel {name}")
    return out


# ---- the plain version ------------------------------------------------------------------


def rows_of(e: torch.Tensor) -> torch.Tensor:
    """(q, 8) node rows of each packet's iteration at e."""
    return (e[:, None] + 37 * torch.arange(NPOP, device=e.device)) % N_NODES


def tiled_plain(tab: ProbeTables, body: str, iters: int, packet: int, n: Optional[int] = None,
                visited: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """e and acc of each packet of `packet` source rays after `iters`
    iterations of `body`, for n threads (thread i on ray i % n_src): the
    child minima (rt_slab, t_cut T_MAX) summed in child order, or their one
    minimum (noreduce), or the checksums of construct_only and loads_only.
    `visited`, when given, gets each iteration's e (read_bytes)."""
    pk = Packets(tab, packet)
    sem = SEMANTICS.get(body, body)
    dev = tab.cbox.device
    e = torch.zeros(pk.q, dtype=torch.int64, device=dev)
    acc = torch.zeros(pk.q, dtype=torch.float32, device=dev)
    for _ in range(iters):
        if visited is not None:
            visited.append(e)
        rows = rows_of(e)
        s = torch.zeros(pk.q, dtype=torch.float32, device=dev)
        if sem in ("current", "current_noreduce"):
            v = pk.slab(pk.boxes[rows].reshape(pk.q, NCH, 6)[pk.of_ray]).view(pk.q, packet, NCH)
            if sem == "current":
                m = v.amin(1)
                for c in range(NCH):
                    s = s + m[:, c]
            else:
                s = v.amin(dim=(1, 2))
        elif sem == "construct_only":
            first, last = pk.boxes[rows[:, 0], 0], pk.boxes[rows[:, NPOP - 1], ARITY - 1]
            for p in range(6):
                s = (s + first[:, p]) + last[:, p]
        else:
            for i in range(NPOP):
                s = (s + tab.cbox[rows[:, i], 0]) + tab.cbox[rows[:, i], 5]
        e = (e + 1 + (s < 0).long()).abs() % N_NODES
        acc = acc + s
    n = pk.n_src if n is None else n
    return {"e": pk.per_thread(e, n).to(torch.int32), "acc": pk.per_thread(acc, n)}


# ---- the bound's work -----------------------------------------------------------------------

# FP32 operations of one slab test (as inner.OPS_BOX_TEST).
OPS_BOX_TEST = 25
SLAB_BODIES = ("current", "stacked", "chunk1", "chunk2", "chunk4", "current_noreduce",
               "stacked_noreduce")


def iteration_ops(body: str) -> Dict[str, float]:
    """Operations one ray's iteration of `body` needs, by pipe: 32 slab
    tests, whatever the layout."""
    return {"fp32": NCH * OPS_BOX_TEST if body in SLAB_BODIES else 0, "tensor": 0}


def read_bytes(tab: ProbeTables, body: str, visited: List[torch.Tensor]) -> int:
    """Bytes of the tables one run of `body` must read, each element once:
    the rays if it tests them, and of each row its iterations visit, the
    elements it reads (the 24 box floats; construct_only: child 0 of the
    first row and child 3 of the last, 6 floats each; loads_only: floats 0
    and 5); `visited` is each iteration's e from tiled_plain."""
    if not visited:
        return 4 * sum(p.numel() for p in tab.planes) if body in SLAB_BODIES else 0
    rows = rows_of(torch.cat(visited))
    if body in SLAB_BODIES:
        return 4 * sum(p.numel() for p in tab.planes) + 96 * int(torch.unique(rows).numel())
    if body == "construct_only":
        pairs = torch.cat([rows[:, 0] * ARITY, rows[:, NPOP - 1] * ARITY + ARITY - 1])
        return 24 * int(torch.unique(pairs).numel())
    return 8 * int(torch.unique(rows).numel())


# ---- the tiled command ----------------------------------------------------------------------

CPU_ITERS = 3


def answers(ns: Dict[str, float]) -> Dict[str, float]:
    """The H100 question's ratios of ns per iteration per 1,024 rays: each
    child-parallel form over A at packet 32, and A at packet 32 over A at
    packet 1 (below 1: the warp packet is cheaper per ray)."""
    a32 = ns[instance("current", 32)]
    out = {f"{b}_over_current_p32": ns[instance(b, 32)] / a32 for b in CHILD_PARALLEL}
    out["current_p32_over_p1"] = a32 / ns[instance("current", 1)]
    return out


def run(device, timing=None, sms: int = 0, card: str = "") -> List[Dict]:
    """Records of every instance. On the card (`timing` given): the marginal
    ns per iteration of a grid of THREADS_PER_SM threads per SM, per 1,024
    rays, with SASS counts and the SM clock, each also as the script's
    line; then the answers. On the CPU: the plain version at CPU_ITERS
    iterations with the kernels' packets and the script's, no times."""
    tab = probe_tables(device)
    out = []
    if timing is None:
        for body in BODIES:
            for p in PACKETS[body]:
                r = probe(tab, body, CPU_ITERS, p)
                rec = {"instance": instance(body, p), "label": LABELS[body], "iters": CPU_ITERS,
                       "e_first": int(r["e"][0]), "acc_first": float(r["acc"][0]),
                       "e_distinct": int(r["e"].unique().numel())}
                if p == 32:
                    q = tiled_plain(tab, body, CPU_ITERS, 1024)
                    rec.update(e_packet_1024=int(q["e"][0]), acc_packet_1024=float(q["acc"][0]))
                out.append(rec)
        return out
    n = sms * THREADS_PER_SM
    counts = sass.instance_counts("microbench_tiled.cu")
    ns = {}
    for body in BODIES:
        for p in PACKETS[body]:
            name = instance(body, p)
            m = timing.measure(lambda k: probe(tab, body, k, p, n))
            ns[name] = m["ns"] * 1024 / n
            out.append({"instance": name, "body": body, "packet": p, "n": n,
                        "label": LABELS[body], "body_line": SCRIPT_LINES[body],
                        "ns_per_iteration": m["ns"], "ns_per_1024_rays": ns[name],
                        "script_line": f"{LABELS[body]:52s} {ns[name]:8.3f} ns/iter "
                                       f"per 1,024 rays (packet {p})",
                        "sass": counts.get(name), "ops_per_ray_iteration": iteration_ops(body),
                        "card": card, "marginal": m})
    ans = answers(ns)
    out.append({"answers": ans, "card": card, "unit": "ratio of ns per iteration per 1,024 rays",
                "script_line": "child-parallel / per-ray at packet 32: " + ", ".join(
                    f"{b} {ans[f'{b}_over_current_p32']:.3f}" for b in CHILD_PARALLEL)
                + f"; current packet 32 / packet 1: {ans['current_p32_over_p1']:.3f}"})
    return out

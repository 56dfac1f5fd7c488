"""Row 15i: what does one inner visit cost on the card, part by part?

Port of scripts/microbench_inner.py: `_run` :98 (pallas_call :108) with its
`_loop_kernel` :70 and the bodies of `main` :133. Each body runs K
data-dependent iterations (e = |e'| % 4096 after each) in
csrc/microbench_inner.cuh's mb_inner_kernel (instances in
csrc/microbench_inner.cu), at two packet sizes: `packet=1`, the port's own
inner visit (one ray a thread, its own e chain, no reduction), and
`packet=32`, the script's packet semantics with the warp as the packet
(packet minima are warp minima). The kernel's module docstring says how.

| body | script (line) | what one iteration does |
| ---- | ------------- | ----------------------- |
| A  | `body_full` :138 | row e, 4 slabs, 4 packet minima masked by the flags, meta, sort, 4 pushes |
| B  | `body_vec` :160 | row e, 4 slabs, one packet minimum over all |
| C  | `body_extract4` :173 | row e, 4 slabs, 4 packet minima, their sum |
| D  | `body_meta` :187 | the meta row's 8 ints |
| E  | `body_meta_smem` :196 | 8 ints of `meta_flat`, from shared memory |
| F  | `body_sort` :205 | one 4-sort network on values in registers |
| G  | `body_push` :212 | 8 conditional stack pushes |
| H  | `body_meta4` :220 | the meta row's 4 encodings |
| I  | `body_full_smem` :229 | A with `meta_flat` from shared memory, no flags |
| J  | `body_rowload` :250 | the row's first float |
| K  | `body_extract24` :257 | the row's 24 box floats, summed |
| N  | `body_slabconst` :267 | 4 slabs on boxes made from e (no load) |
| M  | `body_dual` :280 | A on rows e and e + 1, 8 pushes |
| M2 | `body_dual2` :338 | two independent M visits |
| M4 | `body_quad` :346 | A on rows e + 3k, k < 4, one stack |
| M8 | `body_oct` :382 | the same, k < 8 |
| Lf2, Lf4 | `_leaf_body(2 / 4)` :431 | the bf16x3 mma leaf step on 2 / 4 groups (packet 32 only) |

`probe(tab, body, iters, packet)` launches the instance and returns each
thread's e, acc and `top` (the entries at the final stack pointers, which
keep the pushes live) after K iterations; `inner_plain` is the plain
version for any packet size (1,024: the script's packet). E and I read
their table from shared memory in blocks of 1,024 threads; `meta="global"`
runs their global-memory twin at the same block size and shared memory,
`stack="shared"` runs G with its stack in shared memory. The wrappers run
the plain version for tensors on the CPU and launch the kernel, or raise,
for tensors on the card; they count launches in microbench.LAUNCHES
("inner") and per instance in microbench.INSTANCE_LAUNCHES. `run` is the
`inner` command of the entry point.

The glue probes (glue.py) share this module's kernel, tables and plain
machinery.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .._build import load_library
from ..ops.cuda_trace import _check, _ptr, _raise_on, _stream
from ..ops.intersect import EPSILON, T_MAX, clip_inv_dir
from ..ops.trace_plain import _full_f32_matmul
from ..ops.vecmath import Vec3
from . import count_launch, fixtures, sass

N_NODES = fixtures.N_NODES
# body: (MbBody code, nodes / groups)
BODIES = {"A": (0, 1), "B": (1, 1), "C": (2, 1), "D": (3, 1), "E": (4, 1), "F": (5, 1),
          "G": (6, 1), "H": (7, 1), "I": (8, 1), "J": (9, 1), "K": (10, 1), "N": (11, 1),
          "M": (12, 1), "M2": (13, 1), "M4": (14, 4), "M8": (14, 8), "Lf2": (15, 2),
          "Lf4": (15, 4)}
# The script's label of each body (its `_run` calls, :454-477).
LABELS = {"A": "A full inner visit (1 node, 4-wide)", "B": "B vector-only: 4 slabs + 1 reduce",
          "C": "C ... + 4 block-min extracts", "D": "D meta row load + 8 lane extracts",
          "E": "E meta as SMEM: 8 scalar loads", "F": "F 4-sort network on sregs",
          "G": "G 8 conditional stack pushes", "H": "H meta row load + 4 lane extracts",
          "I": "I full visit, SMEM meta, no validity", "J": "J dynamic row load only",
          "K": "K row load + 24 box extracts", "N": "N slab math on const boxes",
          "M": "M dual visit (2 nodes, production)", "M2": "M2 two independent dual visits",
          "M4": "M4 quad-pop (4 nodes, one reduction)",
          "M8": "M8 oct-pop (8 nodes, one reduction)",
          "Lf2": "Lf2 MXU leaf visit, 2 groups", "Lf4": "Lf4 MXU leaf visit, 4 groups"}
SCRIPT_LINES = {"A": 138, "B": 160, "C": 173, "D": 187, "E": 196, "F": 205, "G": 212,
                "H": 220, "I": 229, "J": 250, "K": 257, "N": 267, "M": 280, "M2": 338,
                "M4": 346, "M8": 382, "Lf2": 431, "Lf4": 431}
PACKETS = (1, 32)
LEAF_BODIES = ("Lf2", "Lf4")
# Bodies whose table lives in shared memory (blocks of 1,024), and the table.
SMEM_META = {"E": "meta_flat", "I": "meta_flat"}
# Bodies with a stack placement axis.
STACK_BODIES = ("G",)
BLOCK, BIG_BLOCK = 128, 1024
# Ints of one thread's shared stack columns (G: entries 0..7).
STACK_INTS = {"G": 8}
# Threads per SM of the timed grid (16 blocks of 128, 2 of 1,024).
THREADS_PER_SM = 2048


class ProbeTables(NamedTuple):
    planes: tuple                 # ox, oy, oz, dx, dy, dz: (n_src,) f32
    cbox: torch.Tensor            # (4096, 32) f32 node rows
    cmeta: torch.Tensor           # (4096, 8) i32
    meta_flat: torch.Tensor       # (4096 * 8,) i32
    meta_s: torch.Tensor          # (4096 * 4,) i32
    cmi: torch.Tensor             # (512 * 32, 32) bf16 [Ch | Cl]
    rmat: torch.Tensor            # (16, n_src) f32


def probe_tables(device, planes: Optional[list] = None) -> ProbeTables:
    """The scripts' fixtures on `device`; `planes` replaces their rays (the
    Lf feature rows then keep the script's 1,024 columns, tiled)."""
    planes = fixtures.overlap_rays() if planes is None else planes
    qbox, meta = fixtures.overlap_boxes()
    cmi, rmat = fixtures.lf_tables()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    n_src = np.asarray(planes[0]).size
    rmat = np.tile(rmat, (1, -(-n_src // rmat.shape[1])))[:, :n_src]
    return ProbeTables(
        tuple(t(np.asarray(p, np.float32).reshape(-1)) for p in planes), t(qbox), t(meta),
        t(fixtures.inner_meta_flat()), t(fixtures.glue_meta_s()),
        torch.from_numpy(cmi.view(np.int16)).view(torch.bfloat16).to(device), t(rmat))


# ---- instances and the launch ----------------------------------------------------


class Instance(NamedTuple):
    row: str          # "inner" (15i) or "glue" (15j)
    body: str
    npop: int         # glue's npop; inner: the body's nodes or groups
    packet: int
    stack: str        # "local" or "shared"
    meta: str         # "global" or "shared"
    block: int

    @property
    def name(self) -> str:
        b = self.body if self.row == "inner" else f"{self.body},npop{self.npop}"
        extra = ""
        if self.stack == "shared":
            extra = ",stack=shared"
        elif self.block == BIG_BLOCK:
            extra = f",meta={self.meta}"
        return f"{self.row}<{b},p{self.packet}{extra}>"


def inner_instances() -> List[Instance]:
    """Every row-15i instance built in csrc/microbench_inner.cu."""
    out = []
    for body in BODIES:
        packets = (32,) if body in LEAF_BODIES else PACKETS
        for p in packets:
            nodes = BODIES[body][1]
            if body in SMEM_META:
                out += [Instance("inner", body, nodes, p, "local", m, BIG_BLOCK)
                        for m in ("shared", "global")]
                continue
            out.append(Instance("inner", body, nodes, p, "local", "global", BLOCK))
            if body in STACK_BODIES:
                out.append(Instance("inner", body, nodes, p, "shared", "global", BLOCK))
    return out


INSTANCES = frozenset(i.name for i in inner_instances())


def table_ints(tab: ProbeTables, table: Optional[str]) -> torch.Tensor:
    return {"meta_flat": tab.meta_flat, "meta_s": tab.meta_s, None: tab.meta_flat}[table]


def smem_bytes(inst: Instance, table: Optional[str], stack_ints: int, tab: ProbeTables) -> int:
    """Dynamic shared memory an instance needs: its table when in shared
    memory, then its stack columns."""
    b = 4 * table_ints(tab, table).numel() if inst.meta == "shared" else 0
    return b + (4 * stack_ints * inst.block if inst.stack == "shared" else 0)


def _check_tables(tab: ProbeTables, iters: int, n: int, block: int):
    device = tab.cbox.device
    n_src = tab.planes[0].numel()
    if n_src % 32 or n % (32 if device.type == "cpu" else block) or iters < 0:
        raise ValueError(f"n_src={n_src}, n={n}, iters={iters}: n_src a multiple of 32, "
                         f"n of {block} (on the CPU: of 32), iters >= 0")
    for i, p in enumerate(tab.planes):
        _check(f"ray plane {i}", p, torch.float32, (n_src,), device)
    _check("cbox", tab.cbox, torch.float32, (N_NODES, 32), device)
    _check("cmeta", tab.cmeta, torch.int32, (N_NODES, 8), device)
    _check("meta_flat", tab.meta_flat, torch.int32, (N_NODES * 8,), device)
    _check("meta_s", tab.meta_s, torch.int32, (N_NODES * 4,), device)
    _check("cmi", tab.cmi, torch.bfloat16, (fixtures.LF_GROUPS * 32, 32), device)
    _check("rmat", tab.rmat, torch.float32, (16, n_src), device)
    return device


def launch(tab: ProbeTables, inst: Instance, code: int, table: Optional[str], iters: int,
           n: int, smem: int) -> Dict[str, torch.Tensor]:
    """One launch of `inst` on the card: (n,) e, acc and top."""
    device = tab.cbox.device
    out = {"e": torch.empty(n, dtype=torch.int32, device=device),
           "acc": torch.empty(n, dtype=torch.float32, device=device),
           "top": torch.empty(n, dtype=torch.int32, device=device)}
    mt = table_ints(tab, table)
    fn = load_library().mb_inner if inst.row == "inner" else load_library().mb_glue
    rc = fn(*(_ptr(p) for p in tab.planes), tab.planes[0].numel(), _ptr(tab.cbox),
            _ptr(tab.cmeta), _ptr(mt), mt.numel(), _ptr(tab.cmi), _ptr(tab.rmat), code,
            inst.npop, inst.packet, int(inst.stack == "shared"), int(inst.meta == "shared"),
            inst.block, smem, iters, n, _ptr(out["e"]), _ptr(out["acc"]), _ptr(out["top"]),
            _stream(device))
    count_launch(inst.name, inst.row)
    _raise_on(rc, f"mb_inner_kernel {inst.name}")
    return out


def occupancy(inst: Instance, code: int, smem: int) -> Dict[str, int]:
    """Resident blocks and threads per SM of an instance at `smem` bytes."""
    import ctypes
    blocks = ctypes.c_int(0)
    lib = load_library()
    fn = lib.mb_inner_occupancy if inst.row == "inner" else lib.mb_glue_occupancy
    rc = fn(code, inst.npop, inst.packet, int(inst.stack == "shared"),
            int(inst.meta == "shared"), inst.block, smem, ctypes.byref(blocks))
    _raise_on(rc, f"occupancy of {inst.name}")
    return {"blocks_per_sm": blocks.value, "threads_per_sm": blocks.value * inst.block,
            "smem_bytes": smem}


def resolve(body: str, packet: int, stack: str, meta: Optional[str]) -> Instance:
    if body not in BODIES:
        raise ValueError(f"body {body!r}: one of {sorted(BODIES)}")
    meta = meta or ("shared" if body in SMEM_META else "global")
    block = BIG_BLOCK if body in SMEM_META else BLOCK
    inst = Instance("inner", body, BODIES[body][1], packet, stack, meta, block)
    if inst.name not in INSTANCES:
        raise ValueError(f"{inst.name}: no such instance; built: {sorted(INSTANCES)}")
    return inst


def probe(tab: ProbeTables, body: str, iters: int, packet: int, n: Optional[int] = None,
          stack: str = "local", meta: Optional[str] = None,
          smem_at_least: int = 0) -> Dict[str, torch.Tensor]:
    """{e, acc, top}: (n,) per thread after `iters` iterations of `body` at
    `packet` (thread i on ray i % n_src). `meta` defaults to the script's
    placement (shared for E and I); `smem_at_least` launches with that much
    dynamic shared memory, unused past what the instance needs, to match a
    twin's occupancy. CPU tables run inner_plain."""
    inst = resolve(body, packet, stack, meta)
    n = tab.planes[0].numel() if n is None else n
    device = _check_tables(tab, iters, n, inst.block)
    if device.type == "cpu":
        return inner_plain(tab, body, iters, packet, n)
    smem = max(smem_bytes(inst, SMEM_META.get(body), STACK_INTS.get(body, 0), tab),
               smem_at_least)
    return launch(tab, inst, BODIES[body][0], SMEM_META.get(body), iters, n, smem)


# ---- the plain version: shared machinery ---------------------------------------------


class Packets:
    """The source rays in packets of `packet` consecutive rays: per-ray slab
    entries and their packet minima, as the kernels compute them (rt_slab
    with t_cut = T_MAX, each product and difference rounded)."""

    def __init__(self, tab: ProbeTables, packet: int):
        self.tab, self.packet = tab, packet
        self.n_src = tab.planes[0].numel()
        if self.n_src % packet:
            raise ValueError(f"packet {packet} does not divide {self.n_src} rays")
        self.q = self.n_src // packet
        dev = tab.cbox.device
        self.of_ray = torch.arange(self.n_src, device=dev) // packet
        o, d = Vec3(*tab.planes[:3]), Vec3(*tab.planes[3:])
        self.inv = clip_inv_dir(d)
        self.oi = Vec3(o.x * self.inv.x, o.y * self.inv.y, o.z * self.inv.z)
        self.boxes = tab.cbox[:, :24].reshape(-1, 4, 6)      # (nodes, child, [lo, hi])
        self.tmax = torch.tensor(T_MAX, dtype=torch.float32, device=dev)

    def slab(self, boxes: torch.Tensor) -> torch.Tensor:
        """(n_src, C) entry distances of per-ray boxes (n_src, C, 6)."""
        for a in range(3):
            iv, oa = self.inv[a][:, None], self.oi[a][:, None]
            t1 = boxes[..., a] * iv - oa
            t2 = boxes[..., 3 + a] * iv - oa
            lo_t, hi_t = torch.minimum(t1, t2), torch.maximum(t1, t2)
            tmin = lo_t if a == 0 else torch.maximum(tmin, lo_t)
            tmax = hi_t if a == 0 else torch.minimum(tmax, hi_t)
        ok = (tmax >= tmin) & (tmax > 0.0) & (tmin < T_MAX)
        return torch.where(ok, tmin, self.tmax)

    def slabs(self, node: torch.Tensor) -> torch.Tensor:
        """(q, packet, 4) entries of each packet's node row."""
        return self.slab(self.boxes[node][self.of_ray]).view(self.q, self.packet, 4)

    def mins(self, node: torch.Tensor) -> List[torch.Tensor]:
        """The 4 children's packet minima, (q,) each."""
        m = self.slabs(node).amin(1)
        return [m[:, k] for k in range(4)]

    def meta(self, node: torch.Tensor, k: int) -> torch.Tensor:
        return self.tab.cmeta[node, k].long()

    def per_thread(self, x: torch.Tensor, n: int, per_ray: bool = False) -> torch.Tensor:
        """Per-packet (or per-ray) values for n threads, thread i on ray
        i % n_src."""
        ray = torch.arange(n, device=x.device) % self.n_src
        return x[ray] if per_ray else x[self.of_ray][ray]


class Stack:
    """Each packet's stack of `size` ints, written as the kernel writes it."""

    def __init__(self, q: int, size: int, device):
        self.v = torch.zeros((q, size), dtype=torch.int64, device=device)
        self.rows = torch.arange(q, device=device)

    def store(self, idx: torch.Tensor, val: torch.Tensor) -> None:
        self.v[self.rows, idx] = val

    def at(self, idx: torch.Tensor) -> torch.Tensor:
        return self.v[self.rows, idx.clamp(0, self.v.shape[1] - 1)]

    def top(self, sp: torch.Tensor, base: int) -> torch.Tensor:
        """The entry below sp, or 0 when nothing was pushed (sp == base)."""
        return torch.where(sp > base, self.at(sp - 1), 0)


def sort4(ms: List[torch.Tensor], es: List[torch.Tensor]):
    """pallas_trace._sortn / rt_sort<4>: the comparator network, swapping on
    a strict >."""
    ms, es = list(ms), list(es)
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        sw = ms[i] > ms[j]
        ms[i], ms[j] = torch.where(sw, ms[j], ms[i]), torch.where(sw, ms[i], ms[j])
        es[i], es[j] = torch.where(sw, es[j], es[i]), torch.where(sw, es[i], es[j])
    return ms, es


def push4(st: Stack, sp: torch.Tensor, ms, es, tmax) -> torch.Tensor:
    """Far-to-near pushes: store at sp, bump when the child was hit."""
    for k in reversed(range(4)):
        st.store(sp, es[k])
        sp = sp + (ms[k] < tmax).long()
    return sp


def outputs(pk: Packets, n: Optional[int], e, acc, top, top_per_ray: bool = False):
    n = pk.n_src if n is None else n
    return {"e": pk.per_thread(e, n).to(torch.int32), "acc": pk.per_thread(acc, n),
            "top": pk.per_thread(top, n, top_per_ray).to(torch.int32)}


# ---- the plain version of row 15i -------------------------------------------------------


def _node(pk: Packets, e: torch.Tensor, mask: bool):
    ms = pk.mins(e)
    if mask:
        ms = [torch.where(pk.meta(e, 4 + k) > 0, ms[k], pk.tmax) for k in range(4)]
    return ms, [pk.meta(e, k) for k in range(4)]


def _one_dual(pk: Packets, e, st: Stack, sp0: int):
    e2 = (e + 1) % N_NODES
    ms1, es1 = sort4(*_node(pk, e, True))
    ms2, es2 = sort4(*_node(pk, e2, True))
    sp = torch.full_like(e, sp0)
    sp = push4(st, sp, ms2, es2, pk.tmax)
    sp = push4(st, sp, ms1, es1, pk.tmax)
    return e + sp - sp0 + es1[0], ms1[0], sp


def inner_plain(tab: ProbeTables, body: str, iters: int, packet: int,
                n: Optional[int] = None, visited: Optional[list] = None
                ) -> Dict[str, torch.Tensor]:
    """e, acc and top of each packet of `packet` source rays after `iters`
    iterations of `body`, for n threads (thread i on ray i % n_src).
    `visited`, when given, gets each iteration's e (read_bytes)."""
    if body in LEAF_BODIES:
        return leaf_plain(tab, BODIES[body][1], iters, packet, n, visited)
    pk = Packets(tab, packet)
    dev = tab.cbox.device
    e = torch.zeros(pk.q, dtype=torch.int64, device=dev)
    acc = torch.zeros(pk.q, dtype=torch.float32, device=dev)
    st = Stack(pk.q, 80, dev)
    sp = sp2 = None
    for _ in range(iters):
        if visited is not None:
            visited.append(e)
        if body in ("A", "I"):
            ms, es = sort4(*_node(pk, e, body == "A"))
            sp = push4(st, torch.full_like(e, 8), ms, es, pk.tmax)
            en, acc = e + sp + es[0], acc + ms[0]
        elif body in ("B", "N"):
            if body == "B":
                v = pk.slabs(e)
            else:
                b = e.float()[:, None] + torch.arange(4, device=dev, dtype=torch.float32)
                box = torch.stack([b + c for c in range(6)], dim=2)          # (q, 4, 6)
                v = pk.slab(box[pk.of_ray]).view(pk.q, packet, 4)
            m0 = v.amin(dim=(1, 2))
            en, acc = e + 1 + (m0 < 0).long(), acc + m0
        elif body == "C":
            ms = pk.mins(e)
            s = ((ms[0] + ms[1]) + ms[2]) + ms[3]
            en, acc = e + 1 + (s < 0).long(), acc + s
        elif body in ("D", "E", "H"):
            en = e + 1 + sum(pk.meta(e, k) for k in range(4 if body == "H" else 8))
        elif body == "F":
            ms = [acc + float(k) for k in range(4)]
            ms, es = sort4(ms, [e + k for k in range(4)])
            en, acc = es[0] + es[3], (acc + ms[0]) - ms[3]
        elif body == "G":
            sp = torch.zeros_like(e)
            for k in range(8):
                st.store(sp, e + k)
                sp = sp + ((e + k) % 2 == 0).long()
            en = e + sp
        elif body == "J":
            v = tab.cbox[e, 0]
            en, acc = e + 1 + (v < 0).long(), acc + v
        elif body == "K":
            s = torch.zeros_like(acc)
            for c in range(24):
                s = s + tab.cbox[e, c]
            en, acc = e + 1 + (s < 0).long(), acc + s
        elif body == "M":
            en, m, sp = _one_dual(pk, e, st, 8)
            en, acc = en + 8, acc + m
        elif body == "M2":
            eb = (e * 7 + 13) % N_NODES
            ea_n, ma, sp = _one_dual(pk, e, st, 8)
            eb_n, mb, sp2 = _one_dual(pk, eb, st, 64)
            en, acc = torch.remainder(ea_n + eb_n, N_NODES), (acc + ma) + mb
        else:   # M4, M8
            sp = torch.full_like(e, 8)
            e_next = torch.zeros_like(e)
            m_acc = torch.zeros_like(acc)
            for k in range(BODIES[body][1]):
                ms, es = sort4(*_node(pk, (e + 3 * k) % N_NODES, True))
                sp = push4(st, sp, ms, es, pk.tmax)
                e_next = e_next + es[0]
                m_acc = m_acc + ms[0]
            en, acc = torch.remainder(e + e_next + sp, N_NODES), acc + m_acc
        e = en.abs() % N_NODES
    top = torch.zeros_like(e)
    if iters and body == "G":
        top = st.top(sp, 0)
    elif iters and body == "M2":
        top = st.top(sp, 8) + st.top(sp2, 64)
    elif iters and body in ("A", "I", "M", "M4", "M8"):
        top = st.top(sp, 8)
    return outputs(pk, n, e, acc, top)


def leaf_plain(tab: ProbeTables, ngroups: int, iters: int, packet: int,
               n: Optional[int] = None, visited: Optional[list] = None
               ) -> Dict[str, torch.Tensor]:
    """`_leaf_body(ngroups)`: each iteration the packet's feature rows
    rmat + e * 1e-9 are split into bf16 halves and multiplied with the C
    rows of groups (e + 5k) % 512, k < ngroups, as Ch.Rh + Ch.Rl + Cl.Rh in
    f32; each ray keeps its winner (smallest t, smallest j on ties, strict <
    across groups); e' = e + 1 + (min t < 0) + the packet's first ray's
    winner slot, acc + min t. `top` is each ray's last winner slot."""
    pk = Packets(tab, packet)
    dev = tab.cbox.device
    G = fixtures.LF_GROUPS
    e = torch.zeros(pk.q, dtype=torch.int64, device=dev)
    acc = torch.zeros(pk.q, dtype=torch.float32, device=dev)
    idx = torch.full((pk.n_src,), -1, dtype=torch.int64, device=dev)
    rows = tab.cmi.float().reshape(G, 32, 32)
    eps = float(np.float32(EPSILON))
    with _full_f32_matmul() if dev.type == "cuda" else nullcontext():
        for _ in range(iters):
            if visited is not None:
                visited.append(e)
            nudge = e.float() * torch.tensor(1e-9, dtype=torch.float32, device=dev)
            rf = tab.rmat.t() + nudge[pk.of_ray][:, None]                 # (n_src, 16)
            rh = rf.bfloat16()
            rl = (rf - rh.float()).bfloat16()
            rh, rl = rh.float(), rl.float()
            t = torch.full((pk.n_src,), T_MAX, dtype=torch.float32, device=dev)
            idx = torch.full((pk.n_src,), -1, dtype=torch.int64, device=dev)
            for k in range(ngroups):
                g = ((e + 5 * k) % G)[pk.of_ray]
                c = rows[g]                                               # (n_src, 32, 32)
                ch, cl = c[..., :16], c[..., 16:]
                q = (torch.einsum("nrk,nk->nr", ch, rh) + torch.einsum("nrk,nk->nr", ch, rl)) \
                    + torch.einsum("nrk,nk->nr", cl, rh)
                det, tn, un, vn = q[:, 0:8], q[:, 8:16], q[:, 16:24], q[:, 24:32]
                invdet = 1.0 / det
                tt, u, v = tn * invdet, un * invdet, vn * invdet
                hit = (det.abs() >= eps) & (tt > eps) & (u >= 0.0) & (v >= 0.0) & ((u + v) <= 1.0)
                tmin, jmin = torch.where(hit, tt, torch.full_like(tt, T_MAX)).min(dim=1)
                better = tmin < t
                t = torch.where(better, tmin, t)
                idx = torch.where(better, g * 8 + jmin, idx)
            m0 = t.view(pk.q, packet).amin(1)
            first = idx.view(pk.q, packet)[:, 0]
            en = e + 1 + (m0 < 0).long() + first
            acc = acc + m0
            e = en.abs() % N_NODES
    return outputs(pk, n, e, acc, idx, top_per_ray=True)


# ---- the inner command -------------------------------------------------------------------

CPU_ITERS = 3
# FP32 operations one ray's iteration needs (slab tests of 25, 4-sort
# networks of 5 compare-exchanges of 5 operations), and the leaf step's
# epilogue (14 per triangle test) and tensor-core products (K = 16 live
# features here: bf16x3, 3 x 2 x 32 x 16 per group).
OPS_BOX_TEST = 25
OPS_SORT4 = 25
OPS_LEAF_EPILOGUE = 14
MMA_OPS_PER_GROUP = 3 * 2 * 32 * 16
SLABS = {"A": 4, "B": 4, "C": 4, "I": 4, "N": 4, "M": 8, "M2": 16, "M4": 16, "M8": 32}
SORTS = {"A": 1, "F": 1, "I": 1, "M": 2, "M2": 4, "M4": 4, "M8": 8}


def iteration_ops(body: str) -> Dict[str, float]:
    """Operations one ray's iteration of `body` needs, by pipe."""
    if body in LEAF_BODIES:
        g = BODIES[body][1]
        return {"fp32": g * 8 * OPS_LEAF_EPILOGUE, "tensor": g * MMA_OPS_PER_GROUP}
    return {"fp32": SLABS.get(body, 0) * OPS_BOX_TEST + SORTS.get(body, 0) * OPS_SORT4,
            "tensor": 0}


# The 4-byte elements of each table one visit of a node row reads (F and
# G read no table, N only the rays), and the bodies that read the rays.
ROW_READS = {"A": {"cbox": 24, "cmeta": 8}, "B": {"cbox": 24}, "C": {"cbox": 24},
             "D": {"cmeta": 8}, "E": {"meta_flat": 8}, "H": {"cmeta": 4},
             "I": {"cbox": 24, "meta_flat": 4}, "J": {"cbox": 1}, "K": {"cbox": 24},
             **{b: {"cbox": 24, "cmeta": 8} for b in ("M", "M2", "M4", "M8")}}
READS_RAYS = ("A", "B", "C", "I", "N", "M", "M2", "M4", "M8")
# Bytes of one group's C rows in cmi.
GROUP_BYTES = 32 * 32 * 2


def _rows(body: str, e: torch.Tensor) -> torch.Tensor:
    """The node rows (or Lf's groups) the iterations at `e` read."""
    if body in LEAF_BODIES:
        return torch.cat([(e + 5 * k) % fixtures.LF_GROUPS for k in range(BODIES[body][1])])
    if body == "M":
        return torch.cat([e, (e + 1) % N_NODES])
    if body == "M2":
        eb = (e * 7 + 13) % N_NODES
        return torch.cat([e, (e + 1) % N_NODES, eb, (eb + 1) % N_NODES])
    if body in ("M4", "M8"):
        return torch.cat([(e + 3 * k) % N_NODES for k in range(BODIES[body][1])])
    return e


def read_bytes(tab: ProbeTables, body: str, visited: List[torch.Tensor]) -> int:
    """Bytes of the tables one run of `body` must read, each element once:
    the rays (Lf: all of rmat) and the elements it reads of each node row
    (Lf: each group's C rows) that the run visits; `visited` is each
    iteration's e from inner_plain."""
    distinct = int(torch.unique(_rows(body, torch.cat(visited))).numel()) if visited else 0
    if body in LEAF_BODIES:
        return distinct * GROUP_BYTES + 4 * tab.rmat.numel()
    rays = 4 * sum(p.numel() for p in tab.planes) if body in READS_RAYS else 0
    return rays + 4 * distinct * sum(ROW_READS.get(body, {}).values())


# Stack stores one ray's iteration makes (trap 1: the SASS keeps one STL,
# or STS for a shared stack, per push).
PUSHES = {"A": 4, "I": 4, "G": 8, "M": 8, "M2": 16, "M4": 16, "M8": 32}


def timing_runs(inst: Instance, smem_meta: Dict[str, str], stack_bodies, stack_ints_: int,
                tab: ProbeTables):
    """(dynamic shared memory, twin_of) of each timed launch of `inst`: its
    own; a global-memory twin at its shared-memory instance's bytes; and a
    local stack also at its shared-stack instance's bytes, so that each pair
    differs in the memory space and not in occupancy."""
    table = smem_meta.get(inst.body)
    if inst.meta == "global" and table:
        return [(smem_bytes(inst._replace(meta="shared"), table, 0, tab), "meta=shared")]
    runs = [(smem_bytes(inst, table, stack_ints_, tab), None)]
    if inst.body in stack_bodies and inst.stack == "local":
        runs.append((smem_bytes(inst._replace(stack="shared"), None, stack_ints_, tab),
                     "stack=shared"))
    return runs


def timed_record(timing, inst: Instance, launch_k, smem: int, code: int, n: int,
                 sass_counts: Dict, card: str) -> Dict:
    """Time one instance: its marginal ns per iteration of the grid, ns per
    iteration per 1,024 rays, its occupancy and its SASS counts."""
    m = timing.measure(launch_k)
    return {"instance": inst.name, "row": inst.row, "body": inst.body, "npop": inst.npop,
            "packet": inst.packet, "stack": inst.stack, "meta": inst.meta, "block": inst.block,
            "n": n, **occupancy(inst, code, smem), "ns_per_iteration": m["ns"],
            "ns_per_1024_rays": m["ns"] * 1024 / n, "sass": sass_counts.get(inst.name),
            "card": card, "marginal": m}


def run(device, timing=None, sms: int = 0, card: str = "") -> List[Dict]:
    """Records of every instance. On the card (`timing` given): the marginal
    ns per iteration of a grid of THREADS_PER_SM threads per SM, per 1,024
    rays, with occupancy, SASS counts and the SM clock; the shared-memory
    instances beside their twins at the same shared memory. On the CPU: the
    plain version at CPU_ITERS iterations with the kernels' packets and the
    script's, no times."""
    tab = probe_tables(device)
    out = []
    if timing is None:
        for inst in inner_instances():
            if inst.meta == "global" and inst.block == BIG_BLOCK or inst.stack == "shared":
                continue
            r = probe(tab, inst.body, CPU_ITERS, inst.packet)
            rec = {"instance": inst.name, "label": LABELS[inst.body], "iters": CPU_ITERS,
                   "e_first": int(r["e"][0]), "acc_first": float(r["acc"][0]),
                   "e_distinct": int(r["e"].unique().numel())}
            if inst.packet == 32:
                p = inner_plain(tab, inst.body, CPU_ITERS, 1024)
                rec.update(e_packet_1024=int(p["e"][0]), acc_packet_1024=float(p["acc"][0]))
            out.append(rec)
        return out
    n = sms * THREADS_PER_SM
    counts = sass.instance_counts("microbench_inner.cu")
    for inst in inner_instances():
        body = inst.body
        for smem, twin_of in timing_runs(inst, SMEM_META, STACK_BODIES,
                                         STACK_INTS.get(body, 0), tab):
            rec = timed_record(
                timing, inst, lambda k: probe(tab, body, k, inst.packet, n, inst.stack,
                                              inst.meta, smem),
                smem, BODIES[body][0], n, counts, card)
            rec.update(label=LABELS[body], script_line=SCRIPT_LINES[body], twin_of=twin_of,
                       ops_per_ray_iteration=iteration_ops(body))
            out.append(rec)
    return out

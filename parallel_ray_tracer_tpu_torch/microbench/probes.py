"""Kernels B and C (rows 15b, 15c): where a leaf group's rows can live.

B ports `probe_pad` (scripts/microbench_mxu_leaf.py:513, pallas_call :523):
the TPU padded an (N, 16) VMEM input to 128 lanes, 8x its bytes. The card's
counterpart of a block's VMEM is shared memory, which does not pad: a
group's 32 C rows take 2 KB as (32, 16) f32 or as (32, 32) bf16 [hi | lo]
(GROUP_BYTES). `stage_table` stages a table in one block's dynamic shared
memory and reads it back (csrc/microbench_probes.cu mb_stage_kernel); its
plain version is the table itself. `stage_sweep` asks how many groups fit:
it stages tables of a sweep of sizes past the card's opt-in limit and
records, per size, the cudaError of cudaFuncSetAttribute and of the launch.
Past the limit both are refused; that is the probe's reading, not a
fallback (stage_table raises on it).

C ports `probe_ceiling` (:544, pallas_call :554), the TPU's resident
ceiling. On the card it is the L2's: `gather` chases n_warps chains of
dependent 2 KB blocks (the streamed leaf block) through a table of random
words whose word 0 links the blocks in one random cycle
(mb_gather_kernel), and returns each warp's last block and the wrapping
32-bit sum of the words it read; `gather_plain` follows the same chains.
Its marginal cost per step over table sizes of 4-256 MB shows where the
table stops fitting the 50 MB L2.
"""

from __future__ import annotations

import ctypes
import statistics
from typing import Dict, List, Optional, Tuple

import torch

from .._build import error_string, load_library
from ..ops.cuda_trace import _ptr, _raise_on, _stream
from . import LAUNCHES

# Bytes of one leaf group's 32 C rows in each layout (ops/pack.py), and of
# the streamed leaf block (RT_STREAM_BLK tri rows).
GROUP_BYTES = {"f32 (32, 16)": 32 * 16 * 4, "bf16 [hi | lo] (32, 32)": 32 * 32 * 2,
               "bf16 hi only (32, 16)": 32 * 16 * 2, "four-group rows (8, 128) bf16": 8 * 128 * 2}
BLOCK_BYTES = 2048
BLOCK_WORDS = BLOCK_BYTES // 4
# Group counts of the staging sweep (2 KB a group), past 232,448 bytes, the
# H100's opt-in limit; the sweep adds the limit itself and one 64-byte row
# past it. Table sizes of the gather sweep (MiB).
STAGE_GROUPS = (1, 8, 16, 23, 24, 25, 32, 64, 96, 112, 113, 114, 128)
GATHER_MB = (4, 8, 16, 24, 32, 40, 48, 56, 64, 96, 128, 192, 256)


def smem_optin() -> int:
    """The card's opt-in limit of dynamic shared memory per block (bytes)."""
    v = ctypes.c_int(0)
    _raise_on(load_library().mb_smem_optin(ctypes.byref(v)), "mb_smem_optin")
    return v.value


def _check_table(t: torch.Tensor) -> int:
    if not isinstance(t, torch.Tensor) or not t.is_contiguous():
        raise ValueError("table: a contiguous tensor")
    nb = t.numel() * t.element_size()
    if nb % 16 or nb == 0:
        raise ValueError(f"table: {nb} bytes, a positive multiple of 16")
    return nb


def _stage_launch(table: torch.Tensor) -> Tuple[int, int, torch.Tensor]:
    nb = _check_table(table)
    out = torch.empty_like(table)
    attr = ctypes.c_int(0)
    rc = load_library().mb_stage(_ptr(table), nb, _ptr(out), ctypes.byref(attr),
                                 _stream(table.device))
    if rc == 0:
        LAUNCHES["stage"] += 1
    return attr.value, rc, out


def stage_table(table: torch.Tensor) -> torch.Tensor:
    """The table, staged in one block's shared memory and read back. A
    CPU table returns its plain version (a copy); on the card a launch the
    card refuses raises."""
    if table.device.type == "cpu":
        _check_table(table)
        return table.clone()
    attr, rc, out = _stage_launch(table)
    _raise_on(attr, "cudaFuncSetAttribute(mb_stage_kernel)")
    _raise_on(rc, "mb_stage_kernel")
    return out


def group_table(groups: int, layout: str, device, extra_bytes: int = 0) -> torch.Tensor:
    """Random C rows of `groups` leaf groups as (N, 16) f32 or (N, 32) bf16
    (the same bytes), with `extra_bytes` (a multiple of 64) more rows."""
    rows = groups * 32 + extra_bytes // 64
    g = torch.Generator(device="cpu").manual_seed(groups)
    bits = torch.randint(-(1 << 15), 1 << 15, (rows, 32), generator=g, dtype=torch.int32)
    t = bits.to(torch.int16).view(torch.bfloat16)
    return (t if layout == "bf16" else t.view(torch.float32)).to(device)


def stage_sweep(device, optin: int) -> List[Dict]:
    """Per size of the sweep (STAGE_GROUPS, the limit, one row past it),
    per layout: the cudaError of cudaFuncSetAttribute and of the launch,
    and whether the staged table came back whole."""
    sizes = [(g, 0) for g in STAGE_GROUPS]
    sizes += [(optin // BLOCK_BYTES, optin % BLOCK_BYTES),
              (optin // BLOCK_BYTES, optin % BLOCK_BYTES + 64)]
    out = []
    for groups, extra in sizes:
        for layout in ("f32", "bf16"):
            tab = group_table(groups, layout, device, extra)
            nb = tab.numel() * tab.element_size()
            if device.type == "cpu":
                attr, rc, back = 0, 0, stage_table(tab)
            else:
                attr, rc, back = _stage_launch(tab)
                torch.cuda.synchronize()
            out.append({"bytes": nb, "groups": nb / BLOCK_BYTES, "layout": layout,
                        "attr_rc": attr, "launch_rc": rc,
                        "error": None if rc == 0 else error_string(rc),
                        "read_back_equal": bool(rc == 0 and torch.equal(
                            back.view(torch.int16), tab.view(torch.int16)))})
    return out


# ---- C: the L2 residency ceiling ---------------------------------------------

def gather_table(mb: float, device, seed: int = 0) -> torch.Tensor:
    """(blocks, 512) int32 of random words on `device`, mb MiB; word 0 of
    block b is the next block of one random cycle through all blocks."""
    nb = int(mb * (1 << 20)) // BLOCK_BYTES
    g = torch.Generator(device=device).manual_seed(seed)
    words = torch.randint(-(1 << 31), (1 << 31) - 1, (nb, BLOCK_WORDS), generator=g,
                          dtype=torch.int32, device=device)
    order = torch.randperm(nb, generator=g, device=device)
    nxt = torch.empty(nb, dtype=torch.int32, device=device)
    nxt[order] = order.roll(-1).to(torch.int32)
    words[:, 0] = nxt
    return words


def gather_starts(nblocks: int, n_warps: int, device) -> torch.Tensor:
    """Each warp's first block, spread evenly over the table."""
    w = torch.arange(n_warps, dtype=torch.int64, device=device)
    return (w * nblocks // n_warps).to(torch.int32)


def _check_gather(table: torch.Tensor, starts: torch.Tensor, steps: int):
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != BLOCK_WORDS \
            or not table.is_contiguous():
        raise ValueError(f"table: contiguous int32 (blocks, {BLOCK_WORDS})")
    if starts.dtype != torch.int32 or starts.dim() != 1 or starts.device != table.device:
        raise ValueError("starts: int32 (n_warps,) on the table's device")
    if steps < 0:
        raise ValueError(f"steps={steps}")


def gather(table: torch.Tensor, starts: torch.Tensor, steps: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(last block, word sum as int32 bits) of each warp's chain of `steps`
    blocks from starts[w]. A CPU table runs gather_plain."""
    _check_gather(table, starts, steps)
    if table.device.type == "cpu":
        return gather_plain(table, starts, steps)
    n_warps = starts.numel()
    last = torch.empty(n_warps, dtype=torch.int32, device=table.device)
    sums = torch.empty(n_warps, dtype=torch.int32, device=table.device)
    rc = load_library().mb_gather(_ptr(table), steps, n_warps, _ptr(starts), _ptr(last),
                                  _ptr(sums), _stream(table.device))
    LAUNCHES["gather"] += 1
    _raise_on(rc, "mb_gather_kernel")
    return last, sums


def gather_plain(table: torch.Tensor, starts: torch.Tensor, steps: int,
                 visited: Optional[List[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chains followed block by block; the sums in int64, wrapped to 32
    bits. With `visited`, each step's blocks are appended to it."""
    nxt = table[:, 0].long()
    block_sum = table.long().sum(dim=1)
    b = starts.long()
    s = torch.zeros_like(b)
    for _ in range(steps):
        if visited is not None:
            visited.append(b)
        s = s + block_sum[b]
        b = nxt[b]
    s = s & 0xFFFFFFFF
    s = torch.where(s >= 1 << 31, s - (1 << 32), s)
    return b.to(torch.int32), s.to(torch.int32)


# ---- the probes subcommand -----------------------------------------------------

H100_OPTIN = 232448     # the sweep's sizes on the CPU, where no card reports it
CPU_GATHER = dict(mb=1, n_warps=64, steps=2)


def run(device, timing=None, n_warps: int = 0) -> List[Dict]:
    """Records of both probes. On the card (`timing` given): the staging
    sweep against the card's limit, the time to stage the largest table
    that fits, and the gather's marginal ns per step over GATHER_MB with
    n_warps chains. On the CPU: the sweep's sizes against the H100's
    documented limit through the plain version, and one small gather, with
    no times."""
    cpu = timing is None
    optin = H100_OPTIN if cpu else smem_optin()
    sweep = stage_sweep(device, optin)
    rec = {"probe": "stage", "optin_bytes": "not measured" if cpu else optin,
           "group_bytes": GROUP_BYTES,
           "groups_per_block": "not measured" if cpu else {
               k: optin // v for k, v in GROUP_BYTES.items()},
           "sweep": sweep}
    if not cpu:
        big = group_table(optin // BLOCK_BYTES, "bf16", device)
        stage_table(big)                                 # warm-up
        ms = sorted(timing.launch_ms(lambda _: stage_table(big), 0)
                    for _ in range(timing.REPS))
        rec["largest_fitting"] = {"bytes": big.numel() * 2, "ms": {
            "median": statistics.median(ms), "min": ms[0], "max": ms[-1], "runs": len(ms)}}
    out = [rec]
    sizes = [CPU_GATHER["mb"]] if cpu else GATHER_MB
    for mb in sizes:
        table = gather_table(mb, device)
        w = CPU_GATHER["n_warps"] if cpu else n_warps
        starts = gather_starts(table.shape[0], w, device)
        r = {"probe": "gather", "table_mb": mb, "blocks": table.shape[0], "n_warps": w}
        if cpu:
            last, sums = gather(table, starts, CPU_GATHER["steps"])
            r.update(steps=CPU_GATHER["steps"], last_sum=int(last.long().sum()),
                     word_sum=int(sums.long().sum()))
        else:
            m = timing.measure(lambda k: gather(table, starts, k))
            r.update(ns_per_step=m["ns"], ns_per_block=m["ns"] / w,
                     gb_per_s=w * BLOCK_BYTES / m["ns"], marginal=m)
        out.append(r)
        del table
    return out

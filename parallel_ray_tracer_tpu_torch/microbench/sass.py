"""SASS instruction counts of the probe kernels, from the built objects.

The probes' K loops are not unrolled (`#pragma unroll 1`), so the stores,
loads and branches of one iteration are those of the kernel function, bar
the stores of the outputs (STG) and the loads before the loop. `cuobjdump
-sass` of a unit's object (kept by _build.py beside the library) gives
each kernel's instructions; `instance_counts` names each kernel by its
instance (inner.py, glue.py, cond.py, tiled.py, mxu_inner.py) and counts,
per kernel, the local-memory stores and loads (STL, LDL: a stack in local
memory), the shared-memory stores and loads (STS, LDS), the branches (BRA,
BRX) and all instructions. Where the toolkit has no cuobjdump, the counts
are {} (chip_smoke.py's microbench phase then fails: it requires them).
"""

from __future__ import annotations

import os
import re
import subprocess
from collections import Counter
from typing import Dict, List, Tuple

from .. import _build

OPS = ("STL", "LDL", "STS", "LDS", "BRA", "BRX")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
_ARGS = re.compile(r"L([ib])(n?)(\d+)E")


def parse(text: str) -> Dict[str, Counter]:
    """Opcode counts of each function in `cuobjdump -sass` output."""
    out: Dict[str, Counter] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), Counter())
            continue
        if cur is not None:
            m = _INSN.search(line)
            if m:
                cur[m.group(1)] += 1
    return out


def template_args(mangled: str) -> Tuple[int, ...]:
    """The integer and bool template arguments of a mangled kernel name."""
    return tuple((-1 if neg else 1) * int(v) for _, neg, v in _ARGS.findall(mangled))


def kernel_counts(unit: str) -> Dict[str, Counter]:
    """{mangled kernel name: opcode counts} of one unit's object, or {}."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    obj = _build.object_path(unit)
    if not (os.path.isfile(tool) and os.path.isfile(obj)):
        return {}
    proc = subprocess.run([tool, "-sass", obj], capture_output=True, text=True, timeout=300)
    return parse(proc.stdout) if proc.returncode == 0 else {}


def summary(c: Counter) -> Dict[str, int]:
    return {**{k: c.get(k, 0) for k in OPS}, "instructions": sum(c.values())}


def instance_counts(unit: str) -> Dict[str, Dict[str, int]]:
    """{instance name: the OPS counts and the instruction count} of the
    kernels of csrc/microbench_{inner,glue,cond,tiled,mxu_inner}.cu."""
    from . import cond, glue, inner, mxu_inner, tiled

    names: Dict[Tuple, str] = {}
    insts: List = inner.inner_instances() + glue.glue_instances()
    for i in insts:
        code = inner.BODIES[i.body][0] if i.row == "inner" else glue.BODIES[i.body]
        names[("mb_inner_kernel", code, i.npop, i.packet, int(i.stack == "shared"),
               int(i.meta == "shared"), i.block)] = i.name
    for shape, code in cond.SHAPES.items():
        for uniform in (False, True):
            names[("mb_cond_kernel", code, int(uniform))] = cond.instance(shape, uniform)
    for body, (code, ch) in tiled.BODIES.items():
        for p in tiled.PACKETS[body]:
            names[("mb_tiled_kernel", code, ch, p)] = tiled.instance(body, p)
    for body, (code, arity, npop) in mxu_inner.BODIES.items():
        for p in mxu_inner.PACKETS[body]:
            names[("mb_mxu_inner_kernel", code, arity, npop, p)] = mxu_inner.instance(body, p)
    out = {}
    for mangled, c in kernel_counts(unit).items():
        m = re.match(r"_Z\d+(mb_\w+?_kernel)I", mangled)
        if m:
            key = (m.group(1),) + template_args(mangled[m.end() - 1:])
            if key in names:
                out[names[key]] = summary(c)
    return out

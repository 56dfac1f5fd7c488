"""Row 15l: what does a data-dependent branch cost per loop iteration?

Port of scripts/microbench_cond.py: `_bench` :42 (pallas_call :54) with the
step shapes of its `main` :88 around `_body` :80 (8 rounds of a =
min(a * 1.0001 + 0.1, max(a, 0.5)) on an (8, 128) tile, then e = e + 1 +
(a[0, 0] < 0)); e = |e| % 1024 after each step:

| shape | script | the step |
| ----- | ------ | -------- |
| straight | `s0` :92 | the body |
| cond1 | `s1` :95 | if (e % 2 == 0) body else body |
| cond2_nested | `s2` :98 | two nested ifs (e % 2, e % 3), four bodies |
| switch4 | `sw` :103 | a switch over (e % 2) * 2 + (e % 3 == 0), four bodies |

csrc/microbench_cond.cu's mb_cond_kernel runs each shape with a warp
holding the tile (lane l its elements [32 l, 32 l + 32)), in two cases:
per thread (each thread's e follows its own first element: the branch
diverges) and warp-uniform (e follows the tile's a[0, 0], lane 0's first
element, as the script's e). Every arm computes the same values, so every
shape's plain version is the straight one; the kernel keeps the arms
apart (its docstring). `cond(a, shape, uniform, iters, n)` returns each
thread's e and the maximum of its elements after K steps; `cond_plain` is
its plain version. `run` is the `cond` command; it prints the script's
`cond_cost_ns`, `nested_extra_ns` and `switch_vs_nested_ns` per case.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .._build import load_library
from ..ops.cuda_trace import _check, _ptr, _raise_on, _stream
from . import count_launch, fixtures, sass

SHAPES = {"straight": 0, "cond1": 1, "cond2_nested": 2, "switch4": 3}
SCRIPT_LINES = {"straight": 92, "cond1": 95, "cond2_nested": 98, "switch4": 103}
N_E = 1024                  # e = |e| % 1024
W = 32                      # elements a thread holds
BLOCK = 128
# The body's constants (mul, add, lo) as f32, given to every arm.
MUL, ADD, LO = np.float32(1.0001), np.float32(0.1), np.float32(0.5)
# Operations of one body per element: 8 rounds of a multiply, an add, a max
# and a min.
OPS_PER_ELEMENT = 8 * 4
THREADS_PER_SM = 2048


def instance(shape: str, uniform: bool) -> str:
    return f"cond<{shape},{'uniform' if uniform else 'per_thread'}>"


INSTANCES = frozenset(instance(s, u) for s in SHAPES for u in (False, True))


def tile(device) -> torch.Tensor:
    """The script's (8, 128) tile, flattened to (1,024,)."""
    return torch.from_numpy(fixtures.cond_tile().reshape(-1)).to(device)


def _consts(device) -> torch.Tensor:
    return torch.tensor([MUL] * 4 + [ADD] * 4 + [LO] * 4, dtype=torch.float32, device=device)


def cond_plain(a: torch.Tensor, uniform: bool, iters: int,
               n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """e and each thread's maximum after `iters` steps, thread i on lane
    i % 32 of a warp holding the tile; every shape computes this."""
    x = a.reshape(32, W).clone()
    e = torch.zeros(1 if uniform else 32, dtype=torch.int64, device=a.device)
    mul, add, lo = (torch.tensor(v, dtype=torch.float32, device=a.device) for v in (MUL, ADD, LO))
    for _ in range(iters):
        for _ in range(8):
            x = torch.minimum(x * mul + add, torch.maximum(x, lo))
        a00 = x[0, 0] if uniform else x[:, 0]
        e = (e + 1 + (a00 < 0).long()).abs() % N_E
    n = 32 if n is None else n
    lane = torch.arange(n, device=a.device) % 32
    return {"e": e.expand(32)[lane].to(torch.int32), "max": x.amax(1)[lane]}


def script_output(r: Dict[str, torch.Tensor]) -> float:
    """The script's out[0, 0] (warp-uniform case): the tile's maximum + e."""
    return float(np.float32(r["max"][:32].max().item()) + np.float32(r["e"][0].item()))


def cond(a: torch.Tensor, shape: str, uniform: bool, iters: int,
         n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """{e, max}: (n,) per thread after `iters` steps of `shape`. A CPU tile
    runs cond_plain."""
    if shape not in SHAPES:
        raise ValueError(f"shape {shape!r}: one of {sorted(SHAPES)}")
    n = 32 if n is None else n
    if n % BLOCK and a.device.type != "cpu" or n % 32 or iters < 0:
        raise ValueError(f"n={n}, iters={iters}: n a multiple of {BLOCK}, iters >= 0")
    _check("a", a, torch.float32, (32 * W,), a.device)
    if a.device.type == "cpu":
        return cond_plain(a, uniform, iters, n)
    out = {"e": torch.empty(n, dtype=torch.int32, device=a.device),
           "max": torch.empty(n, dtype=torch.float32, device=a.device)}
    consts = _consts("cpu")     # host memory: mb_cond copies it into the kernel's argument
    rc = load_library().mb_cond(_ptr(a), _ptr(consts), SHAPES[shape], int(uniform), iters, n,
                                _ptr(out["e"]), _ptr(out["max"]), _stream(a.device))
    name = instance(shape, uniform)
    count_launch(name, "cond")
    _raise_on(rc, f"mb_cond_kernel {name}")
    return out


# ---- the cond command ----------------------------------------------------------------

CPU_ITERS = 3


def costs(ns: Dict[str, float]) -> Dict[str, float]:
    """The script's three differences (:112-114)."""
    return {"cond_cost_ns": ns["cond1"] - ns["straight"],
            "nested_extra_ns": ns["cond2_nested"] - ns["cond1"],
            "switch_vs_nested_ns": ns["switch4"] - ns["cond2_nested"]}


def run(device, timing=None, sms: int = 0, card: str = "") -> List[Dict]:
    """Records of each shape in each case. On the card: the marginal ns per
    step of a grid of THREADS_PER_SM threads per SM, per warp-tile (ns per
    step per 1,024 elements), SASS counts, and the script's differences per
    case. On the CPU: the plain version at CPU_ITERS steps, no times."""
    a = tile(device)
    out = []
    if timing is None:
        for uniform in (False, True):
            r = cond(a, "straight", uniform, CPU_ITERS)
            out.append({"case": "uniform" if uniform else "per_thread", "iters": CPU_ITERS,
                        "e": r["e"].tolist(), "script_output": script_output(r)})
        return out
    n = sms * THREADS_PER_SM
    counts = sass.instance_counts("microbench_cond.cu")
    for uniform in (False, True):
        ns = {}
        for shape in SHAPES:
            m = timing.measure(lambda k: cond(a, shape, uniform, k, n))
            name = instance(shape, uniform)
            ns[shape] = m["ns"] * 32 / n
            out.append({"instance": name, "shape": shape, "uniform": uniform, "n": n,
                        "ns_per_iteration": m["ns"], "ns_per_1024_elements": ns[shape],
                        "script_line": SCRIPT_LINES[shape], "sass": counts.get(name),
                        "card": card, "marginal": m})
        out.append({"case": "uniform" if uniform else "per_thread", **costs(ns),
                    "unit": "ns per step per warp tile of 1,024 elements"})
    return out

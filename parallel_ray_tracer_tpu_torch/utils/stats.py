"""Copy of parallel_ray_tracer_tpu/utils/stats.py (standard library only).

Frame-time statistics: mean / median / stddev / 99% CI / FPS, with the
reference harness math (cpu/src/main.c:45-88, :194-209): population stddev
(divide by N), z = 2.5758293035489004 for the 99% CI.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

Z_99 = 2.5758293035489004  # cpu/src/main.c:83


def summarize(times_ms: Sequence[float]) -> Dict[str, float]:
    n = len(times_ms)
    if n == 0:
        return {}
    mean = sum(times_ms) / n
    sorted_t = sorted(times_ms)
    if n % 2 == 0:
        median = (sorted_t[n // 2 - 1] + sorted_t[n // 2]) / 2.0
    else:
        median = sorted_t[n // 2]
    stddev = math.sqrt(sum((t - mean) ** 2 for t in times_ms) / n)
    ci = Z_99 * stddev / math.sqrt(n)
    return {
        "iterations": n,
        "total_ms": mean * n,
        "mean_ms": mean,
        "median_ms": median,
        "stddev_ms": stddev,
        "ci99_ms": ci,
        "fps": 1000.0 / mean if mean > 0 else float("inf"),
    }


def format_summary(stats: Dict[str, float]) -> str:
    """The reference's metrics banner (cpu/src/main.c:199-209)."""
    lines = ["\n# Metrics #"]
    lines.append(
        "Total execution time of %d frames: %.3f ms"
        % (stats["iterations"], stats["total_ms"])
    )
    if stats["iterations"] >= 30:
        lines.append(
            "Frame time (mean +/- 99%% CI): %.3f +/- %.3f = [%.3f, %.3f] ms"
            % (
                stats["mean_ms"],
                stats["ci99_ms"],
                stats["mean_ms"] - stats["ci99_ms"],
                stats["mean_ms"] + stats["ci99_ms"],
            )
        )
    else:
        lines.append("Frame time (mean): %.3f ms" % stats["mean_ms"])
    lines.append("Frame time (median): %.3f ms" % stats["median_ms"])
    lines.append("Frame time (stddev): %.3f ms^2" % stats["stddev_ms"])
    lines.append("Expected FPS: %.3f" % stats["fps"])
    return "\n".join(lines)

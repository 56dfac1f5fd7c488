#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--out-dir DIR]

Drives parallel_ray_tracer_tpu_torch's main path on the card: car_boxed at
1920x1080 with 4 bounces (the bench configuration). It builds the CUDA
kernels from csrc/, holds each kernel against its plain PyTorch version,
renders the frame and holds it against the reference binary's BMP, compares
the fused frame with the pass-based one, times every kernel with CUDA
events, runs each plain version once at the frame's shapes, and shows
through the launch counters that each path ran exactly its kernels: the
fused render() one frame kernel, the pass-based render one closest-hit and
one any-hit launch per bounce and light, the primary pass one closest-hit
launch. Each phase
prints one JSON line; all of them, and the rendered frame, also go to
DIR (default: chip_smoke_out/ beside this script). Any failed check exits
non-zero before the last line; the last line is
{"ok": true, "device": {...}}.

It needs a CUDA device and this repository's package beside it, and exits
non-zero without either.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, and HBM.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per unit of the work the function needs, counted in
# csrc/trace.cuh. The kernels' counting instances count the box tests of
# valid children only and the triangle tests of live slots only (a padding
# slot, n = 0, can never hit), up to an any-hit ray's first blocker. The
# near-first sort, the stack and the shading are not counted.
# A slab test (rt_slab) is 6 mul, 6 sub, 6 min/max per axis pair, 4 min/max
# to combine the axes and 3 compares = 25; a triangle test (rt_mt) is
# 6 (det) + 1 (div) + 3 (ao) + 9 (ao x d) + 6 (u) + 7 (v) + 6 (t)
# + 8 (sign, abs, compares, select) + 1 (t < best) = 47.
OPS_BOX_TEST = 25
OPS_TRI_TEST = 47
WARMUP, TIMED = 10, 50
BANDS = (384, 704)          # 64-row bands: sky + geometry, car body
BAND_ROWS = 64
CFG = dict(scene="car_boxed", width=1920, height=1080, bounces=4,
           bvh_heuristic=6, tile_rows=32, tile_cols=32)
REFERENCE_BMP = os.path.join(HERE, "tests", "goldens", "reference",
                             "car_boxed_1080p.bmp.gz")

RECORDS = []
FAILURES = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def check(phase: str, ok: bool, what: str) -> None:
    if not ok:
        FAILURES.append(f"{phase}: {what}")
        print(f"CHECK FAILED {phase}: {what}", file=sys.stderr, flush=True)


def time_ms(fn, warmup=WARMUP, timed=TIMED):
    """Per-call device times (ms) from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(timed):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in pairs]
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "runs": len(ms)}


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def bound(counts, names, in_bytes, out_bytes):
    """Least time for the work the function needs on these inputs: the
    counted box tests and triangle tests over the FP32 rate, or each input
    read once and each output written once over the memory rate, the
    larger. counts are the kernel's work counters, named by names."""
    c = dict(zip(names, (int(v) for v in counts)))
    ops = c["box_tests"] * OPS_BOX_TEST + c["tri_tests"] * OPS_TRI_TEST
    t_ops = ops / PEAK_FP32_OPS * 1e3
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": in_bytes + out_bytes, **c}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=os.path.join(HERE, "chip_smoke_out"),
                    help="where the JSON records and the frame's BMP go")
    out_dir = ap.parse_args().out_dir
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from parallel_ray_tracer_tpu_torch import _build, pipeline
        from parallel_ray_tracer_tpu_torch.config import RenderConfig
        from parallel_ray_tracer_tpu_torch.ops import cuda_trace as ct
        from parallel_ray_tracer_tpu_torch.ops import render as R
        from parallel_ray_tracer_tpu_torch.ops import trace_plain as tp
        from parallel_ray_tracer_tpu_torch.ops.intersect import EPSILON, T_MAX
        from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3
        from parallel_ray_tracer_tpu_torch.utils.bmp import read_bmp, write_bmp
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    os.makedirs(out_dir, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = []
    if _build.BUILD_INFO.get("log"):
        ptxas = [ln.strip() for ln in open(_build.BUILD_INFO["log"])
                 if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas})

    # ---- 2. prepare -----------------------------------------------------
    t0 = time.perf_counter()
    cfg = RenderConfig(**CFG)
    pipe = pipeline.prepare(cfg)
    torch.cuda.synchronize()
    T = pipe.tables
    L = T.leaf_size
    emit({"phase": "prepare", "seconds": time.perf_counter() - t0,
          "bvh_build_ms": pipe.build_ms, "triangles": pipe.scene.num_triangles,
          "cbox": list(T.cbox.shape), "tri": list(T.tri.shape),
          "tree_depth": pipe.flat.depth, "stack_need": T.stack_depth,
          "stack_size": ct.STACK_SIZE})
    W, H, TR, TC = cfg.width, cfg.height, cfg.tile_rows, cfg.tile_cols
    o, d = R._tiled_planes(pipe.camera(), W, H, TR, TC, pipe.device)
    tiles_x = -(-W // TC)
    rows_per_tile_row = tiles_x * TR * TC // 128

    def band(planes, y0):
        r0 = (y0 // TR) * rows_per_tile_row
        r1 = r0 + (BAND_ROWS // TR) * rows_per_tile_row
        return Vec3(*(p[r0:r1] for p in planes))

    def shadow_rays(o, d, hit):
        """Reversed shadow rays to light 0, as the renderer traces them."""
        lp = T.lamb[0, :3]
        ok = hit.idx >= 0
        ts = torch.where(ok, hit.t, 1.0)
        p = o + d * ts
        lv = Vec3(lp[0] - p.x, lp[1] - p.y, lp[2] - p.z)
        mag = torch.sqrt(lv.mag2())
        far = torch.full_like(mag, 1e30)
        so = Vec3(*(torch.where(ok, c.expand_as(mag), far) for c in lp))
        sd = Vec3(*(torch.where(ok, -c / mag, 0.0) for c in lv))
        m2 = (mag - EPSILON).clamp(min=0.0) ** 2
        return so.contiguous(), sd.contiguous(), m2.contiguous()

    kw = dict(leaf_size=L, stack_depth=T.stack_depth)

    # ---- 3. kernels vs plain versions, on two bands ---------------------
    def cmp_hits(name, hk, hp, full):
        t_k, t_p = hk.t, hp.t
        mk, mp = t_k >= T_MAX, t_p >= T_MAX
        check(name, torch.equal(mk, mp), "miss masks differ")
        both = ~mk & ~mp
        err = (t_k[both] - t_p[both]).abs()
        tol = 1e-4 + 1e-5 * t_p[both].abs()
        check(name, bool((err <= tol).all()), "t beyond atol 1e-4, rtol 1e-5")
        same = hk.idx == hp.idx
        agree = same.float().mean().item()
        check(name, agree >= 0.999, f"idx agreement {agree}")
        check(name, torch.equal(hk.norm_dir[same], hp.norm_dir[same]),
              "norm_dir differs where idx agrees")
        max_err = err.max().item() if err.numel() else 0.0
        if full:
            for vk, vp in zip((*hk.n, *hk.kd, *hk.ks, *hk.kr),
                              (*hp.n, *hp.kd, *hp.ks, *hp.kr)):
                check(name, torch.equal(vk[same], vp[same]),
                      "attributes differ where idx agrees")
                max_err = max(max_err, (vk[same] - vp[same]).abs().max().item())
        return {"max_abs_err": max_err, "idx_agree": agree,
                "hit_frac": both.float().mean().item()}

    def cmp_frame(name, fk, fp):
        """Colours, unclamped: at least 99.99% of pixels within 1e-3 (the
        sound runs had all of them within 2e-4), median < 1e-5."""
        diff = (fk.stack(-1) - fp.stack(-1)).abs()
        within = (diff.amax(-1) < 1e-3).float().mean().item()
        med = diff.median().item()
        check(name, within >= 0.9999, f"{within} of pixels within 1e-3")
        check(name, med < 1e-5, f"median {med}")
        return {"max_abs_err": diff.max().item(), "within_1e-3": within,
                "median": med}

    def cmp_blocked(name, bk, bp):
        agree = (bk == bp).float().mean().item()
        check(name, agree >= 0.999, f"blocked agreement {agree}")
        return {"max_abs_err": float((bk != bp).any()), "agree": agree,
                "blocked_frac": bp.float().mean().item()}

    def timed_once(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    cmp = {k: {"max_abs_err": 0.0, "band_plain_ms": None, "band_ms": None}
           for k in ("closest", "closest_full", "occluded", "frame")}

    def note(key, res, plain_ms, band_ms):
        # band_plain_ms / band_ms: the first band's primary rays (or its
        # shadow rays for the any-hit kernel), plain and kernel on one input
        c = cmp[key]
        c["max_abs_err"] = max(c["max_abs_err"], res.pop("max_abs_err"))
        if c["band_ms"] is None:
            c["band_plain_ms"], c["band_ms"] = plain_ms, band_ms
        c.setdefault("bands", []).append(res)

    for y0 in BANDS:
        bo, bd = band(o, y0), band(d, y0)
        rays = {"primary": (bo, bd)}
        hp, _ = timed_once(lambda: tp.closest_full_plain(T.tri, T.attr, bo, bd, L))
        rays["shadow"] = shadow_rays(bo, bd, hp)[:2]
        for kind, (ro, rd) in rays.items():
            hk = ct.closest_tiles(T.cbox, T.cmeta, T.tri, ro, rd, **kw)
            hpp, pms = timed_once(lambda: tp.closest_plain(T.tri, ro, rd, L))
            res = cmp_hits(f"closest/{kind}@{y0}", hk, hpp, False)
            bms = time_ms(lambda: ct.closest_tiles(T.cbox, T.cmeta, T.tri, ro, rd, **kw), 2, 5)
            note("closest", dict(res, rays=kind, y0=y0), pms, bms["median"])

            hk = ct.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, ro, rd, **kw)
            hpp, pms = timed_once(
                lambda: tp.closest_full_plain(T.tri, T.attr, ro, rd, L))
            res = cmp_hits(f"closest_full/{kind}@{y0}", hk, hpp, True)
            bms = time_ms(lambda: ct.closest_tiles_full(
                T.cbox, T.cmeta, T.tri, T.attr, ro, rd, **kw), 2, 5)
            note("closest_full", dict(res, rays=kind, y0=y0), pms, bms["median"])

        so, sd, m2 = shadow_rays(bo, bd, hp)
        bk = ct.occluded_tiles(T.cbox, T.cmeta, T.tri, so, sd, m2, **kw)
        bp, pms = timed_once(lambda: tp.occluded_plain(T.tri, so, sd, m2, L))
        res = cmp_blocked(f"occluded@{y0}", bk, bp)
        bms = time_ms(lambda: ct.occluded_tiles(T.cbox, T.cmeta, T.tri, so, sd, m2, **kw), 2, 5)
        note("occluded", dict(res, y0=y0), pms, bms["median"])

        fk = ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, bo, bd,
                            bounces=cfg.bounces, **kw)
        fp, pms = timed_once(lambda: ct.frame_plain(
            T.tri, T.attr, T.lamb, bo, bd, bounces=cfg.bounces, leaf_size=L))
        res = cmp_frame(f"frame@{y0}", fk, fp)
        bms = time_ms(lambda: ct.frame_tiles(
            T.cbox, T.cmeta, T.tri, T.attr, T.lamb, bo, bd, bounces=cfg.bounces,
            **kw), 2, 5)
        note("frame", dict(res, y0=y0), pms, bms["median"])
    emit({"phase": "kernel_vs_plain", "band_rays": BAND_ROWS * W,
          "kernels": cmp})

    # ---- 4+5. the main paths: each with its counts from 0 ----------------
    def on_path(name, fn, expect):
        """Run one path with the launch counts from 0; they must be expect."""
        ct.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(ct.LAUNCHES)
        want = {k: expect.get(k, 0) for k in counts}
        check(name, counts == want, f"launches {counts}, expected {want}")
        emit({"phase": "launches", "path": name, "seconds": seconds,
              "launches": counts})
        return out, counts

    nl = T.lamb.shape[0] - 1
    img, on_fused = on_path("render_fused", pipe.render,  # "auto" -> fused
                            {"frame": 1})
    img_pass, on_pass = on_path(
        "render_pass_based", lambda: pipe.render(variant="pallas"),
        {"closest_full": cfg.bounces, "occluded": cfg.bounces * nl})
    prim, on_prim = on_path(
        "primary_closest_pass",
        lambda: ct.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, **kw),
        {"closest": 1})
    launches = {"frame": on_fused["frame"],
                "closest_full": on_pass["closest_full"],
                "occluded": on_pass["occluded"], "closest": on_prim["closest"]}
    for k, n in launches.items():
        check("main_path", n > 0, f"{k} kernel not launched")

    ref = read_reference(read_bmp)
    ours = (img.clamp(0, 1) * 255.0).to(torch.uint8).cpu().numpy()
    write_bmp(os.path.join(out_dir, "car_boxed_1080p.bmp"), ours)
    check("reference", ours.shape == ref.shape, f"shape {ours.shape}")
    dd = np.abs(ours.astype(np.int32) - ref.astype(np.int32)).max(axis=-1)
    parity = {"frac_any": float((dd > 0).mean()), "frac_big": float((dd > 2).mean()),
              "mean": float(dd.mean())}
    check("reference", parity["frac_any"] < 5e-3, f"frac_any {parity['frac_any']}")
    check("reference", parity["frac_big"] < 2e-3, f"frac_big {parity['frac_big']}")
    check("reference", parity["mean"] < 0.1, f"mean {parity['mean']}")
    check("reference", bool(torch.isfinite(img).all()), "non-finite pixels")
    emit({"phase": "reference_image", "shape": list(img.shape), **parity})

    diff = (img - img_pass).abs()
    within = (diff.amax(-1) < 1e-3).float().mean().item()
    med = diff.median().item()
    check("fused_vs_pass", within >= 0.9999, f"{within} of pixels within 1e-3")
    check("fused_vs_pass", med < 1e-5, f"median {med}")
    check("fused_vs_pass", img.std().item() > 0.01, "flat image")
    emit({"phase": "fused_vs_pass", "within_1e-3": within, "median": med,
          "max": diff.max().item(), "hit_frac": (prim.idx >= 0).float().mean().item()})

    # ---- 6. timing at the main path's shapes -----------------------------
    hf = ct.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, o, d, **kw)
    so, sd, m2 = shadow_rays(o, d, hf)
    n_rays = o.x.numel()
    ray_b = nbytes(*o, *d)
    scene_b = nbytes(T.cbox, T.cmeta, T.tri)
    out_plane = n_rays * 4
    runs = {
        "closest": (lambda: ct.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, **kw),
                    lambda: ct.closest_tiles(T.cbox, T.cmeta, T.tri, o, d,
                                             counters=True, **kw)[1],
                    ray_b + scene_b, 3 * out_plane),
        "closest_full": (
            lambda: ct.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, o, d, **kw),
            lambda: ct.closest_tiles_full(T.cbox, T.cmeta, T.tri, T.attr, o, d,
                                          counters=True, **kw)[1],
            ray_b + scene_b + nbytes(T.attr), 15 * out_plane),
        "occluded": (
            lambda: ct.occluded_tiles(T.cbox, T.cmeta, T.tri, so, sd, m2, **kw),
            lambda: ct.occluded_tiles(T.cbox, T.cmeta, T.tri, so, sd, m2,
                                      counters=True, **kw)[1],
            ray_b + out_plane + scene_b, out_plane),
        "frame": (
            lambda: ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, o, d,
                                   bounces=cfg.bounces, **kw),
            lambda: ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, o, d,
                                   bounces=cfg.bounces, counters=True, **kw)[1],
            ray_b + scene_b + nbytes(T.attr, T.lamb), 3 * out_plane),
    }
    timing = {}
    for name, (fn, counted, in_b, out_b) in runs.items():
        t = time_ms(fn)
        b = bound(counted().cpu().tolist(), ct.COUNTS, in_b, out_b)
        timing[name] = dict(t, rays=n_rays, rays_per_s=n_rays / (t["median"] * 1e-3), **b)
    for variant in ("fused", "pallas"):
        e2e = time_ms(lambda: pipe.render(variant=variant))
        timing[f"render_{variant}_end_to_end"] = dict(
            e2e, pixels=W * H, pixels_per_s=W * H / (e2e["median"] * 1e-3))
    emit({"phase": "timing", "card": card, "timing": timing})
    emit({"phase": "profile", "card": card,
          "fused": profile(lambda: pipe.render()),
          "pallas": profile(lambda: pipe.render(variant="pallas"))})

    # ---- 7. plain versions at the main path's shapes, one run each -------
    # The kernel and its plain version on the same full-frame inputs: the
    # plain time beside the kernel's, and one more comparison.
    hk = ct.closest_tiles(T.cbox, T.cmeta, T.tri, o, d, **kw)
    hp, pms = timed_once(lambda: tp.closest_plain(T.tri, o, d, L))
    full = {"closest": dict(cmp_hits("closest/frame", hk, hp, False), plain_ms=pms)}
    hp, pms = timed_once(lambda: tp.closest_full_plain(T.tri, T.attr, o, d, L))
    full["closest_full"] = dict(cmp_hits("closest_full/frame", hf, hp, True),
                                plain_ms=pms)
    del hk, hp
    bk = ct.occluded_tiles(T.cbox, T.cmeta, T.tri, so, sd, m2, **kw)
    bp, pms = timed_once(lambda: tp.occluded_plain(T.tri, so, sd, m2, L))
    full["occluded"] = dict(cmp_blocked("occluded/frame", bk, bp), plain_ms=pms)
    fk = ct.frame_tiles(T.cbox, T.cmeta, T.tri, T.attr, T.lamb, o, d,
                        bounces=cfg.bounces, **kw)
    fp, pms = timed_once(lambda: ct.frame_plain(
        T.tri, T.attr, T.lamb, o, d, bounces=cfg.bounces, leaf_size=L))
    full["frame"] = dict(cmp_frame("frame/frame", fk, fp), plain_ms=pms)
    emit({"phase": "plain_at_frame_shapes", "rays": n_rays, "kernels": full})

    # ---- 8. the kernels line --------------------------------------------
    replaces = {
        "closest": ("closest_kernel<false>", "parallel_ray_tracer_tpu/ops/pallas_trace.py:1774"),
        "closest_full": ("closest_kernel<true>", "parallel_ray_tracer_tpu/ops/pallas_trace.py:1774"),
        "occluded": ("occluded_kernel", "parallel_ray_tracer_tpu/ops/pallas_trace.py:1835"),
        "frame": ("frame_kernel", "parallel_ray_tracer_tpu/ops/pallas_trace.py:2536"),
    }
    kernels = []
    for key, (kname, rep) in replaces.items():
        t = timing[key]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "parallel_ray_tracer_tpu_torch/csrc/trace.cuh",
            "replaces": rep, "launches": launches[key],
            "max_abs_err": max(cmp[key]["max_abs_err"], full[key]["max_abs_err"]),
            "ms": t["median"], "plain_ms": full[key]["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "band_ms": cmp[key]["band_ms"],
            "band_plain_ms": cmp[key]["band_plain_ms"], "band_rays": BAND_ROWS * W,
            "rays": n_rays,
        })
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"records": RECORDS, "kernels": kernels, "failures": FAILURES}, f,
                  indent=1)
    if FAILURES:
        print("chip_smoke: FAILED\n  " + "\n  ".join(FAILURES), file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile(fn, n: int = 5) -> dict:
    """Device time by kernel name and the device's busy share over n calls
    of fn, from a torch.profiler trace (CUPTI). The window runs from the
    first call's start on the host to the synchronise after the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured: the trace holds no device events"}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for s, t in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if t > end:
            busy += t - max(s, end)
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"calls": n, "wall_ms_per_call": wall_us / n / 1e3,
            "device_busy_ms_per_call": busy / n / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "kernel_launches_per_call": len(kernels) / n,
            "top_kernels_ms_per_call": {k: v / n / 1e3 for k, v in top}}


def read_reference(read_bmp) -> np.ndarray:
    """(1080, 1920, 3) uint8 RGB as the reference binary wrote it."""
    with gzip.open(REFERENCE_BMP, "rb") as f:
        data = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.bmp")
        with open(path, "wb") as f:
            f.write(data)
        return read_bmp(path)


if __name__ == "__main__":
    sys.exit(main())

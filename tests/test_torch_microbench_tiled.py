"""Row 15k (parallel_ray_tracer_tpu_torch/microbench/tiled.py) against
scripts/microbench_tiled.py, on the CPU.

The script is loaded from its file inside a fixture that restores the three
jax.config cache values it sets on import. Its kernel is a closure of
`_run`: the loaded module's `pl` is replaced by one whose pallas_call
captures the kernel and returns a stub (so the timing loop costs nothing),
`_run` runs once per body with K = 1 and 2, and `main` runs in a temporary
directory (it writes metrics/microbench_tiled.json). Each captured kernel
then goes through `pallas_call(..., interpret=True)`, with the module's
`jax` replaced by one whose `lax.fori_loop` also records the carry (e, acc)
after K = 1, 3 and 16 iterations into extra outputs; each body compiles
once (cached at module scope) and runs on several ray and box sets.

- Fixtures: the script's `_boxes` and `_rays` bit for bit against
  microbench/fixtures.py (the overlap script's).
- Every body (9) against `tiled_plain` at the script's packet of 1,024 rays,
  on the script's boxes and on the grown boxes (fixtures.grown_boxes, where
  the sums are finite and e branches): e equal at every K, acc within 1e-5
  relative, and both infinite where the script's is (a child that no ray of
  the packet hits adds T_MAX, and the sum overflows). XLA's CPU code
  contracts the script's `lo * inv - oi` into one FMA, where the port rounds
  twice (-fmad=false), so a minimum can differ in its last bit; then acc
  differs within the bound, and e is still equal unless the ulp flips the
  sign of a sum near 0. No body flips one on these fixtures at these K;
  the test would say so, and walk the script's rounding for that case.
- The kernels' packets, through the script: the script's packet made of
  one ray repeated against the plain version at packet 1 for that ray, and
  made of the first 32 rays tiled 32 times against the plain version at
  packet 32.
- The wrappers on the CPU, their refusals, the bound's bytes, the SASS
  names of the instances, the answers, and the `tiled` command with
  --device cpu.
"""

import importlib.util
import json
import os
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from parallel_ray_tracer_tpu_torch import microbench
from parallel_ray_tracer_tpu_torch.microbench import fixtures, inner, sass, tiled
from parallel_ray_tracer_tpu_torch.microbench.__main__ import main as mb_main

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (1, 3, 16)
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")
S = pl.BlockSpec(memory_space=pltpu.SMEM)
OUT = (jax.ShapeDtypeStruct((1, 1), jnp.float32), jax.ShapeDtypeStruct((len(KS),), jnp.int32),
       jax.ShapeDtypeStruct((len(KS),), jnp.float32))
_COMPILED = {}


def load_script(name):
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


class History:
    """The loaded script's `jax`: lax.fori_loop also keeps the carry (e,
    acc) after KS iterations."""

    def __init__(self):
        hist = self
        self.h = None

        class Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def fori_loop(self, lo, hi, body, init):
                def step(i, c):
                    carry, he, ha = c
                    carry = body(i, carry)
                    m = jnp.stack([i + 1 == k for k in KS])
                    return carry, jnp.where(m, carry[0], he), jnp.where(m, carry[1], ha)

                z = (jnp.zeros(len(KS), jnp.int32), jnp.zeros(len(KS), jnp.float32))
                carry, he, ha = jax.lax.fori_loop(lo, hi, step, (init, *z))
                hist.h = (he, ha)
                return carry

        class Jax:
            lax = Lax()

            def __getattr__(self, name):
                return getattr(jax, name)

        self.jax = Jax()


def with_history(kernel, n_in, hist):
    """The kernel with two more outputs, the history of e and acc."""
    def body(*refs):
        kernel(*refs[:n_in], refs[n_in], *refs[n_in + 3:])
        refs[n_in + 1][...] = hist.h[0]
        refs[n_in + 2][...] = hist.h[1]
    return body


def capture(name, tmp_dir):
    """The script `name` with `main` run and every `_run` call's kernel
    captured: (module, {label: (kernel, in_specs, scratch_shapes, scene
    arrays)}, History)."""
    mod = load_script(name)
    kernels, last = {}, {}

    class Pl:
        def __getattr__(self, attr):
            return getattr(pl, attr)

        def pallas_call(self, kernel, out_shape, in_specs, out_specs, scratch_shapes=(),
                        compiler_params=None):
            last["kernel"] = (kernel, in_specs, scratch_shapes)

            def stub(ks, *args):
                last["args"] = args
                return np.zeros((1, 1), np.float32)
            return stub

    run = mod._run
    mod.pl = Pl()

    def capture_run(label, body, scene, **kw):
        run(label, body, scene, k_lo=1, k_hi=2, reps=1)
        kernels[label] = (*last["kernel"], tuple(scene))
        return 0.0

    mod._run = capture_run
    cwd = os.getcwd()
    os.chdir(tmp_dir)
    try:
        mod.main()
    finally:
        os.chdir(cwd)
    hist = History()
    mod.jax = hist.jax
    return mod, kernels, hist


def run_script(captured, label, scene, rays, n_scene):
    """(e, acc) after each of KS iterations of the captured kernel `label`
    on `scene` and `rays` (the script's packet of 8 x 128 rays)."""
    mod, kernels, hist = captured
    kernel, specs, scratch, _ = kernels[label]
    key = (mod.__name__, label)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(pl.pallas_call(
            with_history(kernel, 1 + n_scene + 6, hist), out_shape=OUT, in_specs=specs,
            out_specs=(S, S, S), scratch_shapes=scratch, interpret=True))
    _, he, ha = _COMPILED[key](jnp.asarray([KS[-1]], jnp.int32), *(jnp.asarray(a) for a in scene),
                               *(jnp.asarray(r) for r in rays))
    return np.asarray(he), np.asarray(ha)


def assert_acc(got, want, what):
    got, want = np.float32(got), np.float32(want)
    if np.isinf(want):
        assert got == want, (what, got, want)
    else:
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30) or got == want, (what, got, want)


def packet_rays():
    """The kernels' packets as script packets: the first 32 rays tiled 32
    times (packet 32, its first packet), and one ray repeated (packet 1)."""
    rays = fixtures.overlap_rays()
    r32 = [np.tile(p.reshape(-1)[:32], 32).reshape(fixtures.PACKET) for p in rays]
    ray = 77
    r1 = [np.full(fixtures.PACKET, p.reshape(-1)[ray], np.float32) for p in rays]
    return [(r32, 32, 0), (r1, 1, ray)]


@pytest.fixture(scope="module")
def tscript(tmp_path_factory):
    return capture("microbench_tiled", tmp_path_factory.mktemp("tiled"))


@pytest.fixture(scope="module")
def tabs():
    return {"script": inner.probe_tables("cpu"), "grown": tiled.grown_tables("cpu")}


def test_fixtures_identical(tscript, tabs):
    mod, kernels, _ = tscript
    assert set(kernels) == set(tiled.LABELS.values())
    for s, p in zip(mod._rays(), fixtures.overlap_rays()):
        np.testing.assert_array_equal(np.asarray(s).view(np.uint32), p.view(np.uint32))
    qbox, qmeta = kernels[tiled.LABELS["current"]][3]
    box, meta = fixtures.overlap_boxes()
    np.testing.assert_array_equal(np.asarray(qbox).view(np.uint32), box.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(qmeta), meta)
    assert torch.equal(tabs["script"].cbox, torch.from_numpy(box))
    grown = tabs["grown"].cbox.numpy()
    np.testing.assert_array_equal(grown[:, :24:6], box[:, :24:6] - np.float32(fixtures.GROW))
    np.testing.assert_array_equal(grown[:, 3:24:6], box[:, 3:24:6] + np.float32(fixtures.GROW))
    np.testing.assert_array_equal(grown[:, 24:], box[:, 24:])


def _plain_hist(tab, body, packet):
    return [tiled.tiled_plain(tab, body, k, packet) for k in KS]


@pytest.mark.parametrize("body", list(tiled.BODIES))
def test_body_matches_script(tscript, tabs, body):
    label = tiled.LABELS[body]
    _, kernels, _ = tscript
    qmeta = kernels[label][3][1]
    rays = fixtures.overlap_rays()
    for which, tab in tabs.items():
        scene = (tab.cbox.numpy(), qmeta)
        he, ha = run_script(tscript, label, scene, rays, 2)
        for j, r in enumerate(_plain_hist(tab, body, 1024)):
            assert int(r["e"][0]) == int(he[j]), (body, which, KS[j], int(r["e"][0]), int(he[j]))
            assert_acc(r["acc"][0].item(), ha[j], (body, which, KS[j]))
        for prays, packet, ray in packet_rays():
            hs, hacc = run_script(tscript, label, scene, prays, 2)
            for j, r in enumerate(_plain_hist(tab, body, packet)):
                assert int(r["e"][ray]) == int(hs[j]), (body, which, packet, KS[j])
                assert_acc(r["acc"][ray].item(), hacc[j], (body, which, packet, KS[j]))


def test_grown_boxes_branch(tabs):
    """On the grown boxes the warp packets' sums are finite and e differs
    between warps; on the script's they are infinite (every packet misses a
    child), so e only counts."""
    g = tiled.tiled_plain(tabs["grown"], "current", KS[-1], 32)
    assert torch.isfinite(g["acc"]).float().mean() > 0.5 and g["e"].unique().numel() > 2
    s = tiled.tiled_plain(tabs["script"], "current", KS[-1], 32)
    assert torch.isinf(s["acc"]).all() and torch.equal(s["e"], torch.full_like(s["e"], KS[-1]))
    c = tiled.tiled_plain(tabs["script"], "current_noreduce", KS[-1], 32)
    assert torch.isfinite(c["acc"]).all() and c["e"].unique().numel() > 2


def test_semantics_shared(tabs):
    """The child-parallel forms compute A's values, stacked_noreduce C's."""
    for which, tab in tabs.items():
        for body, sem in tiled.SEMANTICS.items():
            a = tiled.tiled_plain(tab, body, 5, 32)
            b = tiled.tiled_plain(tab, sem, 5, 32)
            assert torch.equal(a["e"], b["e"]) and torch.equal(a["acc"], b["acc"]), (which, body)


def test_wrappers_run_plain_on_cpu():
    microbench.reset_launch_counts()
    small = inner.probe_tables("cpu", [p[:, :8] for p in fixtures.overlap_rays()])
    for body in tiled.BODIES:
        for packet in tiled.PACKETS[body]:
            r = tiled.probe(small, body, 2, packet, n=128)
            p = tiled.tiled_plain(small, body, 2, packet, 128)
            assert set(r) == {"e", "acc"}
            assert torch.equal(r["e"], p["e"]) and torch.equal(r["acc"], p["acc"]), (body, packet)
            assert torch.equal(r["e"][:64], r["e"][64:])         # thread i on ray i % 64
    assert microbench.LAUNCHES["tiled"] == 0 and not microbench.INSTANCE_LAUNCHES


def test_instances_and_refusals(tabs):
    tab = tabs["script"]
    assert len(tiled.INSTANCES) == 12
    assert "tiled<chunk1,p32>" in tiled.INSTANCES and "tiled<loads_only,p1>" in tiled.INSTANCES
    with pytest.raises(ValueError, match="no such instance"):
        tiled.probe(tab, "stacked", 1, 1)          # the child-parallel forms are warp forms
    with pytest.raises(ValueError):
        tiled.probe(tab, "Z", 1, 32)
    with pytest.raises(ValueError):
        tiled.probe(tab, "current", 1, 32, n=100)
    with pytest.raises(ValueError):
        tiled.probe(tab, "current", -1, 32)


def test_read_bytes_counts_what_the_run_visits(tabs):
    tab = tabs["grown"]
    rays = 4 * sum(p.numel() for p in tab.planes)
    got = {}
    for body in tiled.BODIES:
        visited = []
        tiled.tiled_plain(tab, body, KS[-1], 1, visited=visited)
        assert len(visited) == KS[-1] and not visited[0].any(), body
        rows = tiled.rows_of(torch.cat(visited))
        got[body] = (tiled.read_bytes(tab, body, visited), rows)
    for body in tiled.SLAB_BODIES:
        assert got[body][0] == rays + 96 * torch.unique(got[body][1]).numel(), body
    assert got["loads_only"][0] == 8 * torch.unique(got["loads_only"][1]).numel()
    rows = got["construct_only"][1]
    pairs = {(int(a), 0) for a in rows[:, 0]} | {(int(a), 3) for a in rows[:, 7]}
    assert got["construct_only"][0] == 24 * len(pairs)
    assert tiled.read_bytes(tab, "current", []) == rays
    assert tiled.iteration_ops("chunk1") == {"fp32": 800, "tensor": 0}
    assert tiled.iteration_ops("loads_only")["fp32"] == 0


def test_sass_names_and_answers(monkeypatch):
    """Each instance's SASS counts are found by its mangled name (the
    template arguments BODY, CH, P), and the answers are the ratios."""
    mangled = {f"_Z15mb_tiled_kernelILi{c}ELi{ch}ELi{p}EEv11MbTiledArgs": (b, p)
               for b, (c, ch) in tiled.BODIES.items() for p in tiled.PACKETS[b]}
    monkeypatch.setattr(sass, "kernel_counts",
                        lambda unit: {m: Counter({"STL": 0, "BRA": i + 1})
                                      for i, m in enumerate(mangled)})
    got = sass.instance_counts("microbench_tiled.cu")
    assert set(got) == tiled.INSTANCES
    for i, (m, (b, p)) in enumerate(mangled.items()):
        assert got[tiled.instance(b, p)]["BRA"] == i + 1
    ns = {n: 10.0 for n in tiled.INSTANCES}
    ns[tiled.instance("stacked", 32)] = 5.0
    ns[tiled.instance("current", 1)] = 40.0
    ans = tiled.answers(ns)
    assert ans["stacked_over_current_p32"] == 0.5 and ans["chunk1_over_current_p32"] == 1.0
    assert ans["current_p32_over_p1"] == 0.25


def test_entry_point_on_cpu(tmp_path, capsys):
    microbench.reset_launch_counts()
    assert mb_main(["tiled", "--device", "cpu", "--out", str(tmp_path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"command": "tiled", "device": "cpu"}
    text = json.dumps(lines)
    assert '"ns' not in text and '"ms' not in text                # no times on the CPU
    assert json.load(open(tmp_path / "tiled.json"))["records"] == lines[1:]
    assert {r["instance"] for r in lines[1:]} == tiled.INSTANCES
    a = next(r for r in lines[1:] if r["instance"] == "tiled<current_noreduce,p32>")
    assert a["e_packet_1024"] == tiled.tiled_plain(inner.probe_tables("cpu"), "current_noreduce",
                                                    tiled.CPU_ITERS, 1024)["e"][0]
    assert all(v == 0 for v in microbench.LAUNCHES.values())           # plain only

"""Rows 15i and 15l (parallel_ray_tracer_tpu_torch/microbench/inner.py,
cond.py) against scripts/microbench_inner.py and scripts/microbench_cond.py,
on the CPU.

The scripts are loaded from their files inside fixtures that restore the
three jax.config cache values they set on import. microbench_inner.py's
bodies are closures inside `main`: its `_run` is replaced by a stub that
records (body, scene arrays, scene spaces), and `main` runs. Each body then
goes through the script's own `_loop_kernel` in `pallas_call(...,
interpret=True)`, with the loaded module's `jax` replaced by one whose
`lax.fori_loop` also records the carry (e, acc) after K = 1, 3 and 16
iterations into extra outputs; each body compiles once (cached at module
scope) and runs on several ray sets. microbench_cond.py's `_bench` is run
with a `pl` whose pallas_call captures the kernel (and its tile) and
returns a stub, so its timing loop costs nothing; `main` runs in a
temporary directory (it writes metrics/microbench_cond.json).

- Fixtures: `_rays`, `_boxes`, `meta_flat`, the Lf tables and cond's tile
  bit for bit against microbench/fixtures.py.
- Every body (18) against `inner_plain` at the script's packet of 1,024
  rays: e equal at every K, acc within 1e-5 relative (both infinite where
  the script's is: body C sums T_MAX). XLA's CPU code contracts the
  script's `lo * inv - oi` into one FMA, where the port rounds twice
  (-fmad=false), so a packet minimum can differ in its last bit; then acc
  differs within the bound, and e is still equal unless the ulp flips a
  near tie in the sort. No body flips one on these fixtures at these K;
  the test would say so and walk the script's rounding for that case.
- The kernels' packets, through the script: the script's packet made of
  one ray repeated (its packet minimum is that ray's value) against the
  plain version at packet 1 for that ray, and made of the first 32 rays
  tiled 32 times against the plain version at packet 32 (Lf: the first 32
  feature columns tiled).
- Row 15l: each step shape of the script (its tile, and a tile made of one
  lane's 32 elements repeated) against `cond_plain` warp-uniform and per
  thread: e equal, the tile's maximum within 2e-7 relative (XLA contracts
  `a * 1.0001 + 0.1`; the port rounds twice).
- The wrappers on the CPU, their refusals, and the `inner` and `cond`
  commands with --device cpu.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from parallel_ray_tracer_tpu_torch import microbench
from parallel_ray_tracer_tpu_torch.microbench import cond, fixtures, inner
from parallel_ray_tracer_tpu_torch.microbench.__main__ import main as mb_main

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (1, 3, 16)
T_MAX = np.float32(3.4028235e38)
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")
S = pl.BlockSpec(memory_space=pltpu.SMEM)
V = pl.BlockSpec(memory_space=pltpu.VMEM)
_COMPILED = {}


def _load(name):
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


class _History:
    """The loaded script's `jax`: lax.fori_loop also keeps the carry after
    KS iterations (e, and acc or the tile's maximum)."""

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
                    v = carry[1] if carry[1].ndim == 0 else jnp.max(carry[1])
                    return carry, jnp.where(m, carry[0], he), jnp.where(m, v, ha)

                z = (jnp.zeros(len(KS), jnp.int32), jnp.zeros(len(KS), jnp.float32))
                carry, he, ha = jax.lax.fori_loop(lo, hi, step, (init, *z))
                hist.h = (he, ha)
                return carry

        class Jax:
            lax = Lax()

            def __getattr__(self, name):
                return getattr(jax, name)

        self.jax = Jax()


def _with_history(kernel, n_in, hist):
    """The kernel with two more outputs, the history of e and acc."""
    def body(*refs):
        kernel(*refs[:n_in], refs[n_in], *refs[n_in + 3:])
        refs[n_in + 1][...] = hist.h[0]
        refs[n_in + 2][...] = hist.h[1]
    return body


OUT = (jax.ShapeDtypeStruct((1, 1), jnp.float32), jax.ShapeDtypeStruct((len(KS),), jnp.int32),
       jax.ShapeDtypeStruct((len(KS),), jnp.float32))


@pytest.fixture(scope="module")
def iscript():
    """microbench_inner.py with its bodies captured and its carries kept."""
    mod = _load("microbench_inner")
    bodies = {}
    mod._run = lambda name, body, scene, **kw: bodies.__setitem__(
        name.split()[0], (body, scene, kw.get("scene_spaces")))
    mod.main()
    hist = _History()
    mod.jax = hist.jax
    return mod, bodies, hist


def _run_inner(iscript, key, rays=None, scene=None):
    """(e, acc) of body `key` after each of KS iterations, the script's
    packet on `rays` (default: its own)."""
    mod, bodies, hist = iscript
    body, scene0, spaces = bodies[key]
    scene = scene0 if scene is None else scene
    if key not in _COMPILED:
        n = len(scene)
        specs = [S] + [pl.BlockSpec(memory_space=s) for s in spaces or [pltpu.VMEM] * n] + [V] * 6
        _COMPILED[key] = jax.jit(pl.pallas_call(
            _with_history(mod._loop_kernel(body, n), 1 + n + 6, hist), out_shape=OUT,
            in_specs=specs, out_specs=(S, S, S),
            scratch_shapes=[pltpu.SMEM((256,), jnp.int32)], interpret=True))
    rays = mod._rays() if rays is None else [jnp.asarray(r) for r in rays]
    _, he, ha = _COMPILED[key](jnp.asarray([KS[-1]], jnp.int32), *scene, *rays)
    return np.asarray(he), np.asarray(ha)


@pytest.fixture(scope="module")
def tab():
    return inner.probe_tables("cpu")


def _assert_acc(got, want, what):
    got, want = np.float32(got), np.float32(want)
    if np.isinf(want):
        assert got == want, (what, got, want)
    else:
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30) or got == want, (what, got, want)


# ---- fixtures ---------------------------------------------------------------------


def test_fixtures_identical(iscript, tab):
    mod, bodies, _ = iscript
    for s, p in zip(mod._rays(), fixtures.overlap_rays()):
        np.testing.assert_array_equal(np.asarray(s).view(np.uint32), p.view(np.uint32))
    qbox, qmeta = mod._boxes()
    box, meta = fixtures.overlap_boxes()
    np.testing.assert_array_equal(np.asarray(qbox).view(np.uint32), box.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(qmeta), meta)
    (meta_flat,) = bodies["E"][1]
    np.testing.assert_array_equal(np.asarray(meta_flat), fixtures.inner_meta_flat())
    cmi, rmat = bodies["Lf2"][1]
    want_cmi, want_rmat = fixtures.lf_tables()
    np.testing.assert_array_equal(np.asarray(cmi).view(np.uint16), want_cmi)
    np.testing.assert_array_equal(np.asarray(rmat).view(np.uint32), want_rmat.view(np.uint32))
    assert torch.equal(tab.cmi.view(torch.int16), torch.from_numpy(want_cmi.view(np.int16)))
    assert torch.equal(tab.meta_flat, torch.from_numpy(fixtures.inner_meta_flat()))


# ---- every body against the script ------------------------------------------------------


def _plain_hist(tab, body, packet):
    return [inner.inner_plain(tab, body, k, packet) for k in KS]


@pytest.mark.parametrize("body", list(inner.BODIES))
def test_body_matches_script(iscript, tab, body):
    he, ha = _run_inner(iscript, body)
    for j, (k, r) in enumerate(zip(KS, _plain_hist(tab, body, 1024))):
        assert int(r["e"][0]) == int(he[j]), (body, k, int(r["e"][0]), int(he[j]))
        _assert_acc(r["acc"][0].item(), ha[j], (body, k))
    if body in inner.LEAF_BODIES:
        # the kernel's packet: the first 32 feature columns, tiled
        cmi, rmat = iscript[1][body][1]
        tiled = jnp.tile(rmat[:, :32], (1, 32))
        he32, ha32 = _run_inner(iscript, body, scene=(cmi, tiled))
        runs = [(he32, ha32, 32, 0)]
    else:
        rays = fixtures.overlap_rays()
        r32 = [np.tile(p.reshape(-1)[:32], 32).reshape(fixtures.PACKET) for p in rays]
        ray = 77
        r1 = [np.full(fixtures.PACKET, p.reshape(-1)[ray], np.float32) for p in rays]
        runs = [(*_run_inner(iscript, body, r32), 32, 0),
                (*_run_inner(iscript, body, r1), 1, ray)]
    for hs, hacc, packet, ray in runs:
        for j, r in enumerate(_plain_hist(tab, body, packet)):
            assert int(r["e"][ray]) == int(hs[j]), (body, packet, KS[j])
            _assert_acc(r["acc"][ray].item(), hacc[j], (body, packet, KS[j]))


def test_bodies_branch_and_push(tab):
    """The chains move: e differs between rays at packet 1 and between
    warps at packet 32, and the push bodies' top entries are written."""
    for body in ("A", "M", "M4"):
        p1 = inner.inner_plain(tab, body, KS[1], 1)
        p32 = inner.inner_plain(tab, body, KS[1], 32)
        assert p1["e"].unique().numel() > 8 and p32["e"].unique().numel() > 4, body
        assert (p1["top"] != 0).any(), body
    g = inner.inner_plain(tab, "G", 3, 1)
    assert torch.equal(g["e"], torch.full_like(g["e"], 12))    # 4 even values in every 8
    assert torch.equal(g["top"], torch.full_like(g["top"], 14))
    written = {b for b in inner.BODIES if b not in inner.LEAF_BODIES
               and (inner.inner_plain(tab, b, KS[1], 1)["top"] != 0).any()}
    assert written == set(inner.PUSHES)


def test_read_bytes_counts_what_the_run_visits(tab):
    """The bound's bytes: each iteration's e is recorded; a body is charged
    the rays only if it reads them and, per distinct row its chains visit,
    only the elements it reads."""
    rays = 4 * sum(p.numel() for p in tab.planes)
    got = {}
    for body in inner.BODIES:
        visited = []
        packet = 32 if body in inner.LEAF_BODIES else 1
        inner.inner_plain(tab, body, KS[-1], packet, visited=visited)
        assert len(visited) == KS[-1] and not visited[0].any(), body
        e = torch.cat(visited)
        rows = torch.unique(e).numel()
        got[body] = (inner.read_bytes(tab, body, visited), rows, e)
    assert got["F"][0] == got["G"][0] == 0 and got["N"][0] == rays
    for body, per_row in (("D", 32), ("E", 32), ("H", 16), ("J", 4), ("K", 96)):
        assert got[body][0] == per_row * got[body][1], body
    for body, per_row in (("A", 128), ("B", 96), ("C", 96), ("I", 112)):
        assert got[body][0] == rays + per_row * got[body][1], body
    b, _, e = got["M"]
    assert b == rays + 128 * torch.unique(torch.cat([e, (e + 1) % inner.N_NODES])).numel()
    b, _, e = got["Lf4"]
    groups = torch.unique(torch.cat([(e + 5 * k) % fixtures.LF_GROUPS for k in range(4)]))
    assert b == 2048 * groups.numel() + 4 * tab.rmat.numel()
    assert inner.read_bytes(tab, "A", []) == rays


# ---- the wrappers on the CPU ---------------------------------------------------------------


def test_wrappers_run_plain_on_cpu(tab):
    microbench.reset_launch_counts()
    small = inner.probe_tables("cpu", [p[:, :8] for p in fixtures.overlap_rays()])
    assert small.planes[0].numel() == 64 and small.rmat.shape == (16, 64)
    for body in ("A", "G", "M2", "E"):
        for packet in (1, 32):
            r = inner.probe(small, body, 2, packet, n=128)
            p = inner.inner_plain(small, body, 2, packet, 128)
            for k in ("e", "acc", "top"):
                assert torch.equal(r[k], p[k]), (body, packet, k)
            assert torch.equal(r["e"][:64], r["e"][64:])          # thread i on ray i % 64
    lf = inner.probe(small, "Lf4", 2, 32)
    assert lf["e"].shape == (64,) and torch.equal(lf["e"][:32], lf["e"][:1].expand(32))
    assert microbench.LAUNCHES["inner"] == 0 and not microbench.INSTANCE_LAUNCHES


def test_instances_and_refusals(tab):
    names = {i.name for i in inner.inner_instances()}
    assert len(names) == 40 and names == inner.INSTANCES
    assert "inner<G,p1,stack=shared>" in names and "inner<E,p32,meta=global>" in names
    with pytest.raises(ValueError, match="no such instance"):
        inner.probe(tab, "Lf2", 1, 1)                   # the leaf step is a warp step
    with pytest.raises(ValueError, match="no such instance"):
        inner.probe(tab, "A", 1, 1, stack="shared")
    with pytest.raises(ValueError):
        inner.probe(tab, "Z", 1, 1)
    with pytest.raises(ValueError):
        inner.probe(tab, "A", 1, 1, n=100)


# ---- row 15l ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cscript(tmp_path_factory):
    """microbench_cond.py's four step shapes, each as its captured kernel."""
    mod = _load("microbench_cond")
    hist = _History()
    kernels, tiles = {}, []

    class Pl:
        def __getattr__(self, name):
            return getattr(pl, name)

        def pallas_call(self, kernel, out_shape, in_specs, out_specs):
            def stub(ks, a):
                tiles.append(np.asarray(a))
                return np.zeros((1, 1), np.float32)
            kernels["last"] = (kernel, in_specs)
            return stub

    bench = mod._bench
    mod.pl = Pl()

    def capture(name, step):
        bench(name, step, k_lo=1, k_hi=2, reps=1)
        kernels[name] = kernels.pop("last")
        return 0.0

    mod._bench = capture
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("cond"))
    try:
        mod.main()
    finally:
        os.chdir(cwd)
    mod.jax = hist.jax
    names = {"0 conds (straight-line)": "straight", "1 cond": "cond1",
             "2 nested conds": "cond2_nested", "lax.switch over 4": "switch4"}
    out = {}
    for name, shape in names.items():
        kernel, specs = kernels[name]
        out[shape] = jax.jit(pl.pallas_call(
            _with_history(kernel, 2, hist), out_shape=OUT, in_specs=specs,
            out_specs=(S, S, S), interpret=True))
    return out, tiles[0]


@pytest.mark.parametrize("shape", list(cond.SHAPES))
def test_cond_matches_script(cscript, shape):
    fns, tile = cscript
    np.testing.assert_array_equal(tile.view(np.uint32), fixtures.cond_tile().view(np.uint32))
    a = cond.tile("cpu")
    lanes = a.reshape(32, 32)
    lane = int(lanes[:, 0].argmin())          # the lane whose e gains most
    runs = [(tile, True, 0), (np.tile(lanes[lane].numpy(), 32).reshape(8, 128), False, lane)]
    for t, uniform, lane_ in runs:
        out, he, hm = fns[shape](jnp.asarray([KS[-1]], jnp.int32), jnp.asarray(t))
        for j, k in enumerate(KS):
            r = cond.cond(a, shape, uniform, k)
            assert int(r["e"][lane_]) == int(he[j]), (shape, uniform, k)
            m = r["max"].max() if uniform else r["max"][lane_]
            np.testing.assert_allclose(m.item(), hm[j], rtol=2e-7)
        if uniform:
            np.testing.assert_allclose(cond.script_output(r), float(out[0, 0]), rtol=2e-7)
    per = cond.cond(a, shape, False, KS[-1])
    assert per["e"].unique().numel() > 1         # per thread, the branch diverges


def test_cond_refusals():
    a = cond.tile("cpu")
    with pytest.raises(ValueError):
        cond.cond(a, "cond3", True, 1)
    with pytest.raises(ValueError):
        cond.cond(a, "cond1", True, 1, n=48)
    assert len(cond.INSTANCES) == 8


# ---- the entry point -------------------------------------------------------------------------


@pytest.mark.parametrize("command", ["inner", "cond"])
def test_entry_point_on_cpu(command, tmp_path, capsys):
    microbench.reset_launch_counts()
    assert mb_main([command, "--device", "cpu", "--out", str(tmp_path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["device"] == "cpu"
    text = json.dumps(lines)
    assert '"ns' not in text and '"ms' not in text                # no times on the CPU
    saved = json.load(open(tmp_path / f"{command}.json"))
    assert saved["records"] == lines[1:]
    if command == "inner":
        assert {r["instance"] for r in lines[1:]} == {
            i.name for i in inner.inner_instances()
            if i.stack == "local" and not (i.block == inner.BIG_BLOCK and i.meta == "global")}
        a = next(r for r in lines[1:] if r["instance"] == "inner<A,p32>")
        assert a["e_packet_1024"] == 51
    else:
        assert [r["case"] for r in lines[1:]] == ["per_thread", "uniform"]
    assert all(v == 0 for v in microbench.LAUNCHES.values())           # plain only

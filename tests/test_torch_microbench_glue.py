"""Row 15j (parallel_ray_tracer_tpu_torch/microbench/glue.py) against
scripts/microbench_glue.py, on the CPU.

The script is loaded from its file inside a fixture that restores the three
jax.config cache values it sets on import (its `main` parses sys.argv and
writes metrics/, so it is not called). Its bodies are module-level
factories: each body at npop 4 and 8 goes through the script's own
`_loop_kernel` in `pallas_call(..., interpret=True)` with its two SMEM
stacks, the loaded module's `jax` replaced by one whose `lax.fori_loop`
also records e after K = 1, 3 and 16 iterations (acc stays 0: the script
adds 0.0); each compiles once (cached at module scope).

- Fixtures: `_rays` and `_boxes` bit for bit against the overlap script's
  copies in microbench/fixtures.py, and `meta_s` as `main` builds it
  (:662) against fixtures.glue_meta_s().
- Every body (14) at npop 4 (npop 8: tests/test_torch_microbench_glue_npop8.py,
  which shares this file's fixtures and checks, so that the compiles of
  each file fit in its time) against `glue_plain` at the script's packet
  of 1,024 rays: e equal at every K (the packet minima feed only compares
  and the sort, and no near tie flips on these fixtures; see
  tests/test_torch_microbench_inner.py on XLA's contraction), acc 0.
- The kernels' packets through the script, at npop 4 and K = 16: one ray
  repeated against the plain version at packet 1, the first 32 rays tiled
  against packet 32.
- The bodies that share a plain version compute the same e in the script
  (full, full_x2, full_x4, full_xs; nosort, xb), and the script's
  components are the differences `components` takes.
- The bytes the kernels line charges each body (`read_bytes`) and the
  stores per iteration its SASS check asks of the push bodies (`pushes`).
- The wrappers on the CPU, their refusals, and the `glue` command with
  --device cpu (and --probes-only).
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
from parallel_ray_tracer_tpu_torch.microbench import fixtures, glue, inner
from parallel_ray_tracer_tpu_torch.microbench.__main__ import main as mb_main

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (1, 3, 16)
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")
S = pl.BlockSpec(memory_space=pltpu.SMEM)
V = pl.BlockSpec(memory_space=pltpu.VMEM)
FACTORY = {b: f"body_{'x2_nosortpush' if b == 'x2_only' else b}" for b in glue.BODIES}
_COMPILED = {}


@pytest.fixture(scope="module")
def script():
    """microbench_glue.py with a `jax` whose fori_loop keeps e after KS
    iterations."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_script_microbench_glue", os.path.join(REPO, "scripts", "microbench_glue.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    hist = {}

    class Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        def fori_loop(self, lo, hi, body, init):
            def step(i, c):
                carry, he = c
                carry = body(i, carry)
                return carry, jnp.where(jnp.stack([i + 1 == k for k in KS]), carry[0], he)

            carry, hist["e"] = jax.lax.fori_loop(lo, hi, step,
                                                 (init, jnp.zeros(len(KS), jnp.int32)))
            return carry

    class Jax:
        lax = Lax()

        def __getattr__(self, name):
            return getattr(jax, name)

    mod.jax = Jax()
    return mod, hist


def _scene(mod):
    qbox, qmeta = mod._boxes()
    meta_s = jnp.asarray(np.asarray(qmeta)[:, :mod.ARITY].reshape(-1).astype(np.int32))
    return qbox, qmeta, meta_s


def _run(script, body, npop, rays=None):
    """e after each of KS iterations of `body`, the script's packet on
    `rays` (default: its own)."""
    mod, hist = script
    scene = _scene(mod)
    smem_meta = body in glue.SMEM_META
    scene = scene if smem_meta else scene[:2]
    if (body, npop) not in _COMPILED:
        kernel = mod._loop_kernel(getattr(mod, FACTORY[body])(npop), n_scene=len(scene))
        n_in = 1 + len(scene) + 6

        def k(*refs):
            kernel(*refs[:n_in], refs[n_in], *refs[n_in + 2:])
            refs[n_in + 1][...] = hist["e"]

        spaces = [pltpu.VMEM, pltpu.VMEM] + ([pltpu.SMEM] if smem_meta else [])
        _COMPILED[body, npop] = jax.jit(pl.pallas_call(
            k, out_shape=(jax.ShapeDtypeStruct((1, 1), jnp.float32),
                          jax.ShapeDtypeStruct((len(KS),), jnp.int32)),
            in_specs=[S] + [pl.BlockSpec(memory_space=s) for s in spaces] + [V] * 6,
            out_specs=(S, S),
            scratch_shapes=[pltpu.SMEM((512,), jnp.int32), pltpu.SMEM((512,), jnp.int32)],
            interpret=True))
    rays = mod._rays() if rays is None else [jnp.asarray(r) for r in rays]
    out, he = _COMPILED[body, npop](jnp.asarray([KS[-1]], jnp.int32), *scene, *rays)
    return np.asarray(he), float(np.asarray(out)[0, 0])


@pytest.fixture(scope="module")
def tab():
    return inner.probe_tables("cpu")


def test_fixtures_identical(script, tab):
    mod, _ = script
    for s, p in zip(mod._rays(), fixtures.overlap_rays()):
        np.testing.assert_array_equal(np.asarray(s).view(np.uint32), p.view(np.uint32))
    qbox, qmeta, meta_s = _scene(mod)
    box, meta = fixtures.overlap_boxes()
    np.testing.assert_array_equal(np.asarray(qbox).view(np.uint32), box.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(qmeta), meta)
    np.testing.assert_array_equal(np.asarray(meta_s), fixtures.glue_meta_s())
    assert torch.equal(tab.meta_s, torch.from_numpy(fixtures.glue_meta_s()))


def check_body(script, tab, body, npop):
    """The body's e at every K of KS against the plain version at the
    script's packet; at npop 4 also the kernels' packets at K = 16."""
    he, out = _run(script, body, npop)
    runs = [(he, 1024, 0)]
    if npop == 4:
        rays = fixtures.overlap_rays()
        r32 = [np.tile(p.reshape(-1)[:32], 32).reshape(fixtures.PACKET) for p in rays]
        ray = 77
        r1 = [np.full(fixtures.PACKET, p.reshape(-1)[ray], np.float32) for p in rays]
        runs += [(_run(script, body, npop, r32)[0], 32, 0), (_run(script, body, npop, r1)[0], 1, ray)]
    for hs, packet, ray in runs:
        for k in KS if packet == 1024 else KS[-1:]:
            r = glue.glue_plain(tab, body, npop, k, packet)
            assert int(r["e"][ray]) == int(hs[KS.index(k)]), (body, npop, packet, k)
            assert float(r["acc"][ray]) == 0.0
    assert out == float(he[-1])                      # out[0, 0] = acc + e, acc = 0


def check_shared_semantics(script, npop):
    """The bodies that share a plain version compute the same e in the
    script (the compiles are those of the body tests)."""
    e = {b: _run(script, b, npop)[0].tolist() for b in glue.BODIES}
    for body, sem in glue.SEMANTICS.items():
        assert e[body] == e[sem], (body, npop)
    assert len({tuple(v) for v in e.values()}) >= 8      # the bodies differ


@pytest.mark.parametrize("npop", [4])
@pytest.mark.parametrize("body", list(glue.BODIES))
def test_body_matches_script(script, tab, body, npop):
    check_body(script, tab, body, npop)


def test_shared_semantics_and_components(script):
    check_shared_semantics(script, 4)
    ns = {b: float(i) for i, b in enumerate(glue.BODIES)}
    c = glue.components(ns)
    assert set(c) == set(glue.COMPONENTS) and c["xb_saving_ns"] == ns["full"] - ns["xb"]
    assert set(glue.components({k: ns[k] for k in glue.PROBES_ONLY})) == {
        "xs_saving_ns", "xb_saving_ns"}


def test_plain_stacks_and_packets(tab):
    """At packet 1 the chains differ per ray; the stacks' top entries are
    written; the two-ended stack's leaf side moves down from 500."""
    for body in ("full", "sel1stack", "ranksel", "rankdual", "nopush1"):
        for npop in glue.NPOPS:
            p1 = glue.glue_plain(tab, body, npop, 3, 1)
            assert p1["e"].unique().numel() > 8 and (p1["top"] != 0).any(), (body, npop)
    small = inner.probe_tables("cpu", [p[:, :8] for p in fixtures.overlap_rays()])
    microbench.reset_launch_counts()
    for body in ("full", "xb", "ranksel"):
        r = glue.probe(small, body, 4, 2, 32, n=128)
        p = glue.glue_plain(small, body, 4, 2, 32, 128)
        assert all(torch.equal(r[k], p[k]) for k in ("e", "acc", "top"))
        assert torch.equal(r["e"][:32], r["e"][:1].expand(32))
    assert microbench.LAUNCHES["glue"] == 0 and not microbench.INSTANCE_LAUNCHES


@pytest.mark.parametrize("npop", glue.NPOPS)
def test_read_bytes_and_pushes(tab, npop):
    """The bound's bytes: the rays, per distinct row the chains visit its
    24 box floats and the 4 encodings the body reads (vec none, noextract
    one of row e); the bodies that push are those whose stacks are written,
    one store per child and stack."""
    rays = 4 * sum(p.numel() for p in tab.planes)
    for body in glue.BODIES:
        visited = []
        r = glue.glue_plain(tab, body, npop, KS[1], 1, visited=visited)
        assert len(visited) == KS[1] and not visited[0].any()
        e = torch.cat(visited)
        rows = torch.unique(torch.cat([(e + 3 * i) % inner.N_NODES for i in range(npop)]))
        meta = {"vec": 0, "noextract": torch.unique(e).numel()}.get(body, 4 * rows.numel())
        assert glue.read_bytes(tab, body, npop, visited) == rays + 96 * rows.numel() + 4 * meta
        assert (glue.pushes(body, npop) > 0) == bool((r["top"] != 0).any()), body
    assert glue.pushes("full", npop) == glue.pushes("xb", npop) == 8 * npop
    assert glue.pushes("ranksel", npop) == 4 * npop and glue.pushes("nopush", npop) == 0


def test_instances_and_refusals(tab):
    names = {i.name for i in glue.glue_instances()}
    assert len(names) == 68 and names == glue.INSTANCES
    assert "glue<full,npop8,p32,stack=shared>" in names
    assert "glue<xb,npop4,p1,meta=global>" in names
    with pytest.raises(ValueError, match="no such instance"):
        glue.probe(tab, "full", 6, 1, 1)
    with pytest.raises(ValueError, match="no such instance"):
        glue.probe(tab, "nosort", 4, 1, 1, stack="shared")
    with pytest.raises(ValueError):
        glue.probe(tab, "fullx", 4, 1, 1)


@pytest.mark.parametrize("probes_only", [False, True])
def test_entry_point_on_cpu(probes_only, tmp_path, capsys):
    microbench.reset_launch_counts()
    argv = ["glue", "--device", "cpu", "--out", str(tmp_path)] + (
        ["--probes-only"] if probes_only else [])
    assert mb_main(argv) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["device"] == "cpu"
    assert '"ns' not in json.dumps(lines)
    bodies = glue.PROBES_ONLY if probes_only else tuple(glue.BODIES)
    assert len(lines) - 1 == len(bodies) * 4
    full = next(r for r in lines[1:] if r["instance"] == "glue<full,npop4,p32>")
    assert full["e_packet_1024"] == 192
    assert all(v == 0 for v in microbench.LAUNCHES.values())

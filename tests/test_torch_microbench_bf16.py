"""Rows 15e-15h (parallel_ray_tracer_tpu_torch/microbench/bf16.py) against
scripts/microbench_bf16.py, on the CPU.

The script is loaded from its file inside a fixture that restores the three
jax.config cache values it sets on import. Its benchmark functions run
unchanged, with three names of the loaded module substituted: `_time_loop`
captures (kernel, inputs) instead of timing them; `pl` is Pallas with
`pallas_call(..., interpret=True)`, whose kernel also writes the final
carry of the script's `fori_loop` to extra outputs; `jax` is JAX with a
`lax.fori_loop` that records that carry. So each of the four pallas_call
sites runs its own kernel body at K iterations, and the test reads the
script's output (out[0, 0]) and the whole final tile, or the slab's loop
index e (the script's output, acc + e, is T_MAX whatever e is).

- Fixtures: `_rand` (f32 and bf16, every shape of `main`) and `_box_rows`
  bit for bit.
- Chains (15e, 15f): every (op, shape, dtype) of `main`, both ILP sets,
  and the two bf16 ILP cases the port adds, at K = 3. The port's plain
  version equals a numpy walk that rounds after every op, bit for bit. In
  the script's interpret run XLA rounds every bf16 op too, so the bf16
  chains and the min-max chains equal the plain version bit for bit; but
  XLA's CPU code contracts the f32 a * b - b into one fused multiply-add
  (the script's tile equals a numpy walk with one rounding per op, bit for
  bit), where the port keeps the two rounded ops of the script's source;
  and in the two added bf16 ILP cases the script's out[0, 0] keeps the
  chains' sum in excess precision (it is converted to f32 at once), where
  the port rounds each add to bf16: there the chains and their bf16 sum
  are held bit for bit, and out[0, 0] to one bf16 ulp (2^-7 relative).
  There the f32 mul-sub tiles agree on which elements overflow, and the
  finite ones within 1e-4 of the sum of the chains' magnitudes (measured:
  3.8e-5 relative for one chain; the chain amplifies each op's half-ulp
  difference, and the ILP sum's cancellation is not charged to it).
- Slab pairs (15g, 15h): e after K = 1, 2, 3 iterations with the script's
  rays (all six planes the same values, so the rays lie on one line and e
  rarely branches) and after K = 3, 10 with the overlap script's normal
  rays, from the script's kernel against the plain version with the
  script's 1,024-ray packet: equal. The wrapper on the CPU runs the plain
  version with the kernel's 32-ray packets.
- The entry point's `bf16` command with --device cpu.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from parallel_ray_tracer_tpu_torch import microbench
from parallel_ray_tracer_tpu_torch.microbench import bf16, fixtures
from parallel_ray_tracer_tpu_torch.microbench.__main__ import main as mb_main

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")
OPS = {"fms": lambda a, b: a * b - b,
       "mnx": lambda a, b: jnp.minimum(jnp.maximum(a, b), b + a)}


@pytest.fixture(scope="module")
def script():
    """scripts/microbench_bf16.py as a module, with JAX's cache settings
    restored."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_script_microbench_bf16", os.path.join(REPO, "scripts", "microbench_bf16.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


class _Capture:
    """The substitutes for the loaded script's `jax`, `pl` and `_time_loop`."""

    def __init__(self, extra):
        self.extra = extra          # ShapeDtypeStructs of the fori_loop carry
        self.carry = None
        self.fn = self.args = None
        cap = self

        class Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def fori_loop(self, lo, hi, body, init):
                cap.carry = jax.lax.fori_loop(lo, hi, body, init)
                return cap.carry

        class Jax:
            lax = Lax()

            def __getattr__(self, name):
                return getattr(jax, name)

        class Pl:
            def __getattr__(self, name):
                return getattr(pl, name)

            def pallas_call(self, kernel, out_shape, in_specs, out_specs):
                n_in = len(in_specs)

                def body(*refs):
                    kernel(*refs[:n_in + 1])
                    for ref, leaf in zip(refs[n_in + 1:], jax.tree_util.tree_leaves(cap.carry)):
                        if ref.shape == (1, 1):
                            ref[0, 0] = leaf
                        else:
                            ref[...] = leaf

                specs = [pl.BlockSpec(memory_space=pltpu.SMEM if s.shape == (1, 1)
                                      else pltpu.VMEM) for s in extra]
                return pl.pallas_call(body, out_shape=(out_shape, *extra), in_specs=in_specs,
                                      out_specs=(out_specs, *specs), interpret=True)

        self.jax, self.pl = Jax(), Pl()

    def time_loop(self, kernel, args, **_):
        self.fn, self.args = kernel, args
        return 1.0

    def install(self, mod, monkeypatch):
        monkeypatch.setattr(mod, "jax", self.jax)
        monkeypatch.setattr(mod, "pl", self.pl)
        monkeypatch.setattr(mod, "_time_loop", self.time_loop)

    def run(self, k, args=None):
        return self.fn(jnp.asarray([k], jnp.int32), *(self.args if args is None else args))


# ---- fixtures ---------------------------------------------------------------------


@pytest.mark.parametrize("rows", [8, 16, 32])
def test_rand_identical(script, rows):
    shape = (rows, 128)
    np.testing.assert_array_equal(np.asarray(script._rand(shape, jnp.float32)).view(np.uint32),
                                  fixtures.bf16_rand(shape).view(np.uint32))
    np.testing.assert_array_equal(np.asarray(script._rand(shape, jnp.bfloat16)).view(np.uint16),
                                  fixtures.bf16_rand(shape, bf16=True))


def test_box_rows_identical(script):
    rows = fixtures.bf16_box_rows()
    np.testing.assert_array_equal(np.asarray(script._box_rows(jnp.float32)).view(np.uint32),
                                  rows.view(np.uint32))
    a, b = bf16.chain_inputs(16, True, "cpu")
    assert torch.equal(b.float(), a.float() * 0.5)          # b = a / 2, exactly


# ---- the chains (15e, 15f) -----------------------------------------------------------


def _numpy_walk(a, b, op, iters, ilp, bf16_, fused):
    """The chain in numpy, rounding to the tile's type after every op; with
    `fused`, a * b - b rounds once (an FMA, computed in f64)."""
    dt = ml_dtypes.bfloat16 if bf16_ else np.float32

    def r(x):
        return np.asarray(x, np.float32).astype(dt).astype(np.float32)

    def step(x):
        if op == "mnx":
            return np.minimum(np.maximum(x, b), r(b + x))
        if fused:
            return r(x.astype(np.float64) * b - b)
        return r(r(x * b) - b)

    with np.errstate(over="ignore", invalid="ignore"):
        chains = [a if k == 0 else r(a + k) for k in range(ilp)]
        for _ in range(iters * bf16.N_OPS):
            chains = [step(c) for c in chains]
        acc = chains[0]
        for c in chains[1:]:
            acc = r(acc + c)
    return acc


def _bits(x):
    x = np.asarray(x, np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), x).view(np.uint32)


@pytest.mark.parametrize("case", list(bf16.CHAIN_CASES))
def test_chain_matches_script(script, case, monkeypatch):
    op, rows, is_bf16, ilp = bf16.CHAIN_CASES[case]
    shape, dt = (rows, 128), (jnp.bfloat16 if is_bf16 else jnp.float32)
    cap = _Capture([jax.ShapeDtypeStruct(shape, dt)] * ilp)
    cap.install(script, monkeypatch)
    if ilp == 1:
        script._chain_bench(case, shape, dt, OPS[op])
    else:
        script._chain_bench_ilp(case, shape, dt, OPS[op])
    out, *tiles = cap.run(K)
    s_tile = np.asarray(tiles[0], np.float32)
    if ilp > 1:      # the script sums its chains after the loop, as the port does
        acc = tiles[0]
        for t in tiles[1:]:
            acc = acc + t
        s_tile = np.asarray(acc, np.float32)
    s_out = float(np.asarray(out)[0, 0])
    if is_bf16 and ilp > 1:
        # The script's own output keeps the in-kernel sum in excess
        # precision (XLA: the bf16 sum is converted to f32 at once); the
        # port rounds each add to bf16, as the kernel's __hadd2 does.
        m = float(s_tile.max())
        assert s_out == m or abs(s_out - m) <= 2.0 ** -7 * abs(m), (s_out, m)
    else:
        assert s_out == float(s_tile.max())

    a, b = bf16.chain_inputs(rows, is_bf16, "cpu")
    p_tile = bf16.chain(a, b, op, K, ilp)[0]
    assert p_tile.dtype == a.dtype and tuple(p_tile.shape) == shape
    p = p_tile.float().numpy()
    walk = _numpy_walk(a.float().numpy(), b.float().numpy(), op, K, ilp, is_bf16, fused=False)
    np.testing.assert_array_equal(_bits(p), _bits(walk))
    if op == "mnx":
        assert np.isfinite(p).all()          # no NaN: the kernel's min/max agree
    if op == "fms" and not is_bf16:
        fused = _numpy_walk(a.numpy(), b.numpy(), op, K, ilp, False, fused=True)
        np.testing.assert_array_equal(_bits(s_tile), _bits(fused))
        np.testing.assert_array_equal(np.isinf(s_tile), np.isinf(p))
        fin = np.isfinite(p)
        with np.errstate(over="ignore"):
            scale = sum(np.abs(np.asarray(t, np.float32)) for t in tiles)   # the chains' sizes
        err = np.abs(p[fin] - s_tile[fin]) / scale[fin]
        assert err.max() < 1e-4, err.max()
        assert not np.array_equal(_bits(p), _bits(s_tile))   # the contraction shows
    else:
        np.testing.assert_array_equal(_bits(p), _bits(s_tile))
        if not (is_bf16 and ilp > 1):
            assert bf16.script_output(p_tile) == float(np.asarray(out)[0, 0])


def test_chain_refusals():
    a, b = bf16.chain_inputs(8, True, "cpu")
    with pytest.raises(ValueError, match="no such instance"):
        bf16.chain(a, b, "mnx", K, 4)                 # bf16 (8, 128) ILP 4 is not built
    with pytest.raises(ValueError):
        bf16.chain(a, b, "fma", K)
    with pytest.raises(TypeError):
        bf16.chain(a, b.float(), "fms", K)
    tiles = bf16.chain(a, b, "fms", 1, blocks=3)
    assert tiles.shape == (3, 8, 128) and torch.equal(tiles[0].float(), tiles[2].float())


# ---- the slab pairs (15g, 15h) -----------------------------------------------------------


@pytest.mark.parametrize("fmt", ["f32", "bf16"])
def test_slab_matches_script(script, fmt, monkeypatch):
    is_bf16 = fmt == "bf16"
    cap = _Capture([jax.ShapeDtypeStruct((1, 1), jnp.int32),
                    jax.ShapeDtypeStruct((1, 1), jnp.float32)])
    cap.install(script, monkeypatch)
    rows_j = script._box_rows(jnp.float32)
    (script._slab_pair_bf16 if is_bf16 else script._slab_pair_f32)(rows_j)
    rows, planes = bf16.slab_inputs("cpu")
    normal = tuple(torch.from_numpy(p.reshape(-1)) for p in fixtures.overlap_rays())
    runs = [(planes, k) for k in (1, 2, K)] + [(normal, k) for k in (K, 10)]
    branched = 0
    for pls, k in runs:
        args = (rows_j,) + tuple(jnp.asarray(p.numpy().reshape(8, 128)) for p in pls)
        out, e, acc = cap.run(k, args)
        assert float(np.asarray(out)[0, 0]) == np.float32(3.4028235e38)   # acc + e
        want = int(np.asarray(e)[0, 0])
        got = bf16.slab_plain(rows, pls, is_bf16, k, 1024)
        assert got.tolist() == [want], (k, want, got)
        branched += want != k
    assert branched > 0                     # some packet minimum of L beat R's
    # the wrapper: 32-ray packets, tiled over n threads
    e32 = bf16.slab(rows, normal, is_bf16, K, n=2048)
    assert e32.dtype == torch.int32 and e32.shape == (64,)
    assert torch.equal(e32[:32], bf16.slab_plain(rows, normal, is_bf16, K, 32))
    assert torch.equal(e32[:32], e32[32:])


def test_slab_refusals():
    rows, planes = bf16.slab_inputs("cpu")
    with pytest.raises(ValueError):
        bf16.slab(rows, planes, False, K, n=1000)
    with pytest.raises(ValueError):
        bf16.slab(rows[:100], planes, False, K)


# ---- the entry point ---------------------------------------------------------------------


def test_bf16_entry_point_on_cpu(tmp_path, capsys):
    microbench.reset_launch_counts()
    assert mb_main(["bf16", "--device", "cpu", "--out", str(tmp_path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["device"] == "cpu"
    text = json.dumps(lines)
    assert '"ns' not in text and '"ms' not in text                # no times on the CPU
    cases = {r["case"]: r for r in lines[1:]}
    assert set(cases) == set(bf16.CHAIN_CASES) | set(bf16.SLAB_CASES)
    assert cases["minmax_bf16_16x128"]["finite_frac"] == 1.0
    assert cases["slab2_f32"]["e_packet_1024"] == K
    saved = json.load(open(tmp_path / "bf16.json"))
    assert saved["records"] == lines[1:]
    assert microbench.LAUNCHES["chain"] == 0 and not microbench.INSTANCE_LAUNCHES   # plain only

"""The microbench probes (parallel_ray_tracer_tpu_torch/microbench/) against
the scripts they port, on the CPU.

The scripts (scripts/microbench_mxu_leaf.py, scripts/microbench_overlap.py)
are loaded from their files inside a fixture: importing one points JAX's
compilation cache at the repository with a 0 s threshold, so the three
config values are restored right after.

- Fixtures: the port's numpy copies give the scripts' arrays bit for bit
  (bf16 arrays as uint16 bits).
- Kernel A (15a): the scripts' stage bodies run in interpret mode
  (`pl.pallas_call(body, ..., interpret=True)`) at K = 3 visits of the
  rand_fixture tables, against the port's plain version with every lane on
  the packet's groups (distinct = 1): `vpu_kernel` (mode "mt"), `v2_kernel`
  in f32 ("f32") and in bf16 ("bf16"), `v5_kernel` with full False and True
  ("bf16x3"), `v6_kernel_t2` ("bf16x3"). The scripts' v2/v5/v6 take R as an
  input: they get build_rmat of the fixture's rays, from which the port's
  kernels build R themselves. Bounds (tests/test_pallas_trace.py:61-62, and
  tests/test_torch_mxu.py for the bf16 modes): miss masks equal, t within
  atol 1e-4 and rtol 1e-5.
- The accuracy table: hits, disagreements and the largest relative t error
  of one bf16 pass, bf16x3 and the f32 product, on the dense and the random
  fixture, against the same quantities computed with the script's
  build_cmat, build_rmat, split_bf16 and _mt_scalar_tri: hits and
  disagreements equal, the error within 5e-7 plus 1% (the products sum in
  another order).
- Kernel D (15d): the script's bodies (body_inner, body_leaf_c, body_leaf_o,
  body_both_c, re-created from `_inner8` and `_loop_kernel`) at K = 3 on a
  packet of one repeated ray, whose packet-wide loop index is the port's
  per-warp one; the checksum out[0, 0] within atol 1e-3 (t within the
  bounds above, e, idx and nd integers). The leaf steps of one iteration
  per ray on the script's own packet, and _inner8's push count for single
  rays: t as above, idx and blocked equal, counts and top entries equal.
  A leaf without its Cl.Rh product breaks chip_smoke.py's bound on the
  overlap kernel's t (1e-6 + 1e-5 |t|) on at least 99% of the hit rays.
- Kernels B and C (15b, 15c): the staged rows read back (against
  probe_pad's kernel body in interpret mode), and the gather's chains and
  sums against a plain numpy walk.
- The entry point runs each command with --device cpu.
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
from parallel_ray_tracer_tpu_torch.microbench import fixtures, mxu_leaf, overlap, probes
from parallel_ray_tracer_tpu_torch.microbench.__main__ import main as mb_main

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
T_MAX = np.float32(3.4028235e38)
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module")
def scripts():
    """The two scripts as modules, with JAX's cache settings restored."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path = list(sys.path)
    mods = {}
    try:
        for name in ("microbench_mxu_leaf", "microbench_overlap"):
            spec = importlib.util.spec_from_file_location(
                f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mods


def _bits(a):
    return np.asarray(a).view(np.uint16)


def _assert_t(t_jax, t_port):
    """Miss masks equal; t within atol 1e-4, rtol 1e-5 where both hit."""
    tj = np.asarray(t_jax, np.float32).reshape(-1)
    tp = t_port.numpy().reshape(-1)
    mj, mp = tj >= T_MAX, tp >= T_MAX
    np.testing.assert_array_equal(mj, mp)
    np.testing.assert_allclose(tp[~mp], tj[~mj], atol=1e-4, rtol=1e-5)


# ---- fixtures ---------------------------------------------------------------------


def test_rand_fixture_identical(scripts):
    _, planes, tri, rmat, cmat = scripts["microbench_mxu_leaf"].rand_fixture()
    fx = fixtures.rand_fixture()
    for a, b in zip([*planes, tri, rmat, cmat], [*fx.planes, fx.tri, fx.rmat, fx.cmat]):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32), b.view(np.uint32))


def test_split_bf16_identical(scripts):
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.randint(-20, 20, 4000),
                        [0.0, -0.0, 1.0, 65504.0, 3.4e38, -3.4e38, 1e-40]]).astype(np.float32)
    hi, lo = scripts["microbench_mxu_leaf"].split_bf16(jnp.asarray(x))
    ph, pl_ = fixtures.split_bf16(x)
    np.testing.assert_array_equal(_bits(hi), ph)
    np.testing.assert_array_equal(_bits(lo), pl_)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "random"])
def test_accuracy_fixture_identical(scripts, dense, monkeypatch):
    """The script builds its fixture inside accuracy_check: its build_cmat and
    build_rmat calls are recorded, and their results compared."""
    mod = scripts["microbench_mxu_leaf"]
    seen = {}
    cm, rm = mod.build_cmat, mod.build_rmat
    monkeypatch.setattr(mod, "build_cmat", lambda *a: seen.setdefault("c", (a, cm(*a)))[1])
    monkeypatch.setattr(mod, "build_rmat", lambda *a: seen.setdefault("r", (a, rm(*a)))[1])
    mod.accuracy_check(kinds=(), dense=dense)
    fx = fixtures.accuracy_fixture(dense)
    (v0, e1, e2), cmat = seen["c"]
    (o, d), rmat = seen["r"]
    for a, b in ((v0, fx.v0), (e1, fx.e1), (e2, fx.e2), (o, fx.o), (d, fx.d),
                 (cmat, fixtures.build_cmat(fx.v0, fx.e1, fx.e2)),
                 (rmat, fixtures.build_rmat(fx.o, fx.d))):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32), b.view(np.uint32))


def test_overlap_fixtures_identical(scripts):
    mod = scripts["microbench_overlap"]
    rays = mod._rays()
    for a, b in zip(rays, fixtures.overlap_rays()):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32), b.view(np.uint32))
    qbox, qmeta = mod._boxes()
    pbox, pmeta = fixtures.overlap_boxes()
    np.testing.assert_array_equal(np.asarray(qbox).view(np.uint32), pbox.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(qmeta), pmeta)
    np.testing.assert_array_equal(_bits(mod._cmat()), fixtures.overlap_cmat())
    for a, b in zip(mod._rmats(rays), fixtures.overlap_rmats(fixtures.overlap_rays())):
        np.testing.assert_array_equal(_bits(a), b)


# ---- kernel A: the leaf visit -------------------------------------------------------


def _leaf_case(mod, case, fx):
    """(script kernel, its inputs, port mode, full) of one case."""
    o = np.stack([p.reshape(-1) for p in fx.planes[:3]], axis=1)
    d = np.stack([p.reshape(-1) for p in fx.planes[3:]], axis=1)
    rmat = jnp.asarray(mod.build_rmat(o, d))
    cmat = jnp.asarray(fx.cmat)
    ch, cl = mod.split_bf16(cmat)
    if case == "vpu":
        return mod.vpu_kernel(K), [*map(jnp.asarray, fx.planes), jnp.asarray(fx.tri)], "mt", False
    if case == "v2_f32":
        return mod.v2_kernel(K, 32, jnp.float32), [rmat, cmat], "f32", False
    if case == "v2_bf16":
        return mod.v2_kernel(K, 32, jnp.bfloat16), [rmat, cmat], "bf16", False
    if case in ("v5", "v5_full"):
        full = case == "v5_full"
        return mod.v5_kernel(K, full), [rmat, ch, cl], "bf16x3", full
    return (mod.v6_kernel_t2(K), [rmat, jnp.concatenate([ch, cl], axis=1)], "bf16x3", False)


@pytest.mark.parametrize("case", ["vpu", "v2_f32", "v2_bf16", "v5", "v5_full", "v6_t2"])
def test_leaf_plain_matches_script(scripts, case):
    mod = scripts["microbench_mxu_leaf"]
    fx = fixtures.rand_fixture()
    body, ins, mode, full = _leaf_case(mod, case, fx)
    t_jax = pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(ins),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(*ins)
    tab = mxu_leaf.leaf_tables(fx.planes, fx.tri, fx.cmat, "cpu")
    t, idx = mxu_leaf.leaf_visits(tab, mode, iters=K, full=full, layout="interleaved")
    _assert_t(t_jax, t)
    assert int((t < T_MAX).sum()) > 0
    if full:      # the winner: a slot of a visited group, where it hit
        hit = t < T_MAX
        assert bool((idx[hit] >= 0).all() and (idx[hit] < K * 8).all())
        assert bool((idx[~hit] == -1).all())


def _jax_accuracy(mod, fx, kind):
    """accuracy_check's quantities with the script's functions; the one-pass
    bf16 product as v2_kernel(dtype=bfloat16) computes it."""
    from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as JVec3

    ov = JVec3(*(jnp.asarray(fx.o[:, k].reshape(8, 128)) for k in range(3)))
    dv = JVec3(*(jnp.asarray(fx.d[:, k].reshape(8, 128)) for k in range(3)))
    row = jnp.asarray(fixtures.tri_row(fx.v0, fx.e1, fx.e2))
    t_ref = np.minimum.reduce([np.asarray(mod._mt_scalar_tri(ov, dv, row, j)[0])
                               for j in range(8)])
    C = jnp.asarray(mod.build_cmat(fx.v0, fx.e1, fx.e2))
    R = jnp.asarray(mod.build_rmat(fx.o, fx.d))
    if kind == "bf16":
        outm = mod._dot(C.astype(jnp.bfloat16), R.astype(jnp.bfloat16))
    elif kind == "bf16x3":
        Ch, Cl = mod.split_bf16(C)
        Rh, Rl = mod.split_bf16(R)
        outm = mod._dot(Ch, Rh) + mod._dot(Ch, Rl) + mod._dot(Cl, Rh)
    else:
        outm = mod._dot(C, R, precision=jax.lax.Precision.HIGHEST)
    outm = np.asarray(outm)
    det, tn, un, vn = outm[0:8], outm[8:16], outm[16:24], outm[24:32]
    with np.errstate(divide="ignore", invalid="ignore"):
        tj, u, v = tn / det, un / det, vn / det
    hit = (np.abs(det) >= 1e-3) & (tj > 1e-3) & (u >= 0) & (v >= 0) & (u + v <= 1)
    tm = np.where(hit, tj, T_MAX).min(axis=0).reshape(8, 128)
    both = (t_ref < T_MAX) & (tm < T_MAX)
    rel = np.abs(tm - t_ref)[both] / np.maximum(t_ref[both], 1e-6)
    return {"hits_ref": int((t_ref < T_MAX).sum()),
            "disagree": int(((t_ref < T_MAX) != (tm < T_MAX)).sum()),
            "max_rel_t_err": float(rel.max()) if rel.size else 0.0}


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "random"])
def test_accuracy_table_matches_script(scripts, dense):
    mod = scripts["microbench_mxu_leaf"]
    fx = fixtures.accuracy_fixture(dense)
    port = mxu_leaf.accuracy(dense, "cpu")
    for kind in mxu_leaf.ACCURACY_KINDS:
        want = _jax_accuracy(mod, fx, kind)
        got = port[kind]
        assert (got["hits_ref"], got["disagree"]) == (want["hits_ref"], want["disagree"]), kind
        assert abs(got["max_rel_t_err"] - want["max_rel_t_err"]) <= \
            5e-7 + 0.01 * want["max_rel_t_err"], (kind, got, want)
    assert port["bf16"]["max_rel_t_err"] > port["bf16x3"]["max_rel_t_err"]


def test_leaf_refusals():
    tab = mxu_leaf.rand_tables("cpu")
    with pytest.raises(ValueError, match="no leaf instance"):
        mxu_leaf.leaf_visits(tab, "mt", iters=1, layout="two_tables")
    with pytest.raises(ValueError, match="distinct"):
        mxu_leaf.leaf_visits(tab, "bf16x3", iters=1, distinct=3)
    with pytest.raises(ValueError, match="multiple of 128"):
        mxu_leaf.leaf_visits(tab, "mt", iters=1, n=100)


def test_lane_windows_and_tiling():
    """Distinct groups per warp: lane classes start G / D apart; thread i
    takes ray i % n_src; the CPU path launches nothing."""
    win = mxu_leaf.ring_windows(512, 4, 3)
    assert win[0].tolist() == [0, 1, 2] and win[8].tolist() == [128, 129, 130]
    assert win[31].tolist() == [384, 385, 386]
    tab = mxu_leaf.rand_tables("cpu")
    microbench.reset_launch_counts()
    t1, i1 = mxu_leaf.leaf_visits(tab, "bf16x3", iters=2, n=2048, full=True, distinct=32)
    assert torch.equal(t1[:1024], t1[1024:]) and torch.equal(i1[:1024], i1[1024:])
    assert all(v == 0 for v in microbench.LAUNCHES.values())
    # every lane of a warp on its own groups: lane 5 visits 80, 81
    hit = i1[5]
    assert int(hit) == -1 or int(hit) // 8 in (80, 81)


# ---- kernel D: inner visits and leaf steps ---------------------------------------


def _overlap_bodies(mod):
    """The script's main bodies, as its main defines them."""
    T = float(T_MAX)
    mx = mod._mxu_leaf_closest_n

    def gs_of(e, n=4):
        return [(e + 11 * i) % mod.N_GROUPS for i in range(n)]

    def body_inner(scene, stack, o, d, inv, oi, e, t, idx, nd):
        qbox, qmeta = scene
        sp, tacc = mod._inner8(qbox, qmeta, oi, inv, jnp.float32(T), stack, e, jnp.float32(0))
        return e + sp + stack[0], t + tacc * 0.0, idx, nd

    def body_leaf_c(scene, stack, o, d, inv, oi, e, t, idx, nd):
        cmi, Rh, Rl = scene
        t, idx, nd, _ = mx(cmi, Rh[:, :], Rl[:, :], gs_of(e), t, idx, nd, 8)
        return e + idx[0, 0] + 1, t, idx, nd

    def body_leaf_o(scene, stack, o, d, inv, oi, e, t, idx, nd):
        cmi, Rh, Rl = scene
        nd = mod._mxu_leaf_occluded_n(cmi, Rh[:, :], Rl[:, :], gs_of(e), nd, t * t)
        return e + nd[0, 0] + 1, t, idx, nd

    def body_both_c(scene, stack, o, d, inv, oi, e, t, idx, nd):
        qbox, qmeta, cmi, Rh, Rl = scene
        t, idx, nd, _ = mx(cmi, Rh[:, :], Rl[:, :], gs_of(e), t, idx, nd, 8)
        sp, _ = mod._inner8(qbox, qmeta, oi, inv, jnp.float32(T), stack, e + 1, jnp.float32(0))
        return e + sp + idx[0, 0] + stack[0], t, idx, nd

    return {"inner8": (body_inner, "boxes"), "leaf4_closest": (body_leaf_c, "leaf"),
            "leaf4_occluded": (body_leaf_o, "leaf"), "both_closest": (body_both_c, "both")}


def _repeated(ray):
    rays = fixtures.overlap_rays()
    return [np.full(fixtures.PACKET, p.reshape(-1)[ray], np.float32) for p in rays]


@pytest.mark.parametrize("body", ["inner8", "leaf4_closest", "leaf4_occluded", "both_closest"])
def test_overlap_plain_matches_script_bodies(scripts, body):
    mod = scripts["microbench_overlap"]
    fn, scene_kind = _overlap_bodies(mod)[body]
    rays = _repeated(77)     # a ray that the closest bodies see hit
    qbox, qmeta = mod._boxes()
    Rh, Rl = mod._rmats([jnp.asarray(r) for r in rays])
    scene = {"boxes": [qbox, qmeta], "leaf": [mod._cmat(), Rh, Rl],
             "both": [qbox, qmeta, mod._cmat(), Rh, Rl]}[scene_kind]
    n_scene = len(scene)
    specs = ([pl.BlockSpec(memory_space=pltpu.SMEM)]
             + [pl.BlockSpec(memory_space=pltpu.VMEM)] * (n_scene + 6))
    out = pl.pallas_call(
        mod._loop_kernel(fn, n_scene), out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        in_specs=specs, out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=[pltpu.SMEM((256,), jnp.int32)], interpret=True,
    )(jnp.asarray([K], jnp.int32), *scene, *map(jnp.asarray, rays))
    r = overlap.overlap_plain(overlap.overlap_tables("cpu", rays), body, K)
    checksum = np.float32(r["t"][0].item()) + np.float32(r["e"][0] + r["idx"][0] + r["nd"][0])
    np.testing.assert_allclose(np.float32(out[0, 0]), checksum, atol=1e-3, rtol=1e-5)
    assert torch.equal(r["e"], r["e"][:1].expand_as(r["e"]))    # one index per packet
    if "closest" in body:
        assert float(r["t"][0]) < T_MAX


def test_overlap_leaf_steps_match_script(scripts):
    """One closest and one any-hit leaf step (groups 0, 11, 22, 33) per ray
    of the script's own packet."""
    mod = scripts["microbench_overlap"]
    rays = [jnp.asarray(r) for r in fixtures.overlap_rays()]
    Rh, Rl = mod._rmats(rays)
    cmi = mod._cmat()
    gs = [0, 11, 22, 33]
    shape = fixtures.PACKET

    def kern(cmi_r, rh_r, rl_r, t_o, i_o, n_o, b_o):
        t, idx, nd, _ = mod._mxu_leaf_closest_n(
            cmi_r, rh_r[:, :], rl_r[:, :], gs, jnp.full(shape, T_MAX, jnp.float32),
            jnp.full(shape, -1, jnp.int32), jnp.zeros(shape, jnp.int32), 8)
        t_o[:, :], i_o[:, :], n_o[:, :] = t, idx, nd
        b_o[:, :] = mod._mxu_leaf_occluded_n(
            cmi_r, rh_r[:, :], rl_r[:, :], gs, jnp.zeros(shape, jnp.int32),
            jnp.full(shape, jnp.inf, jnp.float32))

    outs = pl.pallas_call(
        kern, out_shape=[jax.ShapeDtypeStruct(shape, jnp.float32)]
        + [jax.ShapeDtypeStruct(shape, jnp.int32)] * 3,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4, interpret=True)(cmi, Rh, Rl)
    tab = overlap.overlap_tables("cpu")
    c = overlap.overlap_plain(tab, "leaf4_closest", 1)
    o = overlap.overlap_plain(tab, "leaf4_occluded", 1)
    _assert_t(outs[0], c["t"])
    hit = c["t"].numpy() < T_MAX
    assert hit.sum() > 0
    np.testing.assert_array_equal(np.asarray(outs[1]).reshape(-1)[hit], c["idx"].numpy()[hit])
    np.testing.assert_array_equal(np.asarray(outs[2]).reshape(-1)[hit], c["nd"].numpy()[hit])
    np.testing.assert_array_equal(np.asarray(outs[3]).reshape(-1), o["nd"].numpy())


@pytest.mark.parametrize("body", ["leaf4_closest", "both_closest", "both_closest6"])
def test_overlap_t_bound_sees_a_leaf_without_lo_products(body, monkeypatch):
    """chip_smoke.py holds the overlap kernel's closest-hit t to its plain
    version within 1e-6 + 1e-5 |t| where both hit with the same idx. A leaf
    that drops the Cl.Rh product (two bf16 passes in place of three) breaks
    that bound on the script's packet at K = 3: t moves by more than 1e-2
    somewhere, and beyond the bound on at least 99% of those rays."""
    tab = overlap.overlap_tables("cpu")
    ref = overlap.overlap_plain(tab, body, K)

    def two_passes(tab, rh, rl, g_ray):
        hi = tab.cmat.reshape(-1, 32, 32)[g_ray].float()[..., :16]
        q = torch.einsum("nrk,nk->nr", hi, rh) + torch.einsum("nrk,nk->nr", hi, rl)
        return q.reshape(-1, 4, 8).transpose(1, 2)

    monkeypatch.setattr(overlap, "_leaf_quants", two_passes)
    bad = overlap.overlap_plain(tab, body, K)
    same = (ref["t"] < T_MAX) & (bad["t"] < T_MAX) & (ref["idx"] == bad["idx"])
    assert same.sum() > 500
    dt = (bad["t"] - ref["t"]).abs()[same]
    beyond = dt > 1e-6 + 1e-5 * ref["t"][same].abs()
    assert dt.max().item() > 1e-2
    assert beyond.float().mean().item() >= 0.99


@pytest.mark.parametrize("ray", [2, 11, 64])
def test_inner8_push_count_matches_script(scripts, ray):
    """_inner8's push count and top stack entry from node rows 0, 37, ... for
    one ray (a packet of it repeated) against the port's plain version;
    rays that enter 1-3 child boxes there."""
    mod = scripts["microbench_overlap"]
    rays = _repeated(ray)
    qbox, qmeta = mod._boxes()

    def kern(qb, qm, ox, oy, oz, dx, dy, dz, out, stack):
        d = [dx[:, :], dy[:, :], dz[:, :]]
        inv = mod.Vec3(*(1.0 / c for c in d))
        oi = mod.Vec3(ox[:, :] * inv.x, oy[:, :] * inv.y, oz[:, :] * inv.z)
        sp, _ = mod._inner8(qb, qm, oi, inv, jnp.float32(T_MAX), stack, jnp.int32(0),
                            jnp.float32(0))
        out[0, 0] = sp
        out[0, 1] = stack[sp - 1]

    got = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((1, 2), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 8,
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=[pltpu.SMEM((256,), jnp.int32)], interpret=True,
    )(qbox, qmeta, *map(jnp.asarray, rays))
    r = overlap.overlap_plain(overlap.overlap_tables("cpu", rays), "inner8", 1)
    assert int(r["sp"][0]) == int(got[0, 0]) > 8
    assert int(r["top"][0]) == int(got[0, 1])


# ---- kernels B and C ----------------------------------------------------------------


def test_stage_reads_back_as_probe_pad_kernel(scripts):
    """probe_pad's kernel body reads rows 0..7 of the staged table (x2);
    the port's staged table gives the same rows."""
    c = probes.group_table(3, "f32", "cpu")

    def kern(c_ref, o):
        o[:, :] = c_ref[pl.ds(0, 8), :].astype(jnp.float32) * 2.0

    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((8, 16), jnp.float32), grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(jnp.asarray(c.numpy()))
    back = probes.stage_table(c)
    np.testing.assert_array_equal((back[:8] * 2.0).numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    sweep = probes.stage_sweep(torch.device("cpu"), probes.H100_OPTIN)
    assert all(r["read_back_equal"] for r in sweep)
    assert {r["bytes"] for r in sweep} >= {probes.H100_OPTIN, probes.H100_OPTIN + 64}


def test_gather_plain_follows_the_chains():
    table = probes.gather_table(1, "cpu", seed=4)
    words = table.numpy()
    nb = words.shape[0]
    nxt = words[:, 0]
    assert sorted(nxt.tolist()) == list(range(nb))           # a permutation ...
    b, seen = 0, set()
    for _ in range(nb):
        seen.add(b)
        b = int(nxt[b])
    assert len(seen) == nb and b == 0                        # ... of one cycle
    starts = probes.gather_starts(nb, 48, "cpu")
    last, sums = probes.gather(table, starts, 5)
    for w in (0, 17, 47):
        b, s = int(starts[w]), 0
        for _ in range(5):
            s = (s + int(words[b].astype(np.int64).sum())) % (1 << 32)
            b = int(nxt[b])
        assert int(last[w]) == b
        assert int(sums[w]) & 0xFFFFFFFF == s


# ---- the entry point ----------------------------------------------------------------


@pytest.mark.parametrize("command", ["mxu_leaf", "probes", "overlap"])
def test_entry_point_on_cpu(command, tmp_path, capsys):
    argv = [command, "--device", "cpu", "--out", str(tmp_path)]
    if command == "mxu_leaf":
        argv += ["--stage", "v5"]
    assert mb_main(argv) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["device"] == "cpu" and len(lines) > 1
    text = json.dumps(lines)
    assert '"ns' not in text and '"ms' not in text                # no times on the CPU
    saved = json.load(open(tmp_path / f"{command}.json"))
    assert saved["records"] == lines[1:]

"""Row 15m (parallel_ray_tracer_tpu_torch/microbench/mxu_inner.py) against
scripts/microbench_mxu_inner.py, on the CPU.

The script is loaded and its kernels captured as
tests/test_torch_microbench_tiled.py does (its `_run` with a `pl` whose
pallas_call captures the kernel, its scratch and its tables, `main` in a
temporary directory); each captured kernel then runs in
`pallas_call(..., interpret=True)` with the carry (e, acc) kept after K = 1,
3 and 16 iterations.

- Fixtures: the script's `_tables` bit for bit against
  microbench/fixtures.py: qbox, meta4 and meta8 exactly, each W table's h
  half as bf16 bits, its l half (f32 in the script, rounded by its kernel)
  as the bf16 bits of its rounding.
- Every body (5) against `mxu_inner_plain` at the script's packet of 1,024
  rays, on the script's tables and on the grown ones
  (fixtures.mxu_inner_tables(GROW)): e equal at every K, acc within 1e-5
  relative, both infinite where the script's is. The products: the
  script's bf16 dots with f32 accumulation against the plain version's f32
  matmuls of the bf16 halves; each fragment has two nonzero products, so
  both round their sum once. XLA contracts I and M's `lo * inv - oi` into
  one FMA (the port rounds twice); an ulp could flip a hit near a tie and
  so e, which the test would say, and walk the script's rounding for that
  case. None does on these fixtures at these K.
- The kernels' packets through the script: one ray repeated against the
  plain version at packet 1, the first 32 rays tiled 32 times against it at
  packet 32.
- The wrappers on the CPU, their refusals, the bound's bytes and
  operations, the SASS names, the answers, and the `mxu_inner` command
  with --device cpu.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from parallel_ray_tracer_tpu_torch import microbench
from parallel_ray_tracer_tpu_torch.microbench import fixtures, mxu_inner, sass
from parallel_ray_tracer_tpu_torch.microbench.__main__ import main as mb_main
from parallel_ray_tracer_tpu_torch.ops.pack import bf16_bits
from test_torch_microbench_tiled import KS, assert_acc, capture, packet_rays, run_script

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools


@pytest.fixture(scope="module")
def mscript(tmp_path_factory):
    return capture("microbench_mxu_inner", tmp_path_factory.mktemp("mxu_inner"))


@pytest.fixture(scope="module")
def tabs():
    return {"script": mxu_inner.mxu_tables("cpu"),
            "grown": mxu_inner.mxu_tables("cpu", grow=fixtures.GROW)}


def _scene(tab):
    """The script's five tables from ours: W as f32 [h | l]."""
    return (tab.cbox.numpy(), tab.cmeta.numpy(), tab.w8.float().numpy(), tab.meta8.numpy(),
            tab.w4.float().numpy())


def test_fixtures_identical(mscript, tabs):
    mod, kernels, _ = mscript
    assert set(kernels) == set(mxu_inner.LABELS.values())
    for s, p in zip(mod._rays(), fixtures.overlap_rays()):
        np.testing.assert_array_equal(np.asarray(s).view(np.uint32), p.view(np.uint32))
    qbox, meta4, w8, meta8, w4 = (np.asarray(a) for a in kernels[mxu_inner.LABELS["J"]][3])
    want = fixtures.mxu_inner_tables()
    np.testing.assert_array_equal(qbox.view(np.uint32), want.qbox.view(np.uint32))
    np.testing.assert_array_equal(meta4, want.meta4)
    np.testing.assert_array_equal(meta8, want.meta8)
    for w, bits in ((w8, want.w8), (w4, want.w4)):
        h = bf16_bits(w[:, :16])
        np.testing.assert_array_equal(h, bits[:, :16])
        np.testing.assert_array_equal(h.astype(np.uint32) << 16, w[:, :16].view(np.uint32))
        np.testing.assert_array_equal(bf16_bits(w[:, 16:]), bits[:, 16:])
    assert torch.equal(tabs["script"].w8.view(torch.int16), torch.from_numpy(want.w8.view(np.int16)))
    # the grown tables: the same draws, each box 2 wider on each side
    g = fixtures.mxu_inner_tables(fixtures.GROW)
    np.testing.assert_array_equal(g.qbox, fixtures.grown_boxes(want.qbox))
    np.testing.assert_array_equal(g.meta8, want.meta8)
    w = g.w8.astype(np.uint32) << 16                            # the h halves' f32 bits
    h8 = w[:, :16].view(np.float32).reshape(-1, 6, 8, 16)
    lo_x = want.w8[:, :16].astype(np.uint32) << 16
    assert g.w8.shape == want.w8.shape
    np.testing.assert_array_equal(h8[:, 0, :, 3], -1.0)          # tx1 rows: -1 at oi x
    assert (h8[:, 0, :, 0] < lo_x[:, :16].view(np.float32).reshape(-1, 6, 8, 16)[:, 0, :, 0]).all()


def _plain_hist(tab, body, packet):
    return [mxu_inner.mxu_inner_plain(tab, body, k, packet) for k in KS]


@pytest.mark.parametrize("body", list(mxu_inner.BODIES))
def test_body_matches_script(mscript, tabs, body):
    label = mxu_inner.LABELS[body]
    rays = fixtures.overlap_rays()
    for which, tab in tabs.items():
        scene = _scene(tab)
        he, ha = run_script(mscript, label, scene, rays, 5)
        for j, r in enumerate(_plain_hist(tab, body, 1024)):
            assert int(r["e"][0]) == int(he[j]), (body, which, KS[j], int(r["e"][0]), int(he[j]))
            assert_acc(r["acc"][0].item(), ha[j], (body, which, KS[j]))
        for prays, packet, ray in packet_rays():
            hs, hacc = run_script(mscript, label, scene, prays, 5)
            for j, r in enumerate(_plain_hist(tab, body, packet)):
                assert int(r["e"][ray]) == int(hs[j]), (body, which, packet, KS[j])
                assert_acc(r["acc"][ray].item(), hacc[j], (body, which, packet, KS[j]))


def test_chains_branch_and_push(tabs):
    """The push bodies' chains move with their hits and their top entries
    are written; the vector bodies push nothing."""
    for body in mxu_inner.PUSHES:
        p1 = mxu_inner.mxu_inner_plain(tabs["grown"], body, KS[-1], 1)
        p32 = mxu_inner.mxu_inner_plain(tabs["script"], body, KS[-1], 32)
        assert p1["e"].unique().numel() > 100 and p32["e"].unique().numel() > 10, body
        assert (p1["top"] != 0).any() and (p1["acc"] == 0).all(), body
    for body in ("M", "L"):
        r = mxu_inner.mxu_inner_plain(tabs["grown"], body, KS[-1], 32)
        assert (r["top"] == 0).all() and torch.isfinite(r["acc"]).all(), body


def test_products_are_the_f32_sums():
    """The plain products (Ch.Sh + Ch.Sl) + Cl.Sh of a lo row are its two
    nonzero terms summed in f32 per product: lo_h inv_h - oi_h, lo_h inv_l -
    oi_l, lo_l inv_h."""
    tab = mxu_inner.mxu_tables("cpu")
    pk = mxu_inner.Packets(tab, 32)
    sh, sl = mxu_inner._features(pk)
    rows = torch.zeros((1, 4), dtype=torch.int64)
    ms = mxu_inner._node_minima(tab, pk, rows.expand(pk.q, 4), 8, sh, sl)
    w = tab.w8[:48].float()                                   # node 0: quantity q, child k at 8q + k
    q = torch.stack([(w[r, :16] @ sh.T + w[r, :16] @ sl.T) + w[r, 16:] @ sh.T
                     for r in range(48)]).view(6, 8, -1)
    tmin = torch.maximum(torch.maximum(torch.minimum(q[0], q[1]), torch.minimum(q[2], q[3])),
                         torch.minimum(q[4], q[5]))
    tmax = torch.minimum(torch.minimum(torch.maximum(q[0], q[1]), torch.maximum(q[2], q[3])),
                         torch.maximum(q[4], q[5]))
    v = torch.where((tmax >= tmin) & (tmax > 0), tmin, pk.tmax).view(8, pk.q, 32).amin(-1)
    assert torch.equal(ms[:, 0], v.T)
    lo_h, lo_l = w[0, 0], w[0, 16]
    t = ((lo_h * sh[:, 0] - sh[:, 3]) + (lo_h * sl[:, 0] - sl[:, 3])) + lo_l * sh[:, 0]
    assert torch.equal(q[0, 0], t)


def test_wrappers_run_plain_on_cpu():
    microbench.reset_launch_counts()
    small = mxu_inner.mxu_tables("cpu", [p[:, :8] for p in fixtures.overlap_rays()])
    for body in mxu_inner.BODIES:
        for packet in mxu_inner.PACKETS[body]:
            r = mxu_inner.probe(small, body, 2, packet, n=128)
            p = mxu_inner.mxu_inner_plain(small, body, 2, packet, 128)
            for k in ("e", "acc", "top"):
                assert torch.equal(r[k], p[k]), (body, packet, k)
            assert torch.equal(r["e"][:64], r["e"][64:])         # thread i on ray i % 64
    assert microbench.LAUNCHES["mxu_inner"] == 0 and not microbench.INSTANCE_LAUNCHES


def test_instances_and_refusals(tabs):
    tab = tabs["script"]
    assert len(mxu_inner.INSTANCES) == 7
    with pytest.raises(ValueError, match="no such instance"):
        mxu_inner.probe(tab, "J", 1, 1)                 # mma is a warp instruction
    with pytest.raises(ValueError):
        mxu_inner.probe(tab, "Z", 1, 32)
    with pytest.raises(ValueError):
        mxu_inner.probe(tab, "I", 1, 32, n=100)
    with pytest.raises(TypeError):
        mxu_inner.probe(tab._replace(w4=tab.w4.float()), "K", 1, 32)


def test_read_bytes_and_ops(tabs):
    tab = tabs["grown"]
    rays = 4 * sum(p.numel() for p in tab.planes)
    for body, per in (("I", 96 + 16), ("M", 96), ("J", 48 * 64 + 32), ("K", 24 * 64 + 16),
                      ("L", 48 * 64)):
        visited = []
        packet = mxu_inner.PACKETS[body][0]
        mxu_inner.mxu_inner_plain(tab, body, KS[-1], packet, visited=visited)
        assert len(visited) == KS[-1] and not visited[0].any(), body
        npop = mxu_inner.BODIES[body][2]
        nodes = torch.unique(mxu_inner.rows_of(torch.cat(visited), npop)).numel()
        assert mxu_inner.read_bytes(tab, body, visited) == rays + per * nodes, body
    assert mxu_inner.read_bytes(tab, "J", []) == rays
    ops = {b: mxu_inner.iteration_ops(b) for b in mxu_inner.BODIES}
    assert ops["I"] == {"fp32": 32 * 25 + 8 * 25, "tensor": 0}
    assert ops["M"] == {"fp32": 800, "tensor": 0}
    assert ops["J"] == {"fp32": 32 * 14 + 4 * 95, "tensor": 192 * 36}
    assert ops["K"]["tensor"] == ops["L"]["tensor"] == 192 * 36 and ops["L"]["fp32"] == 448


def test_sass_names_and_answers(monkeypatch):
    mangled = {f"_Z19mb_mxu_inner_kernelILi{c}ELi{a}ELi{npop}ELi{p}EEv9MbMxuArgs": (b, p)
               for b, (c, a, npop) in mxu_inner.BODIES.items() for p in mxu_inner.PACKETS[b]}
    monkeypatch.setattr(sass, "kernel_counts",
                        lambda unit: {m: Counter({"STL": i + 1}) for i, m in enumerate(mangled)})
    got = sass.instance_counts("microbench_mxu_inner.cu")
    assert set(got) == mxu_inner.INSTANCES
    for i, (m, (b, p)) in enumerate(mangled.items()):
        assert got[mxu_inner.instance(b, p)]["STL"] == i + 1
    ns = {n: 8.0 for n in mxu_inner.INSTANCES}
    ns[mxu_inner.instance("J", 32)] = 12.0
    ns[mxu_inner.instance("I", 1)] = 16.0
    ans = mxu_inner.answers(ns)
    assert ans == {"J_over_I": 1.5, "K_over_I": 1.0, "L_over_M": 1.0, "I_p32_over_p1": 0.5}


def test_entry_point_on_cpu(tmp_path, capsys):
    microbench.reset_launch_counts()
    assert mb_main(["mxu_inner", "--device", "cpu", "--out", str(tmp_path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"command": "mxu_inner", "device": "cpu"}
    text = json.dumps(lines)
    assert '"ns' not in text and '"ms' not in text                # no times on the CPU
    assert json.load(open(tmp_path / "mxu_inner.json"))["records"] == lines[1:]
    assert {r["instance"] for r in lines[1:]} == mxu_inner.INSTANCES
    j = next(r for r in lines[1:] if r["instance"] == "mxu_inner<J,p32>")
    assert j["e_packet_1024"] == mxu_inner.mxu_inner_plain(
        mxu_inner.mxu_tables("cpu"), "J", mxu_inner.CPU_ITERS, 1024)["e"][0]
    assert all(v == 0 for v in microbench.LAUNCHES.values())           # plain only

"""The port's sharded render and multi-device training step
(parallel/sharded.py) against the JAX package's, on the CPU.

The port's mesh of 8 virtual CPU devices (make_mesh(8, device="cpu")) is
held against JAX's 8-device CPU mesh (tests/conftest.py): round_robin_perm
equals JAX's; render_sharded over the port's tables (the kernels' plain
versions, "pallas" and "fused") and over its DeviceBVH (the packet
traversal, "jax") equals JAX's render_sharded(variant="jax") within atol
3e-5 on tests/test_sharded.py's 64x64 2-bounce case and its 96x32 case (3
tiles on 8 devices: pad tiles), and "jax" equals the port's brute force
within atol 3e-5 there (tests/test_sharded.py:21-53); the port's sharded
frame equals the port's Pipeline.render at the production schedule within
atol 1e-6, rtol 0 (tests/test_sharded.py:94-125), streamed equals resident
and fast_light=False equals render() bit for bit; the 8-device training
step ("brute", "pallas", "jax") equals the 1-device step (loss within
1e-6, vertices within atol 1e-5, :309-323) and JAX's 8-device brute step,
and garbage in the pad tiles' target changes neither the loss nor the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.parallel import sharded as j_sharded
from parallel_ray_tracer_tpu_torch import pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig
from parallel_ray_tracer_tpu_torch.ops import cuda_trace
from parallel_ray_tracer_tpu_torch.parallel import sharded

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

# (width, height, bounces, heuristic): tests/test_sharded.py:21-51
CASES = {"64x64": (64, 64, 2, 6), "96x32": (96, 32, 1, 3)}


@pytest.fixture(scope="module")
def mesh8():
    return sharded.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jax_frames(tiny_scene):
    """JAX's render_sharded(variant="jax") over its 8-device mesh, per case."""
    mesh = j_sharded.make_mesh(8)
    out = {}
    for name, (w, h, b, heur) in CASES.items():
        cfg = JConfig(width=w, height=h, bounces=b, tile_rows=32, tile_cols=32,
                      bvh_heuristic=heur, mxu_leaf=False)
        p = j_pipeline.prepare(cfg, scene=tiny_scene)
        out[name] = np.asarray(j_sharded.render_sharded(
            p.ds, p.dbvh, p.camera(), w, h, mesh, bounces=b, leaf_size=p.leaf_size,
            stack_depth=p.stack_depth, variant="jax"))
    return out


def _pipe(scene, name, **kw):
    w, h, b, heur = CASES[name]
    cfg = RenderConfig(width=w, height=h, bounces=b, tile_rows=32, tile_cols=32,
                       bvh_heuristic=heur, mxu_leaf=False, **kw)
    return pipeline.prepare(cfg, scene=scene, device="cpu")


@pytest.fixture(scope="module")
def pipes(tiny_scene):
    return {name: _pipe(tiny_scene, name) for name in CASES}


def _render(p, mesh, variant, **kw):
    c = p.cfg
    if variant == "jax":     # the packet traversal takes the pipeline's DeviceBVH
        data = p.dbvh
        kw = dict(dict(leaf_size=p.leaf_size, stack_depth=p.stack_depth), **kw)
    else:
        data = p.tables
    return sharded.render_sharded(p.ds, data, p.camera(), c.width, c.height, mesh,
                                  bounces=c.bounces, variant=variant, **kw).numpy()


@pytest.mark.parametrize("ntiles,n_dev", [(16, 4), (8, 8), (sharded._pad_tiles(5, 4), 4)])
def test_round_robin_perm_as_jax(ntiles, n_dev):
    perm = sharded.round_robin_perm(ntiles, n_dev)
    np.testing.assert_array_equal(perm, j_sharded.round_robin_perm(ntiles, n_dev))
    assert perm.dtype == np.int32 and sorted(perm.tolist()) == list(range(ntiles))
    assert sharded._pad_tiles(5, 4) == j_sharded._pad_tiles(5, 4) == 8


@pytest.mark.parametrize("variant", ["pallas", "fused", "jax"])
@pytest.mark.parametrize("case", list(CASES))
def test_render_sharded_matches_jax(case, variant, pipes, jax_frames, mesh8):
    img = _render(pipes[case], mesh8, variant)
    assert img.std() > 0.01  # non-vacuous: the scene is in frame
    np.testing.assert_allclose(img, jax_frames[case], atol=3e-5)
    if variant == "jax":     # tests/test_sharded.py:21-53: the oracle
        brute = pipes[case].render(variant="bruteforce").numpy()
        np.testing.assert_allclose(img, brute, atol=3e-5)


@pytest.mark.parametrize("variant", ["pallas", "fused", "bruteforce", "jax"])
def test_sharded_equals_render(variant, pipes, mesh8):
    """The production schedule, threaded through, renders render()'s frame
    (tests/test_sharded.py:94-125)."""
    p = pipes["64x64"]
    img = _render(p, mesh8, variant, dual=p.cfg.dual_pop, stream=p.stream, npop=8,
                  npop0=2, adaptive=True, fast_light=p.cfg.fast_light,
                  reverse_shadows=p.cfg.reverse_shadows)
    np.testing.assert_allclose(img, p.render(variant=variant).numpy(), atol=1e-6, rtol=0)


def test_streamed_sharded_equals_resident(tiny_scene, mesh8):
    """Streamed leaf rows under the mesh give the resident sharded frame bit
    for bit (tests/test_sharded.py:127-159)."""
    p = _pipe(tiny_scene, "64x64", stream="on")
    assert p.stream
    res, strm = (_render(p, mesh8, "pallas", stream=s) for s in (False, True))
    assert res.std() > 0.01
    np.testing.assert_array_equal(strm, res)


def test_no_fast_light_respected(tiny_scene, mesh8):
    """fast_light=False reaches the sharded tracer (tests/test_sharded.py:161-181)."""
    p = _pipe(tiny_scene, "64x64", fast_light=False)
    img = _render(p, mesh8, "pallas", fast_light=False)
    np.testing.assert_array_equal(img, p.render(variant="pallas").numpy())


def test_mesh_and_refusals(pipes, mesh8):
    assert mesh8.size == 8 and all(d.type == "cpu" for d in mesh8)
    assert mesh8.local == list(range(8)) and not mesh8.distributed
    p = pipes["64x64"]
    with pytest.raises(ValueError, match="DeviceBVH"):    # "jax" takes the flat tree
        sharded.render_sharded(p.ds, p.tables, p.camera(), 64, 64, mesh8, variant="jax",
                               leaf_size=p.leaf_size, stack_depth=p.stack_depth)
    with pytest.raises(ValueError):
        _render(p, mesh8, "fused", leaf_size=4)
    if not torch.cuda.is_available():  # no path carries on on the CPU
        with pytest.raises(RuntimeError):
            sharded.make_mesh(2)
    # the scene and tables are copied to another device once per mesh
    mesh = sharded.Mesh(["cpu", "meta"])
    T = p.tables
    first = mesh.replica(T, torch.device("meta"))
    assert first.cbox.device.type == "meta" and mesh.replica(T, torch.device("meta")) is first
    assert mesh.replica(T, torch.device("cpu")) is T


# --- training ---------------------------------------------------------------

W, H = 64, 32   # 2 tiles: 6 pad tiles on 8 devices


@pytest.fixture(scope="module")
def one_device_steps(tiny_scene, pipes):
    """The 1-device brute and pallas steps' (verts, loss), lr 1e-2."""
    return {v: _step(tiny_scene, pipes, None, v)(None) for v in ("brute", "pallas", "jax")}


def _step(scene, pipes, mesh, variant, lr=1e-2):
    p = pipes["64x64"]
    kw = {"brute": {},
          "pallas": dict(tracer_data=p.tables.packed_dev, leaf_size=p.tables.leaf_size,
                         slot_map=p.flat.slot_map),
          "jax": dict(tracer_data=p.dbvh, leaf_size=p.leaf_size, stack_depth=p.stack_depth,
                      slot_map=p.flat.slot_map)}[variant]
    step, prep = sharded.make_train_step(scene, mesh, W, H, bounces=1, lr=lr, variant=variant,
                                         device="cpu", **kw)

    def run(pad_target):
        v, o_t, d_t, target = prep()
        if pad_target is not None:
            target[2:] = pad_target
        return step(v, o_t, d_t, target)

    return run


@pytest.mark.parametrize("variant", ["brute", "pallas", "jax"])
def test_eight_device_step_matches_one(variant, tiny_scene, pipes, mesh8, one_device_steps):
    run = _step(tiny_scene, pipes, mesh8, variant)
    v8, l8 = run(None)
    v1, l1 = one_device_steps[variant]
    assert float(l1) > 0.01
    assert abs(float(l8) - float(l1)) < 1e-6
    np.testing.assert_allclose(v8.numpy(), v1.numpy(), atol=1e-5)
    # garbage in the pad tiles' target changes neither the loss nor the step
    vg, lg = run(1e3)
    assert torch.equal(lg, l8) and torch.equal(vg, v8)


def test_eight_device_step_matches_jax(tiny_scene, pipes, mesh8):
    step, prep = j_sharded.make_train_step(tiny_scene, j_sharded.make_mesh(8), W, H,
                                           bounces=1, lr=1e-2)
    jv, jl = step(*prep())
    v8, l8 = _step(tiny_scene, pipes, mesh8, "brute")(None)
    assert abs(float(l8) - float(jl)) < 1e-6
    np.testing.assert_allclose(v8.numpy(), np.asarray(jv), atol=1e-5)


def test_two_shards_launch_per_shard(tiny_scene, pipes, monkeypatch):
    """Each device of the mesh traces its own block: a mesh naming one
    device twice calls each tracer twice a bounce."""
    calls = []
    real = cuda_trace.make_tracer

    def counting(*a, **k):
        c, o = real(*a, **k)
        return (lambda *x: calls.append("c") or c(*x)), (lambda *x: calls.append("o") or o(*x))

    monkeypatch.setattr(cuda_trace, "make_tracer", counting)
    for mesh, want in ((None, 1), (["cpu", "cpu"], 2)):
        calls.clear()
        _step(tiny_scene, pipes, mesh, "pallas")(None)
        assert calls.count("c") == want and calls.count("o") == want

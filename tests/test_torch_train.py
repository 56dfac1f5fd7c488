"""The port's training step (parallel/sharded.make_train_step) against the
JAX package's, on the CPU.

The port's counterparts of tests/test_sharded.py's TestShardedTraining, on
one device: the brute step descends over 4 steps at 64x64 and stays finite;
the pallas step's first vertex update equals the brute step's within atol
1e-5 (the loss within 1e-3 relative); the training forward with target =
the port's pass-based render of the same camera, tiles and flags (npop 8,
npop0 2, fast_light, reverse_shadows, adaptive) gives a loss below 1e-12
at lr = 0. Against JAX: the port's pallas step (the kernels' plain
versions, with attr) and JAX's make_train_step(variant="pallas",
interpret=True) on make_mesh(1), at 64x32 and 1 bounce, fed the same state
through convert.train_inputs_from_numpy: the loss within
1e-3 * max(1, loss), the updated vertices within atol 1e-5; the port's
jax step (the packet traversal, ops/trace_bvh.py) and JAX's
make_train_step(variant="jax") the same way, and the port's jax step and
its FP32 pallas step on the same inputs (the loss within 1e-6 * max(1,
loss), the vertices within atol 1e-6). A mesh of two devices trains as one
device does. The refusals: variant="jax" without a DeviceBVH, an unknown
variant, a device beside a mesh of another, tables on another device than
the step's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ray_tracer_tpu.ops import pallas_trace as j_pt
from parallel_ray_tracer_tpu.parallel import sharded as j_sharded
from parallel_ray_tracer_tpu_torch import pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig
from parallel_ray_tracer_tpu_torch.convert import train_inputs_from_numpy
from parallel_ray_tracer_tpu_torch.models.camera import default_camera
from parallel_ray_tracer_tpu_torch.ops.render import render_bvh_pallas
from parallel_ray_tracer_tpu_torch.parallel import sharded

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

W, H = 64, 32


@pytest.fixture(scope="module")
def tiny_pipe(tiny_scene):
    """The port's width-4 FP32 tables of tiny_scene (the numpy builder, leaf
    size 8), as tests/test_sharded.py packs them."""
    cfg = RenderConfig(width=W, height=H, bvh_heuristic=6, use_native=False, mxu_leaf=False)
    return pipeline.prepare(cfg, scene=tiny_scene, device="cpu")


def _pallas_step(scene, pipe, **kw):
    T = pipe.tables
    return sharded.make_train_step(scene, None, W, H, variant="pallas",
                                   tracer_data=T.packed_dev, leaf_size=T.leaf_size,
                                   slot_map=pipe.flat.slot_map, device="cpu", **kw)


def test_step_descends_and_stays_finite(tiny_scene):
    step, prep = sharded.make_train_step(tiny_scene, None, 64, 64, bounces=1, lr=1e-3,
                                         device="cpu")
    v, o_t, d_t, target = prep()
    losses = []
    for _ in range(4):
        v, loss = step(v, o_t, d_t, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert bool(torch.isfinite(v).all())
    assert losses[-1] < losses[0]


def test_pallas_variant_step(tiny_scene, tiny_pipe):
    step_p, prep_p = _pallas_step(tiny_scene, tiny_pipe, bounces=1, lr=1e-3)
    step_b, prep_b = sharded.make_train_step(tiny_scene, None, W, H, bounces=1, lr=1e-3,
                                             device="cpu")
    vp1, lp = step_p(*prep_p())
    vb1, lb = step_b(*prep_b())
    assert np.isfinite(float(lp)) and float(lp) > 0
    assert abs(float(lp) - float(lb)) < 1e-3 * max(1.0, float(lb))
    np.testing.assert_allclose(vp1.numpy(), vb1.numpy(), atol=1e-5)


def test_train_forward_matches_render(tiny_scene, tiny_pipe):
    """With target = the port's pass-based render at the same flags, the
    first step's loss is ~0 (tests/test_sharded.py:244-307)."""
    flags = dict(npop=8, npop0=2, fast_light=True, reverse_shadows=True, adaptive=True)
    img = render_bvh_pallas(tiny_pipe.ds, tiny_pipe.tables, default_camera(), W, H, bounces=1,
                            fast_light=True, reverse_shadows=True)
    target = img.reshape(1, 32, 2, 32, 3).transpose(1, 2).reshape(2, 1024, 3)
    step, prep = _pallas_step(tiny_scene, tiny_pipe, bounces=1, lr=0.0, **flags)
    v, o_t, d_t, _ = prep()
    v1, loss = step(v, o_t, d_t, target)
    assert float(loss) < 1e-12, float(loss)
    assert torch.equal(v1, v)


@pytest.fixture(scope="module")
def jax_step(tiny_scene, tiny_pipe):
    """One JAX pallas step (interpret mode) on the port's tables: its inputs
    and outputs as numpy."""
    T = tiny_pipe.tables
    packed = tuple(jnp.asarray(t.numpy()) for t in T.packed_dev)
    step, prep = j_sharded.make_train_step(
        tiny_scene, j_sharded.make_mesh(1), W, H, bounces=1, lr=1e-3, variant="pallas",
        tracer_data=packed, leaf_size=T.leaf_size, slot_map=tiny_pipe.flat.slot_map,
        stack_depth=j_pt.required_stack_depth(tiny_pipe.flat.depth, 4), interpret=True)
    v, o_t, d_t, target = prep()
    target = target + 0.25  # a target other than the step's own zeros
    v1, loss = step(v, o_t, d_t, target)
    state = (np.asarray(v), [np.asarray(p) for p in o_t], [np.asarray(p) for p in d_t],
             np.asarray(target))
    return state, np.asarray(v1), float(loss)


def _jax_step(scene, pipe, **kw):
    return sharded.make_train_step(scene, None, W, H, variant="jax", tracer_data=pipe.dbvh,
                                   leaf_size=pipe.leaf_size, stack_depth=pipe.stack_depth,
                                   slot_map=pipe.flat.slot_map, device="cpu", **kw)


def test_jax_step_matches_jax(tiny_scene, tiny_pipe, jax_step):
    """The packet-traversal step against JAX's make_train_step(variant="jax")
    on JAX's own DeviceBVH of the same tree, fed the same state."""
    from parallel_ray_tracer_tpu.ops import trace_bvh as j_tb

    state, _, _ = jax_step
    jbvh, jL, jS = j_tb.device_bvh_from_flat(tiny_pipe.flat)
    jstep, jprep = j_sharded.make_train_step(
        tiny_scene, j_sharded.make_mesh(1), W, H, bounces=1, lr=1e-3, variant="jax",
        tracer_data=jbvh, leaf_size=jL, stack_depth=jS, slot_map=tiny_pipe.flat.slot_map)
    v, o_t, d_t, target = jprep()      # the jax_step fixture's state
    np.testing.assert_array_equal(np.asarray(target) + 0.25, state[3])
    jv1, jloss = jstep(v, o_t, d_t, target + 0.25)
    step, _ = _jax_step(tiny_scene, tiny_pipe, bounces=1, lr=1e-3)
    v1, loss = step(*train_inputs_from_numpy(*state, device="cpu"))
    assert float(jloss) > 0.01  # non-vacuous
    assert abs(float(loss) - float(jloss)) < 1e-3 * max(1.0, float(jloss))
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv1), atol=1e-5)


def test_jax_step_matches_pallas_step(tiny_scene, tiny_pipe, jax_step):
    """The packet-traversal step and the FP32 kernels' step (their plain
    versions here) find the same hits: the same step, to rounding."""
    state, _, _ = jax_step
    inputs = train_inputs_from_numpy(*state, device="cpu")
    vj, lj = _jax_step(tiny_scene, tiny_pipe, bounces=2, lr=1e-3)[0](*inputs)
    vp, lp = _pallas_step(tiny_scene, tiny_pipe, bounces=2, lr=1e-3)[0](*inputs)
    assert float(lp) > 0.01
    assert abs(float(lj) - float(lp)) < 1e-6 * max(1.0, float(lp))
    np.testing.assert_allclose(vj.numpy(), vp.numpy(), atol=1e-6)
    assert np.abs(vj.numpy() - state[0]).max() > 1e-6


def test_pallas_step_matches_jax(tiny_scene, tiny_pipe, jax_step):
    state, jv1, jloss = jax_step
    step, _ = _pallas_step(tiny_scene, tiny_pipe, bounces=1, lr=1e-3)
    v1, loss = step(*train_inputs_from_numpy(*state, device="cpu"))
    assert jloss > 0.01  # non-vacuous
    assert abs(float(loss) - jloss) < 1e-3 * max(1.0, jloss)
    np.testing.assert_allclose(v1.numpy(), jv1, atol=1e-5)
    assert np.abs(jv1 - state[0]).max() > 1e-6  # the step moved the vertices


@pytest.mark.parametrize("kw,exc", [
    (dict(variant="jax"), ValueError),        # no DeviceBVH
    (dict(variant="bogus"), ValueError),
    (dict(mesh="cpu", device="meta"), ValueError),
])
def test_refusals(tiny_scene, kw, exc):
    kw = dict(dict(mesh=None, device="cpu"), **kw)
    with pytest.raises(exc):
        sharded.make_train_step(tiny_scene, kw.pop("mesh"), W, H, **kw)


def test_tables_on_another_device_refused(tiny_scene, tiny_pipe):
    T = tiny_pipe.tables
    with pytest.raises(ValueError, match="lies on"):
        sharded.make_train_step(tiny_scene, None, W, H, variant="pallas",
                                tracer_data=tuple(t.to("meta") for t in T.packed_dev),
                                slot_map=tiny_pipe.flat.slot_map, device="cpu")


def test_two_device_mesh_trains(tiny_scene):
    """A mesh of two devices trains: the step descends and equals the one-
    device step (the loss within 1e-6, the vertices within atol 1e-5)."""
    step1, prep1 = sharded.make_train_step(tiny_scene, None, W, H, lr=1e-3, device="cpu")
    step2, prep2 = sharded.make_train_step(tiny_scene, ["cpu", "cpu"], W, H, lr=1e-3)
    v1, l1 = step1(*prep1())
    v, o_t, d_t, target = prep2()
    v2, l2 = step2(v, o_t, d_t, target)
    assert step2.mesh.size == 2 and abs(float(l2) - float(l1)) < 1e-6
    np.testing.assert_allclose(v2.numpy(), v1.numpy(), atol=1e-5)
    _, l3 = step2(v2, o_t, d_t, target)
    assert float(l3) < float(l2)


@pytest.mark.parametrize("mesh", [None, "cpu", [torch.device("cpu")]])
def test_one_device_mesh(tiny_scene, mesh):
    """None, a device, or a sequence of one: the same step."""
    step, prep = sharded.make_train_step(tiny_scene, mesh, W, H, lr=1e-3, device="cpu")
    v1, loss = step(*prep())
    assert v1.device.type == "cpu" and np.isfinite(float(loss))

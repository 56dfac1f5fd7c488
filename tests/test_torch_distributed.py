"""The port's process group (parallel/distributed.py) and the sharded render
and training step across two real OS processes, on the CPU.

initialize() in one process is a no-op and is_primary() holds there. Two
processes under gloo on localhost, each with 4 CPU devices, make the global
8-device mesh and render tests/test_multiprocess.py's scene at 64x32 with 1
bounce (the kernels' plain versions): both ranks' frames are equal bit for
bit and equal the single-process 8-device render within atol 1e-6
(tests/test_multiprocess.py:104); their training step (brute force, lr
1e-2) equals the single-process 8-device step (the loss within 1e-6, the
vertices within atol 1e-5). The worker is this file run as a script; it
imports neither JAX nor the JAX package. The parent kills both workers past
a timeout and fails.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a worker script
    sys.path.insert(0, REPO)

from parallel_ray_tracer_tpu_torch import pipeline  # noqa: E402
from parallel_ray_tracer_tpu_torch.config import RenderConfig  # noqa: E402
from parallel_ray_tracer_tpu_torch.models.scene import Scene  # noqa: E402
from parallel_ray_tracer_tpu_torch.parallel import distributed, sharded  # noqa: E402

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

W, H = 64, 32
FIELDS = ("verts", "faces", "mat_idx", "mats_kd", "mats_ks", "mats_kr", "lights_pos",
          "lights_kl")
WORKER_TIMEOUT_S = 240


def _render_and_step(scene, mesh):
    """(frame, verts, loss) of the sharded render and one brute-force step."""
    cfg = RenderConfig(width=W, height=H, bounces=1, bvh_heuristic=6, use_native=False,
                       mxu_leaf=False)
    pipe = pipeline.prepare(cfg, scene=scene, device="cpu")
    img = sharded.render_sharded(pipe.ds, pipe.tables, pipe.camera(), W, H, mesh,
                                 bounces=1, variant="pallas")
    step, prep = sharded.make_train_step(scene, mesh, W, H, bounces=1, lr=1e-2,
                                         device=mesh.home)
    v, loss = step(*prep())
    return img.numpy(), v.numpy(), float(loss)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    assert not distributed.active() and distributed.is_primary()
    assert distributed.rank() == 0 and distributed.world_size() == 1
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    distributed.initialize()  # a launcher's environment of one process
    assert not distributed.active()


@pytest.fixture(scope="module")
def two_process_run(tiny_scene, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    scene_path = tmp / "scene.npz"
    np.savez(scene_path, **{k: getattr(tiny_scene, k) for k in FIELDS})
    address = f"127.0.0.1:{_free_port()}"
    outs = [tmp / f"rank_{r}.npz" for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), address, str(r),
                               str(scene_path), str(outs[r])],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a distributed worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log[-4000:]}"
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def single_process(tiny_scene):
    scene = Scene(**{k: np.asarray(getattr(tiny_scene, k)) for k in FIELDS})
    return _render_and_step(scene, sharded.make_mesh(8, device="cpu"))


def test_two_processes_render_the_single_process_frame(two_process_run, single_process):
    r0, r1 = two_process_run
    np.testing.assert_array_equal(r0["img"], r1["img"])
    ref = single_process[0]
    assert ref.std() > 0.01  # the frame holds the scene
    np.testing.assert_allclose(r0["img"], ref, atol=1e-6, rtol=0)


def test_two_processes_step_as_one(two_process_run, single_process):
    r0, r1 = two_process_run
    _, v, loss = single_process
    for r in (r0, r1):
        assert abs(float(r["loss"]) - loss) < 1e-6
        np.testing.assert_allclose(r["verts"], v, atol=1e-5)
    np.testing.assert_array_equal(r0["verts"], r1["verts"])
    assert int(r0["mesh_size"]) == 8 and list(r0["local"]) == [0, 1, 2, 3]
    assert list(r1["local"]) == [4, 5, 6, 7]
    assert bool(r0["primary"]) and not bool(r1["primary"])


def _worker(address: str, rank: int, scene_path: str, out: str) -> None:
    """One rank: join the group (twice: the second call is a no-op), make
    the global mesh of 4 CPU devices a process, render and step."""
    torch.set_num_threads(1)
    for _ in range(2):
        distributed.initialize(address, num_processes=2, process_id=rank, backend="gloo")
    mesh = sharded.make_mesh(devices=["cpu"] * 4)
    z = np.load(scene_path)
    img, v, loss = _render_and_step(Scene(**{k: z[k] for k in FIELDS}), mesh)
    np.savez(out, img=img, verts=v, loss=loss, mesh_size=mesh.size, local=mesh.local,
             primary=distributed.is_primary())
    distributed.shutdown()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])

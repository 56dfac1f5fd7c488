"""The port's profiling harness (utils/profiling.py) and package API, on the
CPU.

`timed` returns the result and the seconds with the result's devices
fenced; `annotate` spans nest on the profiler's timeline; `trace` writes a
Chrome trace file into its directory that names the spans inside it. The
package exports RenderConfig, prepare and __version__, as the JAX package
does (tests/test_utils.py:50-55).
"""

import glob
import json
import os
import time

import pytest
import torch

import parallel_ray_tracer_tpu as j_pkg
import parallel_ray_tracer_tpu_torch as pkg
from parallel_ray_tracer_tpu_torch.utils import profiling

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools


def test_timed_fences_the_result(monkeypatch):
    fenced = []
    monkeypatch.setattr(profiling, "fence", lambda out: fenced.append(out))

    def work():
        time.sleep(0.05)
        return {"a": torch.ones(3), "b": (torch.zeros(2),)}

    out, s = profiling.timed(work)
    assert fenced == [out] and s >= 0.05
    assert torch.equal(out["a"], torch.ones(3))


def test_fence_synchronises_each_card_once(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    profiling.fence([torch.ones(2), {"x": (torch.zeros(1),)}])
    assert synced == []  # CPU tensors are ready when returned

    class OnCard:  # a stand-in for a tensor on a card
        def __init__(self, i):
            self.device = torch.device("cuda", i)

    monkeypatch.setattr(profiling, "_tensors", lambda tree: iter(tree))
    profiling.fence([OnCard(0), OnCard(1), OnCard(0)])
    assert sorted(synced, key=str) == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_trace_writes_annotated_spans(tmp_path):
    log = tmp_path / "prof"
    with profiling.trace(str(log)):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(64).sum()
    files = glob.glob(os.path.join(log, "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer", "inner")}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("name", ["RenderConfig", "prepare", "__version__"])
def test_package_api_as_jax(name):
    assert hasattr(j_pkg, name) and getattr(pkg, name)
    assert pkg.__version__ == j_pkg.__version__


def test_package_prepare(tiny_scene):
    pipe = pkg.prepare(scene=tiny_scene, device="cpu", width=32, height=32, bounces=1,
                       use_native=False)
    assert pipe.cfg == pkg.RenderConfig(width=32, height=32, bounces=1, use_native=False)
    assert pipe.render().shape == (32, 32, 3)
    with pytest.raises(TypeError):
        pkg.prepare(pkg.RenderConfig(), width=32)

"""The port's command line, `python -m parallel_ray_tracer_tpu_torch`, on the
CPU (--device cpu): the JAX CLI's flags and defaults, the frame an
in-process render() gives, the JAX CLI's metrics record and statistics,
--bf16-bvh, --leaf-size 4, --no-reverse-shadows, --no-fast-light and
--presplit (each the frame an in-process render() of its config gives),
the car scenes' substitutes without a car_only folder, --devices 2 (the
sharded frame over 2 virtual CPU devices, render()'s BMP), --checkpoint
(a resumed banded frame), --profile (a trace file), --variant jax (the
in-process packet-traversal frame's BMP, byte for byte, also over 2
devices) and --interpret (the BMP of the same run without it, byte for
byte); without --device the run needs the card."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parallel_ray_tracer_tpu import cli as j_cli
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models import procgen as j_procgen
from parallel_ray_tracer_tpu.utils import stats as j_stats
from parallel_ray_tracer_tpu_torch import cli, pipeline
from parallel_ray_tracer_tpu_torch.utils import stats as t_stats
from parallel_ray_tracer_tpu_torch.utils.bmp import bmp_bytes

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--scene", "car_boxed", "--width", "64",
        "--height", "32", "--bounces", "1", "--iterations", "2",
        "--warmup", "0", "--quiet"]
# The keys of the JAX CLI's --metrics-json record (cli.py:336-343).
J_RECORD_KEYS = {"config", "backend", "build_ms", "bvh_stats", "times_ms",
                 "primary_rays_per_s", *j_stats.summarize([1.0])}


def _flags(parser):
    return {a.dest: (a.option_strings, a.default, a.choices and list(a.choices))
            for a in parser._actions}


def test_flags_and_defaults_as_jax():
    ours = _flags(cli.build_parser())
    assert ours.pop("device") == (["--device"], "cuda", None)
    assert ours == _flags(j_cli.build_parser())


def test_cli_writes_the_render_and_the_metrics(tmp_path):
    bmp, rec_path = tmp_path / "frame.bmp", tmp_path / "metrics.json"
    assert cli.main(ARGS + ["--output", str(bmp), "--metrics-json", str(rec_path)]) == 0
    cfg = cli.config_from_args(cli.build_parser().parse_args(ARGS))
    img = pipeline.prepare(cfg, device="cpu").render().numpy()
    assert img.std() > 0.01  # non-vacuous: the scene is in frame
    assert bmp.read_bytes() == bmp_bytes(img)
    rec = json.loads(rec_path.read_text())
    assert J_RECORD_KEYS <= rec.keys()
    assert set(rec["config"]) == {f.name for f in dataclasses.fields(JConfig)}
    assert rec["backend"] == "cpu" and rec["device_name"] is None
    assert rec["iterations"] == 2 and len(rec["times_ms"]) == 2


@pytest.mark.parametrize("times", [
    [5.0], [3.0, 1.0, 2.0, 10.0],
    list(np.random.RandomState(0).uniform(1.0, 9.0, 40)),
], ids=["one", "four", "forty"])
def test_stats_as_jax(times):
    s = t_stats.summarize(times)
    assert s == j_stats.summarize(times)
    assert t_stats.format_summary(s) == j_stats.format_summary(s)


@pytest.mark.parametrize("flags", [["--interpret"], ["--variant", "jax"]], ids=" ".join)
def test_unported_flag_exits_nonzero(flags, capsys, tmp_path):
    """The two flags that exited 2 while their paths were not ported now
    render: --variant jax the in-process render(variant="jax") frame, and
    --interpret (the kernels' plain versions on the device) the frame of
    the same run without it, each BMP byte for byte."""
    argv = ["--device", "cpu", "--width", "32", "--height", "32", "--bounces", "2",
            "--warmup", "0", "--asset-root", str(tmp_path), "--synthetic", "16"]
    bmp, plain = tmp_path / "f.bmp", tmp_path / "plain.bmp"
    assert cli.main(argv + [*flags, "--output", str(bmp)]) == 0
    assert "NotImplementedError" not in capsys.readouterr().err
    if "--interpret" in flags:
        assert cli.main(argv + ["--output", str(plain)]) == 0
        assert bmp.read_bytes() == plain.read_bytes()
        return
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv + flags))
    img = pipeline.prepare(cfg, device="cpu").render(variant="jax").numpy()
    assert img.std() > 0.01 and bmp.read_bytes() == bmp_bytes(img)


SHARDED_ARGV = ["--device", "cpu", "--synthetic", "64", "--width", "64", "--height", "40",
                "--bounces", "2", "--warmup", "0", "--iterations", "1"]


@pytest.mark.parametrize("variant", ["auto", "pallas", "bruteforce", "jax"])
def test_devices_renders_the_sharded_frame(variant, tmp_path, capsys):
    """--devices 2 --device cpu times render_sharded over 2 virtual CPU
    devices: its BMP is render()'s, the banner and the record say 2."""
    argv = SHARDED_ARGV + ["--variant", variant]
    bmp, rec = tmp_path / "f.bmp", tmp_path / "m.json"
    assert cli.main(argv + ["--devices", "2", "--output", str(bmp),
                            "--metrics-json", str(rec)]) == 0
    assert "devices: 2," in capsys.readouterr().out
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    img = pipeline.prepare(cfg, device="cpu").render().numpy()
    assert img.std() > 0.01 and bmp.read_bytes() == bmp_bytes(img)
    assert json.loads(rec.read_text())["devices"] == 2


def test_checkpoint_resumes(tmp_path):
    """--checkpoint renders in bands and a rerun resumes at the first
    missing band: a file with its first band done renders the rest."""
    from parallel_ray_tracer_tpu_torch.utils.checkpoint import TileRenderCheckpoint, save_pytree

    ck, bmp = tmp_path / "ck.npz", tmp_path / "f.bmp"
    argv = SHARDED_ARGV + ["--checkpoint", str(ck), "--band-rows", "32", "--output", str(bmp)]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    img = pipeline.prepare(cfg, device="cpu").render().numpy()
    part = TileRenderCheckpoint(str(ck), 64, 40, 32)
    state = part.load()
    state["image"][:32], state["done"][0] = 0.25, True  # a band the rerun must keep
    save_pytree(str(ck), state)
    assert cli.main(argv) == 0
    want = img.copy()
    want[:32] = 0.25
    assert bmp.read_bytes() == bmp_bytes(want) and part.load()["done"].all()


def test_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert cli.main(SHARDED_ARGV + ["--iterations", "2", "--profile", str(prof)]) == 0
    (trace,) = prof.glob("*.pt.trace.json")
    assert json.loads(trace.read_text())["traceEvents"]
    assert f"Wrote profiler trace to {prof}" in capsys.readouterr().out


def test_devices_past_the_cards_exits_nonzero(tmp_path):
    """On the card --devices asks for cards; without them the run ends with
    the reason, never on fewer devices or on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "parallel_ray_tracer_tpu_torch", "--synthetic", "16",
         "--width", "32", "--height", "32", "--devices", "2"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


@pytest.mark.parametrize("flags", [
    ["--no-fast-light"], ["--presplit", "0.1"], ["--no-reverse-shadows"],
    ["--leaf-size", "4"],
], ids=" ".join)
def test_ported_flag_renders(flags, capsys, tmp_path):
    """The knobs that exited 2 before their paths were ported render the
    frame an in-process render() of the same config gives; the banner and
    the metrics record carry the leaf size."""
    argv = ["--device", "cpu", "--synthetic", "64", "--width", "32", "--height", "32",
            "--bounces", "2", "--warmup", "0", "--iterations", "1", *flags]
    bmp, rec_path = tmp_path / "f.bmp", tmp_path / "m.json"
    assert cli.main(argv + ["--output", str(bmp), "--metrics-json", str(rec_path)]) == 0
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    pipe = pipeline.prepare(cfg, device="cpu")
    img = pipe.render().numpy()
    assert img.std() > 0.01 and bmp.read_bytes() == bmp_bytes(img)
    leaf = 4 if "--leaf-size" in flags else 8
    assert pipe.leaf_size == json.loads(rec_path.read_text())["leaf_size"] == leaf
    assert f"leaf: {leaf}," in capsys.readouterr().out


@pytest.mark.parametrize("bvh_width", ["2", "4", "8"])
def test_bf16_flag_renders_the_same_frame(bvh_width, tmp_path, capsys):
    """--bf16-bvh packs bf16 boxes (f32 at width 8, as JAX's prepare); the
    hits, and so the frame, are those of the f32 tables."""
    argv = ["--device", "cpu", "--synthetic", "64", "--width", "32",
            "--height", "32", "--bounces", "1", "--warmup", "0",
            "--bvh-width", bvh_width]
    bmps = [tmp_path / "f32.bmp", tmp_path / "bf16.bmp"]
    assert cli.main(argv + ["--output", str(bmps[0])]) == 0
    assert cli.main(argv + ["--bf16-bvh", "--output", str(bmps[1])]) == 0
    assert "bf16: True" in capsys.readouterr().out
    assert bmps[0].read_bytes() == bmps[1].read_bytes()


@pytest.mark.parametrize("scene", ["two_cars", "sportscar"])
def test_car_substitute_without_car_only_exits_nonzero(scene, tmp_path):
    """The two car substitutes need a car_only OBJ folder, in both packages:
    without one the run ends with JAX's FileNotFoundError."""
    with pytest.raises(FileNotFoundError) as jax_err:
        j_procgen.substitute_scene(scene, (str(tmp_path),))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "parallel_ray_tracer_tpu_torch", "--device", "cpu",
         "--scene", scene, "--asset-root", str(tmp_path), "--width", "32",
         "--height", "32"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert proc.returncode != 0
    assert f"FileNotFoundError: {jax_err.value}" in proc.stderr


def test_ignored_tpu_flags_render(capsys):
    """Flags of TPU schedules and builders are accepted and change nothing."""
    argv = ["--device", "cpu", "--synthetic", "64", "--width", "32",
            "--height", "32", "--bounces", "1", "--warmup", "0", "--no-native",
            "--no-mxu-leaf", "--pop-width", "2", "--no-adaptive-pop",
            "--no-dual-pop", "--bvh-width", "2"]
    assert cli.main(argv) == 0
    assert "variant: pallas (auto)" in capsys.readouterr().out


def test_module_entry_point_exits_nonzero():
    """`python -m` runs the CLI: --device cpu --interpret exits 0, and
    without --device the run needs the card (no fallback to the CPU)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    run = [sys.executable, "-m", "parallel_ray_tracer_tpu_torch", "--width", "32",
           "--height", "32"]
    proc = subprocess.run(run + ["--device", "cpu", "--interpret", "--synthetic", "16",
                                 "--bounces", "1", "--warmup", "0"],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    if not torch.cuda.is_available():
        proc = subprocess.run(run, capture_output=True, text=True, cwd=REPO,
                              env=env, timeout=120)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr

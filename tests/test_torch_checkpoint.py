"""The port's checkpoint and resume (utils/checkpoint.py) and banded render
(Pipeline.render_band) against the JAX package's, on the CPU.

A tree of nested dicts, tuples, lists and arrays round-trips; a file that
JAX's save_pytree writes loads with the port's load_pytree and the port's
file loads with JAX's, with JAX's treedef text (tests/test_checkpoint.py:
12-22); the resume test of :25-45; render_band's rows equal the whole
frame's rows bit for bit for "fused", "pallas", "bruteforce" and "jax"
(:48-62), also a band that runs past the frame's last row, and equal JAX's
render_band(variant="jax") within atol 3e-5; the port's CLI --checkpoint
renders the frame render() gives, persists, and a rerun renders no band
again (:65-93).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.utils import checkpoint as j_ck
from parallel_ray_tracer_tpu_torch import cli, pipeline
from parallel_ray_tracer_tpu_torch.config import RenderConfig
from parallel_ray_tracer_tpu_torch.utils.bmp import bmp_bytes
from parallel_ray_tracer_tpu_torch.utils.checkpoint import (TileRenderCheckpoint, load_pytree,
                                                            save_pytree)

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools


def _jax_tree():
    return {"verts": jnp.arange(12.0).reshape(4, 3),
            "opt": (jnp.zeros(3), {"step": jnp.int32(7)}), "extra": [jnp.ones(2), None]}


def test_pytree_roundtrip(tmp_path):
    tree = {"verts": torch.arange(12.0).reshape(4, 3),
            "opt": (np.zeros(3, np.float32), {"step": np.int32(7)}), "n": [1.5, None]}
    path = str(tmp_path / "ck.npz")
    save_pytree(path, tree)
    back = load_pytree(path, tree)
    assert isinstance(back["verts"], torch.Tensor) and torch.equal(back["verts"], tree["verts"])
    assert int(back["opt"][1]["step"]) == 7 and back["n"][1] is None
    assert float(back["n"][0]) == 1.5
    with pytest.raises(ValueError):
        load_pytree(path, {"verts": tree["verts"]})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_cross_load(writer, tmp_path):
    tree = _jax_tree()
    path = str(tmp_path / "ck.npz")
    (j_ck.save_pytree if writer == "jax" else save_pytree)(path, tree)
    back = (load_pytree if writer == "jax" else j_ck.load_pytree)(path, tree)
    np.testing.assert_array_equal(np.asarray(back["verts"]), np.asarray(tree["verts"]))
    assert int(back["opt"][1]["step"]) == 7 and back["extra"][1] is None
    with np.load(path) as z:
        text = bytes(z["__treedef__"]).decode()
    assert text.strip('"') == str(jax.tree.flatten(tree)[1])


def test_tile_render_resume(tmp_path):
    path = str(tmp_path / "render.npz")
    calls = []

    def render_band(y0, rows):
        calls.append(y0)
        return np.full((rows, 8, 3), float(y0), np.float32)

    ck = TileRenderCheckpoint(path, width=8, height=10, band_rows=4)
    # a crash after two bands
    state = ck.load()
    for b in range(2):
        y0 = b * 4
        rows = min(4, 10 - y0)
        state["image"][y0:y0 + rows] = render_band(y0, rows)
        state["done"][b] = True
    save_pytree(path, state)

    img = ck.run(render_band)
    assert calls == [0, 4, 8]  # the resume rendered only the last band
    assert img.shape == (10, 8, 3)
    assert (img[0:4] == 0.0).all() and (img[8:10] == 8.0).all()
    # the port's file of a finished frame resumes in JAX's class with nothing left
    assert (j_ck.TileRenderCheckpoint(path, 8, 10, 4).run(render_band) == img).all()
    assert calls == [0, 4, 8]


# tests/test_checkpoint.py:48-62's frame
KW = dict(width=64, height=32, bounces=2, tile_rows=8, tile_cols=128, use_native=False,
          mxu_leaf=False)
BANDS = ((0, 8), (8, 16), (24, 8), (20, 12))


@pytest.fixture(scope="module")
def band_pipe(tiny_scene):
    return pipeline.prepare(RenderConfig(**KW), scene=tiny_scene, device="cpu")


@pytest.mark.parametrize("variant", ["fused", "pallas", "bruteforce", "jax"])
def test_render_band_matches_full_frame(variant, band_pipe):
    full = band_pipe.render(variant=variant).numpy()
    assert full.std() > 0.01
    for y0, rows in BANDS:
        band = band_pipe.render_band(y0, rows, variant=variant).numpy()
        assert band.shape == (rows, 64, 3)
        np.testing.assert_array_equal(band, full[y0:y0 + rows])


def test_render_band_matches_jax(tiny_scene, band_pipe):
    jp = j_pipeline.prepare(JConfig(**KW, variant="jax"), scene=tiny_scene)
    for y0 in (0, 16):
        ref = np.asarray(jp.render_band(y0, 16, variant="jax"))
        for variant in ("fused", "pallas", "jax"):
            band = band_pipe.render_band(y0, 16, variant=variant).numpy()
            np.testing.assert_allclose(band, ref, atol=3e-5)


def test_cli_checkpoint_resume(tmp_path, monkeypatch):
    ck, out = tmp_path / "resume.npz", tmp_path / "out.bmp"
    argv = ["--device", "cpu", "--synthetic", "64", "--width", "32", "--height", "72",
            "--bounces", "2", "--band-rows", "32", "--checkpoint", str(ck), "--output",
            str(out), "--quiet"]
    bands = []
    real = pipeline.Pipeline.render_band

    def counting(self, y0, rows, *a, **k):
        bands.append((y0, rows))
        return real(self, y0, rows, *a, **k)

    monkeypatch.setattr(pipeline.Pipeline, "render_band", counting)
    assert cli.main(argv) == 0
    assert bands == [(0, 32), (32, 32), (64, 32)]  # the last band: 8 rows of a 32-row tile
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    img = pipeline.prepare(cfg, device="cpu").render().numpy()
    assert img.std() > 0.01 and out.read_bytes() == bmp_bytes(img)
    # a rerun resumes: every band is done, none is rendered again
    out.unlink()
    assert cli.main(argv) == 0
    assert len(bands) == 3 and out.read_bytes() == bmp_bytes(img)

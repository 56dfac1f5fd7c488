"""The port's packet traversal (ops/trace_bvh.py, variant="jax") against the
JAX package's, on the CPU.

Bit for bit: aabb_intersect, compress_bf16 (the bf16 bits against JAX's
ml_dtypes arrays) and device_bvh_from_flat (planes and stack_depth). The
per-packet loops packet_closest and packet_occluded against JAX's jitted
functions on packets of tiny_scene and of car_boxed's 1080p frame (a band
through the car, and incoherent rays from inside the room): equal miss
masks, t within atol 1e-4 and rtol 1e-5, idx agreement >= 0.999, blocked
agreement >= 0.9999 (what they agree to is recorded below). The batched
form (batched_closest, batched_occluded, make_tracer) equals the
per-packet form bit for bit, on both schedules (the split one, which
compacts the live packets every step, and the masked one of fixed-size
buckets, the card's, which runs every branch under masks), with the same
steps and visits, on those packets, on planted ties (duplicate triangles in
one leaf group and in two leaves) and with a stack that overflows (a push past the last slot overwrites it, as JAX's clamped
index does; JAX gives the same hits there). Frames: render(variant="jax")
of tiny_scene against JAX's render(variant="jax") at tests/test_fused.py's
frame bounds and against the port's brute force within atol 3e-5
(tests/test_trace_bvh.py), on f32 and bf16 boxes and on a frame that does
not fill its tiles; bvh_width 2 and 8 render the width-4 frame bit for bit
(the packet traversal reads the flat tree, not the tables). interpret=True
renders the default CPU frame bit for bit.

On the packets here the port's t equals JAX's bit for bit on most lanes,
not all: XLA's CPU code rounds some lanes' Möller–Trumbore differently;
the miss masks and idx are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_ray_tracer_tpu import pipeline as j_pipeline
from parallel_ray_tracer_tpu.config import RenderConfig as JConfig
from parallel_ray_tracer_tpu.models.device_scene import device_scene_from_host as j_ds
from parallel_ray_tracer_tpu.models.scene import load_scene_npz as j_load_npz
from parallel_ray_tracer_tpu.ops import intersect as j_intersect
from parallel_ray_tracer_tpu.ops import trace_bvh as j_tb
from parallel_ray_tracer_tpu.ops.bvh_flat import compress_bf16 as j_compress
from parallel_ray_tracer_tpu.ops.vecmath import Vec3 as JVec3
from parallel_ray_tracer_tpu_torch import pipeline
from parallel_ray_tracer_tpu_torch.config import DEFAULT_ASSET_ROOTS, RenderConfig
from parallel_ray_tracer_tpu_torch.models.camera import Camera, ray_basis
from parallel_ray_tracer_tpu_torch.models.device_scene import device_scene_from_host
from parallel_ray_tracer_tpu_torch.models.scene import Scene
from parallel_ray_tracer_tpu_torch.ops import intersect, trace_bvh
from parallel_ray_tracer_tpu_torch.ops.bvh import build_bvh
from parallel_ray_tracer_tpu_torch.ops.bvh_flat import compress_bf16, flatten_bvh
from parallel_ray_tracer_tpu_torch.ops.render import generate_rays_tiled
from parallel_ray_tracer_tpu_torch.ops.vecmath import Vec3

torch.set_num_threads(2)  # the suite's workers share the cores with XLA's pools

T_MAX = intersect.T_MAX


def _bits(a) -> np.ndarray:
    """The bit patterns of an f32 / bf16 array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy()
        return a.view(np.uint16 if a.dtype == np.int16 else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


def _jvec(v: Vec3) -> JVec3:
    return JVec3(*(jnp.asarray(p.numpy()) for p in v))


def _row(v: Vec3, i: int) -> Vec3:
    return Vec3(*(p[i] for p in v))


def _flat(scene, heuristic=6, leaf_size=8, **kw):
    tv = np.asarray(scene.triangle_vertices(), np.float32)
    return flatten_bvh(build_bvh(tv, heuristic=heuristic, **kw), tv, leaf_size=leaf_size)


class Case:
    """A scene's flat tree on both packages' devices, and packets of rays."""

    def __init__(self, scene, flat, o: Vec3, d: Vec3, j_scene=None):
        self.flat, self.o, self.d = flat, o, d
        self.ds = device_scene_from_host(scene, slot_map=flat.slot_map, device="cpu")
        self.jds = j_ds(j_scene or scene, slot_map=flat.slot_map)
        self.bvh, self.L, self.S = trace_bvh.device_bvh_from_flat(flat, device="cpu")
        self.jbvh, _, _ = j_tb.device_bvh_from_flat(flat)
        self._hits, self._shadows = {}, {}

    def packet(self, i):
        return _row(self.o, i), _row(self.d, i)

    def closest(self, i, S=None):
        """packet_closest of packet i (kept: the per-packet loop is slow)."""
        S = S or self.S
        if (i, S) not in self._hits:
            self._hits[i, S] = trace_bvh.packet_closest(self.bvh, self.ds, *self.packet(i),
                                                        self.L, S)
        return self._hits[i, S]

    def shadow_rays(self, i):
        """Shadow rays from the scene's first light toward the packet's
        closest hits, with the reversed window (dist - EPSILON)^2; the
        lanes that miss get the dead ray (origin 1e30, direction 0)."""
        if i in self._shadows:
            return self._shadows[i]
        o, d = self.packet(i)
        h = self.closest(i)
        p = o + d * torch.where(h.t < T_MAX, h.t, 0.0)
        lp = Vec3(*(c[0] for c in self.ds.lights_pos))
        to = p - Vec3(*(torch.full_like(p.x, float(c)) for c in lp))
        dist = torch.sqrt(to.dot(to))
        hit = (h.t < T_MAX) & (dist > 1e-3)
        so = Vec3(*(torch.where(hit, float(c), 1e30) for c in lp))
        sd = Vec3(*(torch.where(hit, c / dist, 0.0) for c in to))
        self._shadows[i] = so, sd, torch.where(hit, (dist - intersect.EPSILON) ** 2, 0.0)
        return self._shadows[i]


def _frame_packets(flat, scene, j_scene, y0, tiles, width=1920, height=1080, tile=32):
    cfg = RenderConfig()
    cam = Camera(pos=cfg.cam_pos, rot=cfg.cam_rot, fov=cfg.cam_fov)
    o, d = generate_rays_tiled(ray_basis(cam, width, height), width, tile, tile, tile,
                               device="cpu", y_offset=y0)
    K = tile * tile
    pick = torch.as_tensor(tiles)
    return Case(scene, flat, Vec3(*(p.reshape(-1, K)[pick] for p in o)),
                Vec3(*(p.reshape(-1, K)[pick] for p in d)), j_scene)


def _room_packet(flat, n=1024, seed=0):
    """Incoherent rays (a bounce's): origins inside the root box, uniform
    directions."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(flat.node_min[0], flat.node_max[0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (Vec3(*(torch.from_numpy(o[None, :, i].copy()) for i in range(3))),
            Vec3(*(torch.from_numpy(d[None, :, i].copy()) for i in range(3))))


@pytest.fixture(scope="module")
def car_case():
    """car_boxed's tree (the port's native builder, as prepare builds it) with
    three 32x32 packets of the 1080p frame's row band at y 704 (the car
    body, the floor, the wall) and one packet of incoherent rays."""
    p = pipeline.prepare(RenderConfig(scene="car_boxed", mxu_leaf=False), device="cpu")
    j_scene = j_load_npz(f"{DEFAULT_ASSET_ROOTS[0]}/car_boxed.npz")
    case = _frame_packets(p.flat, p.scene, j_scene, 704, [28, 12, 3])
    o, d = _room_packet(p.flat)
    case.o = Vec3(*(torch.cat([a, b]) for a, b in zip(case.o, o)))
    case.d = Vec3(*(torch.cat([a, b]) for a, b in zip(case.d, d)))
    return case


@pytest.fixture(scope="module")
def tiny_case(tiny_scene):
    flat = _flat(tiny_scene, heuristic=3, leaf_size=4)
    return _frame_packets(flat, tiny_scene, None, 16, [0, 1], width=32, height=32, tile=16)


# ---- ops/intersect.py, ops/bvh_flat.py, device_bvh_from_flat ------------------

def test_aabb_intersect_as_jax():
    rng = np.random.RandomState(1)
    n = 4096
    lo = rng.uniform(-2, 1, (3, n)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, (3, n)).astype(np.float32)
    o = rng.uniform(-4, 4, (3, n)).astype(np.float32)
    # most rays aimed near their box's centre, the rest anywhere
    d = (lo + hi) / 2 + rng.normal(scale=0.7, size=(3, n)).astype(np.float32) - o
    d[:, ::4] = rng.normal(size=(3, n))[:, ::4]
    d[0, :512] = 0.0                      # axis-parallel rays
    d[:, 512:640] = 0.0                   # dead rays ...
    o[:, 512:640] = 1e30                  # ... far outside every box
    o[:, 640:768] = lo[:, 640:768]        # origins on a face
    t = [Vec3(*(torch.from_numpy(a[i].copy()) for i in range(3))) for a in (lo, hi, o, d)]
    got = intersect.aabb_intersect(t[0], t[1], t[2], intersect.clip_inv_dir(t[3]))
    j = [JVec3(*(jnp.asarray(a[i]) for i in range(3))) for a in (lo, hi, o, d)]
    want = j_intersect.aabb_intersect(j[0], j[1], j[2], j_intersect.clip_inv_dir(j[3]))
    assert 0.2 < (got < T_MAX).float().mean() < 0.9       # non-vacuous
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_compress_bf16_as_jax(car_case):
    lo, hi = compress_bf16(car_case.flat)
    jlo, jhi = j_compress(car_case.flat)
    assert lo.dtype == hi.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(lo), _bits(jlo))
    np.testing.assert_array_equal(_bits(hi), _bits(jhi))
    assert (lo.float().numpy() <= car_case.flat.node_min).all()
    assert (hi.float().numpy() >= car_case.flat.node_max).all()
    assert (lo.float().numpy() < car_case.flat.node_min).any()   # rounding happened


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_device_bvh_as_jax(car_case, bf16):
    bvh, L, S = trace_bvh.device_bvh_from_flat(car_case.flat, bf16=bf16, device="cpu")
    jbvh, jL, jS = j_tb.device_bvh_from_flat(car_case.flat, bf16=bf16)
    assert (L, S) == (jL, jS) and bvh.device == torch.device("cpu")
    for mine, theirs in zip((*bvh.bb_min, *bvh.bb_max), (*jbvh.bb_min, *jbvh.bb_max)):
        assert mine.dtype == (torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_array_equal(_bits(mine), _bits(theirs))
    np.testing.assert_array_equal(bvh.count.numpy(), np.asarray(jbvh.count))
    np.testing.assert_array_equal(bvh.a.numpy(), np.asarray(jbvh.a))


# ---- the per-packet loops against JAX's jitted ones ---------------------------

def _hold_hits(h, jh):
    t, jt = h.t.numpy(), np.asarray(jh.t)
    miss, jmiss = t >= T_MAX, jt >= T_MAX
    np.testing.assert_array_equal(miss, jmiss)
    np.testing.assert_allclose(t[~miss], jt[~miss], atol=1e-4, rtol=1e-5)
    assert (h.idx.numpy() == np.asarray(jh.idx)).mean() >= 0.999
    return (~miss).sum()


@pytest.mark.parametrize("name", ["tiny", "car"])
def test_packets_as_jax(name, tiny_case, car_case):
    case = {"tiny": tiny_case, "car": car_case}[name]
    hits = 0
    for i in range(case.o.x.shape[0]):
        o, d = case.packet(i)
        jh = j_tb.packet_closest(case.jbvh, case.jds, _jvec(o), _jvec(d),
                                 leaf_size=case.L, stack_depth=case.S)
        hits += _hold_hits(case.closest(i), jh)
        so, sd, m2 = case.shadow_rays(i)
        b = trace_bvh.packet_occluded(case.bvh, case.ds, so, sd, m2, case.L, case.S)
        jb = j_tb.packet_occluded(case.jbvh, case.jds, _jvec(so), _jvec(sd),
                                  jnp.asarray(m2.numpy()), leaf_size=case.L,
                                  stack_depth=case.S)
        assert (b.numpy() == np.asarray(jb)).mean() >= 0.9999
    assert hits > case.o.x.numel() // 4     # non-vacuous


# ---- the batched form against the per-packet one ------------------------------

def _hold_batched(case, S=None, schedules=("split", "masked")):
    """Both schedules against the per-packet loop, and against each other's
    steps and visits."""
    S = S or case.S
    stats = []
    for schedule in schedules:
        hb = trace_bvh.batched_closest(case.bvh, case.ds, case.o, case.d, case.L, S,
                                       stats=stats, schedule=schedule)
        for i in range(case.o.x.shape[0]):
            for a, b in zip(case.closest(i, S), hb):
                assert torch.equal(a, b[i])
    if len(stats) == 2:
        split, masked = stats
        assert masked["schedule"] == "masked" and masked["live"] == split["live"]
        assert masked["leaf_visits"] == split["leaf_visits"] > 0
    return hb


def test_batched_equals_per_packet(car_case):
    """The closest hits and the shadow rays on the split schedule, the
    frame packets' shadow rays also on the masked one (test_stack_at_its_depth
    and test_planted_ties hold its closest hits: on the CPU it is slow)."""
    stats = []
    _hold_batched(car_case, schedules=("split",))
    so, sd, m2 = zip(*(car_case.shadow_rays(i) for i in range(car_case.o.x.shape[0])))
    so, sd = (Vec3(*(torch.stack(c) for c in zip(*v))) for v in (so, sd))
    m2 = torch.stack(m2)
    bb = trace_bvh.batched_occluded(car_case.bvh, car_case.ds, so, sd, m2, car_case.L,
                                    car_case.S, stats=stats)
    # the masked schedule on the three frame packets (on the CPU it is slow)
    rows = Vec3(*(p[:3] for p in so)), Vec3(*(p[:3] for p in sd)), m2[:3]
    for schedule in ("split", "masked"):
        got = trace_bvh.batched_occluded(car_case.bvh, car_case.ds, *rows, car_case.L,
                                         car_case.S, stats=stats, schedule=schedule)
        assert torch.equal(got, bb[:3])
    assert stats[2]["live"] == stats[1]["live"] and stats[2]["schedule"] == "masked"
    for i in range(so.x.shape[0]):
        b = trace_bvh.packet_occluded(car_case.bvh, car_case.ds, _row(so, i), _row(sd, i),
                                      m2[i], car_case.L, car_case.S)
        assert torch.equal(b, bb[i])
    assert stats[0]["visits"] > stats[0]["steps"] > 0 and bb.any()
    # make_tracer over the flat planes: the same hits, one packet a row
    closest, occluded = trace_bvh.make_tracer(car_case.bvh, car_case.ds, car_case.L,
                                              car_case.S, packet=1024)
    hb = trace_bvh.batched_closest(car_case.bvh, car_case.ds, car_case.o, car_case.d,
                                   car_case.L, car_case.S)
    hf = closest(car_case.o.reshape(-1), car_case.d.reshape(-1))
    for a, b in zip(hf, hb):
        assert torch.equal(a, b.reshape(-1))
    assert torch.equal(occluded(so.reshape(-1), sd.reshape(-1), m2.reshape(-1)),
                       bb.reshape(-1))


def test_stack_at_its_depth(car_case):
    """Two slots overflow on the incoherent packet: JAX's clamped index and
    the port's give the same hits, and the batched form the per-packet
    form's, though the overflow loses hits against a deep enough stack."""
    hb = _hold_batched(car_case, S=2)
    full = trace_bvh.batched_closest(car_case.bvh, car_case.ds, car_case.o, car_case.d,
                                     car_case.L, car_case.S)
    assert (hb.idx != full.idx).any()       # the overflow bit
    o, d = car_case.packet(3)
    jh = j_tb.packet_closest(car_case.jbvh, car_case.jds, _jvec(o), _jvec(d),
                             leaf_size=car_case.L, stack_depth=2)
    np.testing.assert_array_equal(hb.idx[3].numpy(), np.asarray(jh.idx))


def _tie_scene(tiny_scene):
    """tiny_scene with its floor's two triangles and its occluder repeated:
    every hit on them is a tie between two slots."""
    faces = np.concatenate([tiny_scene.faces, tiny_scene.faces[[0, 1, 3]]])
    mat_idx = np.concatenate([tiny_scene.mat_idx, tiny_scene.mat_idx[[0, 1, 3]]])
    return Scene(verts=tiny_scene.verts, faces=faces, mat_idx=mat_idx,
                 mats_kd=tiny_scene.mats_kd, mats_ks=tiny_scene.mats_ks,
                 mats_kr=tiny_scene.mats_kr, lights_pos=tiny_scene.lights_pos,
                 lights_kl=tiny_scene.lights_kl)


@pytest.mark.parametrize("leaf_size", [8, 1], ids=["one_leaf", "two_leaves"])
def test_planted_ties(tiny_scene, leaf_size):
    """The duplicates share a leaf group at L = 8 (the first slot of the
    minimum wins) and sit in different leaves at L = 1 (the first visited
    wins): the batched form, the per-packet form and JAX agree."""
    sc = _tie_scene(tiny_scene)
    flat = _flat(sc, heuristic=0, leaf_size=leaf_size, leaf_threshold=leaf_size)
    case = _frame_packets(flat, sc, None, 16, [0, 1], width=32, height=32, tile=16)
    hb = _hold_batched(case)
    dup = np.isin(flat.slot_map[np.clip(hb.idx.numpy(), 0, None)], [0, 1, 3, 4, 5, 6])
    assert (dup & (hb.idx.numpy() >= 0)).sum() > 100    # ties were resolved
    for i in range(2):
        o, d = case.packet(i)
        jh = j_tb.packet_closest(case.jbvh, case.jds, _jvec(o), _jvec(d),
                                 leaf_size=case.L, stack_depth=case.S)
        np.testing.assert_array_equal(hb.idx[i].numpy(), np.asarray(jh.idx))


# ---- frames -------------------------------------------------------------------

def _assert_frame_bounds(ref, img):
    assert img.shape == ref.shape and ref.std() > 0.01
    diff = np.abs(ref - img)
    assert (diff.max(axis=-1) < 1e-3).mean() > 0.99, diff.max()
    assert np.median(diff) < 1e-5


FRAMES = {"w4": ({}, 64, 48), "bf16": (dict(bf16_bvh=True), 64, 48),
          "padded": ({}, 50, 37)}


def _frame_cfg(w, h, **kw):
    return dict(dict(width=w, height=h, bounces=3, bvh_heuristic=6, tile_rows=16,
                     tile_cols=16, use_native=False, mxu_leaf=False), **kw)


@pytest.mark.parametrize("name", list(FRAMES))
def test_render_against_jax_and_brute(tiny_scene, name):
    kw, w, h = FRAMES[name]
    p = pipeline.prepare(RenderConfig(**_frame_cfg(w, h, **kw)), scene=tiny_scene,
                         device="cpu")
    img = p.render(variant="jax").numpy()
    assert img.shape == (h, w, 3)
    jp = j_pipeline.prepare(JConfig(**_frame_cfg(w, h, **kw)), scene=tiny_scene)
    _assert_frame_bounds(np.asarray(jp.render(variant="jax")), img)
    np.testing.assert_allclose(img, p.render(variant="bruteforce").numpy(), atol=3e-5)
    if name == "w4":
        for width in (2, 8):
            pw = pipeline.prepare(RenderConfig(**_frame_cfg(w, h, bvh_width=width)),
                                  scene=tiny_scene, device="cpu")
            assert np.array_equal(pw.render(variant="jax").numpy(), img)


@pytest.mark.parametrize("variant", ["fused", "pallas"])
def test_interpret_equals_default_cpu_frame(tiny_scene, variant):
    p = pipeline.prepare(RenderConfig(**_frame_cfg(64, 64, tile_rows=32, tile_cols=32)),
                         scene=tiny_scene, device="cpu")
    img = p.render(variant=variant)
    assert torch.equal(p.render(variant=variant, interpret=True), img)
    assert torch.equal(p.render_band(16, 32, variant=variant, interpret=True), img[16:48])

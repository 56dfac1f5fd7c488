"""Port of parallel_ray_tracer_tpu/ops/trace_bvh.py: the packet BVH traversal
(variant="jax") in torch ops.

The reference traces one ray per stack (cpu/src/bvh.c:317-358 closest hit,
:269-315 any-hit shadow). Here, as in JAX, a *packet* of K rays shares one
traversal stack: the stack and the node fetches are per packet, every slab
test and Möller–Trumbore test is a dense (K,) / (K, L) tensor op. A node is
visited when ANY lane of the packet can still be improved by it, so the
result is each ray's own closest hit; packets change only which nodes are
culled.

  - near child first (the reference's swap, cpu/src/bvh.c:344-350) is a
    majority vote of the packet's lanes, every lane voting: dead lanes
    (origin 1e30, direction 0) and the padding rays past the frame's edge
    too;
  - closest hit pushes a child only if some lane has t_child < t_best and
    ends when the stack empties;
  - any hit tests boxes against sqrt(max_dist2) (blocked lanes against 0),
    triangles by t * t < max_dist2, pushes the right child before the left,
    and ends when the stack empties or every lane is blocked.

A push always writes the node at stack[sp] and advances sp only when its
predicate holds; a push past the last slot overwrites it, and a pop past it
reads it, as JAX's dynamic_update_index_in_dim and gather clamp their
index. The leaf takes the first of equal minima over its L slots
(jnp.argmin, torch.argmin) and replaces the best hit only when strictly
nearer.

JAX traces a frame packet by packet (lax.while_loop inside lax.map).
`packet_closest` and `packet_occluded` are that loop for one packet of (K,)
planes, with the control flow on the host: the readable form, held against
JAX's jitted functions. `batched_closest` and `batched_occluded` trace P
packets at once, with a stack and a stack pointer per packet, (P,
stack_depth) and (P,): on every step each live packet pops one node and
takes the leaf or the inner branch of JAX's body, until its closest-hit
stack is empty, or its any-hit lanes are all blocked or its stack empty.
On the "split" schedule (the CPU's) a finished packet leaves the batch
before the next step; on the "masked" schedule (the card's) the packets
sit in a bucket whose steps replay as CUDA graphs, a finished one masked
until half or fewer are live and the live ones move to a smaller bucket
(_trace). Each packet visits JAX's nodes in JAX's order, so the batched
form returns what P calls of the per-packet form return, bit for bit, ties
included, on either schedule; `make_tracer` uses it.
JAX computes this path outside Pallas, and so does the port: no custom
kernel, on the CPU and on the card alike.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .bvh_flat import compress_bf16
from .intersect import EPSILON, T_MAX, aabb_intersect, clip_inv_dir, moller_trumbore
from .spheres import wrap_tracer
from .trace_plain import Hit
from .vecmath import Vec3


class DeviceBVH(NamedTuple):
    """Flat SoA BVH on one device. Planes (N,); bf16 boxes when compressed
    (cast to f32 when a node is read)."""

    bb_min: Vec3
    bb_max: Vec3
    count: torch.Tensor   # (N,) i32; > 0 leaf, 0 inner
    a: torch.Tensor       # (N,) i32; leaf: base triangle slot; inner: left child

    @property
    def device(self) -> torch.device:
        return self.count.device


def device_bvh_from_flat(flat, bf16: bool = False,
                         device="cuda") -> Tuple[DeviceBVH, int, int]:
    """Upload a host FlatBVH to `device` (the card unless the caller asks
    for the CPU); returns (bvh, leaf_size, stack_depth). bf16 boxes come
    from bvh_flat.compress_bf16 (min down, max up)."""
    device = torch.device(device)
    if bf16:
        lo, hi = compress_bf16(flat)
    else:
        lo = torch.from_numpy(np.ascontiguousarray(flat.node_min, np.float32))
        hi = torch.from_numpy(np.ascontiguousarray(flat.node_max, np.float32))

    def planes(m: torch.Tensor) -> Vec3:
        return Vec3(*(m[:, i].contiguous().to(device) for i in range(3)))

    bvh = DeviceBVH(
        bb_min=planes(lo),
        bb_max=planes(hi),
        count=torch.as_tensor(np.asarray(flat.count, np.int32), device=device),
        a=torch.as_tensor(np.asarray(flat.a, np.int32), device=device),
    )
    # Packet traversal can push both children per level: bound the stack by
    # tree depth + 2 rounded to a friendly size (JAX's bound).
    stack_depth = max(16, 2 * (flat.depth + 2))
    return bvh, flat.leaf_size, stack_depth


def _node_aabb(bvh: DeviceBVH, i) -> Tuple[Vec3, Vec3]:
    lo = Vec3(*(p[i].float() for p in bvh.bb_min))
    hi = Vec3(*(p[i].float() for p in bvh.bb_max))
    return lo, hi


def _group_base(a, L: int, n_slots: int):
    """The first slot of a leaf group, clamped as dynamic_slice clamps it."""
    return min(max(a, 0), n_slots - L) if isinstance(a, int) else a.clamp(0, n_slots - L)


def _group_tris(ds, base: int, L: int):
    """The L-triangle leaf group starting at slot `base` as (1, L) planes."""
    b = _group_base(base, L, ds.num_triangles)

    def sl(v: Vec3) -> Vec3:
        return Vec3(*(p[None, b:b + L] for p in v))

    return sl(ds.v0), sl(ds.v1), sl(ds.v2)


def _push(stack: torch.Tensor, sp: int, node: int, pred: bool) -> int:
    """Write `node` at stack[sp] (the last slot past the end); advance sp
    only when pred (JAX's lane-masked push without control flow)."""
    stack[min(sp, stack.shape[0] - 1)] = node
    return sp + int(pred)


def _column(v: Vec3) -> Vec3:
    return Vec3(*(p[:, None] for p in v))


def packet_closest(bvh: DeviceBVH, ds, o: Vec3, d: Vec3, leaf_size: int = 4,
                   stack_depth: int = 64) -> Hit:
    """Closest hit for one packet; o, d: Vec3 of (K,) planes (JAX :100)."""
    L = leaf_size
    K = o.x.shape[0]
    dev = o.x.device
    inv_d = clip_inv_dir(d)
    stack = torch.zeros((stack_depth,), dtype=torch.int32, device=dev)  # root at slot 0
    sp = 1
    t = torch.full((K,), T_MAX, dtype=torch.float32, device=dev)
    idx = torch.full((K,), -1, dtype=torch.int32, device=dev)
    nd = torch.zeros((K,), dtype=torch.bool, device=dev)
    while sp > 0:
        sp -= 1
        node = int(stack[min(sp, stack_depth - 1)])
        cnt, a = int(bvh.count[node]), int(bvh.a[node])
        if cnt > 0:
            h = moller_trumbore(_column(o), _column(d), *_group_tris(ds, a, L))  # (K, L)
            am = h.t.argmin(dim=1, keepdim=True)
            t_c = h.t.gather(1, am)[:, 0]
            nd_c = h.norm_dir.gather(1, am)[:, 0]
            better = t_c < t
            t = torch.where(better, t_c, t)
            idx = torch.where(better, a + am[:, 0].to(torch.int32), idx)
            nd = torch.where(better, nd_c, nd)
        else:
            tl = aabb_intersect(*_node_aabb(bvh, a), o, inv_d)      # (K,)
            tr = aabb_intersect(*_node_aabb(bvh, a + 1), o, inv_d)
            hit_l, hit_r = bool((tl < t).any()), bool((tr < t).any())
            # Majority vote on the near child (cpu/src/bvh.c:344-350).
            left_near = int((tl < tr).sum()) * 2 >= K
            near, far = (a, a + 1) if left_near else (a + 1, a)
            near_hit, far_hit = (hit_l, hit_r) if left_near else (hit_r, hit_l)
            sp = _push(stack, sp, far, far_hit)
            sp = _push(stack, sp, near, near_hit)
    return Hit(t=t, idx=idx, norm_dir=nd)


def packet_occluded(bvh: DeviceBVH, ds, o: Vec3, d: Vec3, max_dist2: torch.Tensor,
                    leaf_size: int = 4, stack_depth: int = 64) -> torch.Tensor:
    """Any-hit occlusion for one packet: True where a triangle lies between
    o and sqrt(max_dist2) along unit d (cpu/src/bvh.c:269-315; JAX :173)."""
    L = leaf_size
    K = o.x.shape[0]
    inv_d = clip_inv_dir(d)
    t_limit = torch.sqrt(max_dist2)      # d is unit for shadow rays
    stack = torch.zeros((stack_depth,), dtype=torch.int32, device=o.x.device)
    sp = 1
    blocked = torch.zeros((K,), dtype=torch.bool, device=o.x.device)
    while sp > 0 and not bool(blocked.all()):
        sp -= 1
        node = int(stack[min(sp, stack_depth - 1)])
        cnt, a = int(bvh.count[node]), int(bvh.a[node])
        if cnt > 0:
            h = moller_trumbore(_column(o), _column(d), *_group_tris(ds, a, L))
            near = (h.t < T_MAX) & (h.t * h.t < max_dist2[:, None])
            blocked = blocked | near.any(dim=1)
        else:
            tl = aabb_intersect(*_node_aabb(bvh, a), o, inv_d)
            tr = aabb_intersect(*_node_aabb(bvh, a + 1), o, inv_d)
            active_limit = torch.where(blocked, 0.0, t_limit)
            hit_l, hit_r = bool((tl < active_limit).any()), bool((tr < active_limit).any())
            # No useful order for any hit (cpu/src/bvh.c:298-313): push the
            # left child last so that it pops first.
            sp = _push(stack, sp, a + 1, hit_r)
            sp = _push(stack, sp, a, hit_l)
    return blocked


# ---------------------------------------------------------------------------
# Every packet of a frame at once
# ---------------------------------------------------------------------------

# A triangle slot's row (18 floats): v0 and its components rotated once and
# twice (yzx, zxy), e1 = v1 - v0, e2 = v2 - v0, n = e1 x e2. A ray's rows:
# o and its two rotations, d and its two rotations (18, for the leaf test),
# and o with the clipped 1/d (6, for the slab test). With the rotations each
# step of the cross and dot products is one tensor op over all three
# components.
class _Tables(NamedTuple):
    box: torch.Tensor     # (N, 6) f32: lo.xyz, hi.xyz
    count: torch.Tensor   # (N,) i32
    a: torch.Tensor       # (N,) i64
    tri: torch.Tensor     # (T, 18) f32: the triangle slots' rows


def _rotations(v: Vec3):
    return [*v, v.y, v.z, v.x, v.z, v.x, v.y]


def _tables(bvh: DeviceBVH, ds) -> _Tables:
    """Node rows and triangle rows for the batched loop. The edges and the
    normal are moller_trumbore's own first operations, done once per slot
    instead of once per visit (the same values). The triangles are the
    scene's, detached: the traversal is outside any gradient."""
    box = torch.stack([p.float() for p in (*bvh.bb_min, *bvh.bb_max)], dim=1)
    v0, v1, v2 = (Vec3(*(p.detach() for p in v)) for v in (ds.v0, ds.v1, ds.v2))
    e1 = v1 - v0
    e2 = v2 - v0
    n = e1.cross(e2)
    tri = torch.stack([*_rotations(v0), *e1, *e2, *n], dim=1)
    return _Tables(box=box, count=bvh.count, a=bvh.a.long(), tri=tri)


def _dot3(p: torch.Tensor) -> torch.Tensor:
    """x + y + z of a (3, ...) product, in Vec3.dot's order."""
    return (p[0] + p[1]) + p[2]


def _mt_rows(r: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """moller_trumbore's t after its edges and normal, the same operations in
    the same order (cross(ao, d) = ao_yzx d_zxy - ao_zxy d_yzx), for ray rows
    r (18, ...) and triangle rows g (18, ...) that broadcast. u >= 0 and
    v >= 0 is min(u, v) >= 0, the same answer for every value, NaN too."""
    ao = r[0:9] - g[0:9]                    # ao and its rotations
    d, d_yzx, d_zxy = r[9:12], r[12:15], r[15:18]
    e1, e2, n = g[9:12], g[12:15], g[15:18]
    det = -_dot3(d * n)
    ok = det.abs() >= EPSILON
    invdet = 1.0 / torch.where(ok, det, 1.0)
    dao = ao[3:6] * d_zxy - ao[6:9] * d_yzx
    u = _dot3(e2 * dao) * invdet
    v = -_dot3(e1 * dao) * invdet
    t = _dot3(ao[0:3] * n) * invdet
    hit = ok & (t > EPSILON) & (torch.minimum(u, v) >= 0.0) & ((u + v) <= 1.0)
    return torch.where(hit, t, T_MAX)


def _slab_rows(b: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """aabb_intersect for box rows b (6, ...) and ray rows r (o, 1/d: 6,
    ...): the per-axis minima and maxima are exact, so taking them over the
    three axes at once gives aabb_intersect's values."""
    o, inv = r[0:3], r[3:6]
    t1 = (b[0:3] - o) * inv
    t2 = (b[3:6] - o) * inv
    tmin = torch.minimum(t1, t2).amax(dim=0)
    tmax = torch.maximum(t1, t2).amin(dim=0)
    hit = (tmax >= tmin) & (tmax > 0.0)
    return torch.where(hit, tmin, T_MAX)


def _trace_split(tab: _Tables, tri_rays, box_rays, L: int, S: int, max_dist2, counts,
                 info):
    """The "split" schedule over P packets: every step the live packets are
    sorted into those that pop a leaf and those that pop an inner node, each
    group runs its branch alone, and the finished packets leave (one host
    sync a step). Returns (t, idx) or blocked, (P, K)."""
    _, P, K = tri_rays.shape
    dev = tri_rays.device
    occl = max_dist2 is not None
    lanes = torch.arange(L, device=dev)
    stack = torch.zeros((P, S), dtype=torch.int64, device=dev)         # root at slot 0
    sp = torch.ones((P,), dtype=torch.int64, device=dev)
    if occl:
        blocked = torch.zeros((P, K), dtype=torch.bool, device=dev)
        t_limit = torch.sqrt(max_dist2)     # d is unit for shadow rays
    else:
        t = torch.full((P, K), T_MAX, dtype=torch.float32, device=dev)
        idx = torch.full((P, K), -1, dtype=torch.int64, device=dev)
    live = torch.arange(P, device=dev)
    while True:
        # Which live packets pop a leaf (0), an inner node (1), or are done
        # (2): one host sync a step, which also drops the finished packets.
        sp_l = sp[live]
        done = sp_l <= 0
        if occl:
            done |= blocked[live].all(dim=1)
        node = stack[live, (sp_l - 1).clamp(0, S - 1)]
        code = torch.where(done, 2, (tab.count[node] <= 0).long())
        order = torch.argsort(code, stable=True)
        n_leaf, n_inner = torch.bincount(code, minlength=3)[:2].tolist()
        if n_leaf + n_inner == 0:
            break
        order = order[:n_leaf + n_inner]
        live, node, sp_l = live[order], node[order], sp_l[order] - 1
        a = tab.a[node]
        sp[live] = sp_l
        counts.append((n_leaf + n_inner, n_leaf))
        if n_leaf:
            pl, al = live[:n_leaf], a[:n_leaf]
            g = tab.tri[_group_base(al, L, tab.tri.shape[0])[:, None] + lanes]   # (n, L, 18)
            tt = _mt_rows(tri_rays[:, pl, :, None], g.permute(2, 0, 1)[:, :, None])
            if occl:                                                      # (n, K, L)
                near = (tt < T_MAX) & (tt * tt < max_dist2[pl][..., None])
                blocked[pl] = blocked[pl] | near.any(dim=2)
            else:
                t_c, am = tt.min(dim=2)       # the first of equal minima
                t_old = t[pl]
                better = t_c < t_old
                t[pl] = torch.where(better, t_c, t_old)
                idx[pl] = torch.where(better, al[:, None] + am, idx[pl])
        if n_inner:
            pi, ai = live[n_leaf:], a[n_leaf:]
            b = tab.box[torch.stack([ai, ai + 1], dim=1)]                      # (n, 2, 6)
            tb = _slab_rows(b.permute(2, 0, 1)[..., None], box_rays[:, pi, None])  # (n, 2, K)
            ai1 = ai + 1
            if occl:
                limit = torch.where(blocked[pi], 0.0, t_limit[pi])
                hits = (tb < limit[:, None]).any(dim=2)                        # (n, 2)
                # push the right child, then the left, so the left pops first
                first, second, first_hit, second_hit = ai1, ai, hits[:, 1], hits[:, 0]
            else:
                hits = (tb < t[pi][:, None]).any(dim=2)
                # majority vote on the near child (2 * lanes with tl < tr >= K);
                # the far one is pushed first
                left_near = (tb[:, 0] < tb[:, 1]).sum(dim=1) >= (K + 1) // 2
                first = torch.where(left_near, ai1, ai)
                second = torch.where(left_near, ai, ai1)
                first_hit = torch.where(left_near, hits[:, 1], hits[:, 0])
                second_hit = torch.where(left_near, hits[:, 0], hits[:, 1])
            spi = sp_l[n_leaf:]
            stack[pi, spi.clamp(max=S - 1)] = first
            spi = spi + first_hit
            stack[pi, spi.clamp(max=S - 1)] = second
            sp[pi] = spi + second_hit
    return blocked if occl else (t, idx)


# ---------------------------------------------------------------------------
# The "masked" schedule: fixed-size buckets, CUDA graphs on the card
# ---------------------------------------------------------------------------

GRAPH_STEPS = 8       # steps a bucket runs (one CUDA graph replay) between host checks
MIN_BUCKET = 8        # the smallest bucket, in packets


class _Bucket:
    """B packet rows of fixed shape: their ray rows, stacks, stack pointers
    and hits (or blocked lanes), and the per-step counts of live packets and
    leaf visits. A row whose stack pointer is 0 (or, for any hit, whose
    lanes are all blocked) is done: the masked step leaves it as it is. On
    the card GRAPH_STEPS masked steps are captured once into a CUDA graph
    and replayed; on the CPU they run as they are."""

    def __init__(self, tabs: _Tables, occl: bool, B: int, K: int, L: int, S: int):
        dev = tabs.box.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.tabs, self.occl, self.B, self.L, self.S = tabs, occl, B, L, S
        self.tri_rays = torch.zeros((18, B, K), **f32)
        self.box_rays = torch.zeros((6, B, K), **f32)
        # column S takes the pushes of the rows that do not push: no pop
        # reads past S - 1
        self.stack = torch.zeros((B, S + 1), dtype=torch.int64, device=dev)
        self.sp = torch.zeros((B,), dtype=torch.int64, device=dev)
        if occl:
            self.blocked = torch.zeros((B, K), dtype=torch.bool, device=dev)
            self.m2 = torch.zeros((B, K), **f32)
            self.limit = torch.zeros((B, K), **f32)
        else:
            self.t = torch.full((B, K), T_MAX, **f32)
            self.idx = torch.full((B, K), -1, dtype=torch.int64, device=dev)
        self.hist = torch.zeros((GRAPH_STEPS, 2), dtype=torch.int64, device=dev)
        self.lanes = torch.arange(L, device=dev)
        self.graph = None
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self.step(0)          # every row done: changes nothing
                torch.cuda.current_stream().wait_stream(side)
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    for j in range(GRAPH_STEPS):
                        self.step(j)

    def state(self):
        return (("stack", "sp", "blocked", "m2", "limit") if self.occl
                else ("stack", "sp", "t", "idx"))

    def step(self, j: int) -> None:
        """One step of every row: a live row pops a node and takes JAX's
        leaf or inner branch, with exactly the split schedule's operations;
        the other rows' state is kept by masks."""
        tabs, S, L = self.tabs, self.S, self.L
        sp = self.sp
        live = sp > 0
        if self.occl:
            live = live & ~self.blocked.all(dim=1)
        node = self.stack.gather(1, (sp - 1).clamp(0, S - 1)[:, None])[:, 0]
        is_leaf = tabs.count[node] > 0
        a = tabs.a[node]
        leaf = live & is_leaf
        inner = live & ~is_leaf
        self.hist[j] = torch.stack([live, leaf]).sum(dim=1)
        sp = sp - live.long()
        g = tabs.tri[_group_base(a, L, tabs.tri.shape[0])[:, None] + self.lanes]   # (B, L, 18)
        tt = _mt_rows(self.tri_rays[..., None], g.permute(2, 0, 1)[:, :, None])    # (B, K, L)
        if self.occl:
            near = (tt < T_MAX) & (tt * tt < self.m2[..., None])
            self.blocked |= near.any(dim=2) & leaf[:, None]
            limit = torch.where(self.blocked, 0.0, self.limit)
        else:
            t_c, am = tt.min(dim=2)           # the first of equal minima
            better = (t_c < self.t) & leaf[:, None]
            torch.where(better, a[:, None] + am, self.idx, out=self.idx)
            torch.where(better, t_c, self.t, out=self.t)
            limit = self.t
        ac = a.clamp(0, tabs.box.shape[0] - 2)
        ac1 = ac + 1
        b = tabs.box[torch.stack([ac, ac1], dim=1)]                              # (B, 2, 6)
        tb = _slab_rows(b.permute(2, 0, 1)[..., None], self.box_rays[:, :, None])  # (B, 2, K)
        hits = (tb < limit[:, None]).any(dim=2) & inner[:, None]
        if self.occl:
            first, second, first_hit, second_hit = ac1, ac, hits[:, 1], hits[:, 0]
        else:
            left_near = (tb[:, 0] < tb[:, 1]).sum(dim=1) >= (tb.shape[2] + 1) // 2
            first = torch.where(left_near, ac1, ac)
            second = torch.where(left_near, ac, ac1)
            first_hit = torch.where(left_near, hits[:, 1], hits[:, 0])
            second_hit = torch.where(left_near, hits[:, 0], hits[:, 1])
        for node_, hit_ in ((first, first_hit), (second, second_hit)):
            pos = torch.where(inner, sp.clamp(max=S - 1), S)[:, None]
            self.stack.scatter_(1, pos, node_[:, None])
            sp = sp + hit_
        self.sp.copy_(sp)

    def run(self) -> None:
        if self.graph is not None:
            with torch.cuda.device(self.sp.device):
                self.graph.replay()
        else:
            for j in range(GRAPH_STEPS):
                self.step(j)


_STATIC = {}
_BUCKETS = {}


def _static_tables(tab: _Tables) -> _Tables:
    """The device's tables of tab's sizes at fixed addresses, which the
    buckets' graphs read, with tab copied in (each pass copies its own)."""
    key = (tab.box.device, tab.box.shape[0], tab.tri.shape[0])
    st = _STATIC.get(key)
    if st is None:
        st = _STATIC[key] = _Tables(*(torch.empty_like(x) for x in tab))
    for dst, src in zip(st, tab):
        dst.copy_(src)
    return st


def _bucket(tabs: _Tables, occl: bool, n: int, K: int, L: int, S: int,
            info: dict) -> _Bucket:
    """The bucket of n packets, made (and on the card captured) at first use;
    info["capture_s"] adds the seconds that took."""
    B = max(MIN_BUCKET, 1 << max(n - 1, 0).bit_length())
    key = (tabs.box.device, tabs.box.shape[0], tabs.tri.shape[0], occl, B, K, L, S)
    if key not in _BUCKETS:
        t0 = time.perf_counter()
        _BUCKETS[key] = _Bucket(tabs, occl, B, K, L, S)
        info["capture_s"] = info.get("capture_s", 0.0) + time.perf_counter() - t0
    return _BUCKETS[key]


def _trace_masked(tab: _Tables, tri_rays, box_rays, L: int, S: int, max_dist2, counts,
                  info):
    """The "masked" schedule over P packets: the packets sit in a bucket of B
    rows (the next power of two), every row takes both branches under masks
    (the work of B packets a step, and no host sync), and the host checks
    every GRAPH_STEPS steps; when half of the rows or fewer are live, they
    move to the bucket of their count. Returns (t, idx) or blocked; info
    gets the graph replays (or eager runs) and the buckets' sizes."""
    _, P, K = tri_rays.shape
    dev = tri_rays.device
    occl = max_dist2 is not None
    tabs = _static_tables(tab)
    if occl:
        out = torch.zeros((P, K), dtype=torch.bool, device=dev)
        rows = dict(blocked=out, m2=max_dist2, limit=torch.sqrt(max_dist2))
    else:
        out_t = torch.full((P, K), T_MAX, dtype=torch.float32, device=dev)
        out_idx = torch.full((P, K), -1, dtype=torch.int64, device=dev)
        rows = dict(t=out_t, idx=out_idx)
    rows.update(stack=torch.zeros((P, S), dtype=torch.int64, device=dev),
                sp=torch.ones((P,), dtype=torch.int64, device=dev))
    ids = torch.arange(P, device=dev)
    b, n = None, P

    def fill(bk: _Bucket, sel) -> None:
        """Rows sel of the previous bucket (of the pass's planes when b is
        None) become bk's rows 0..n-1; the rest are done."""
        src = rows if b is None else {k: getattr(b, k) for k in bk.state()}
        bk.tri_rays[:, :n] = (tri_rays if b is None else b.tri_rays)[:, sel]
        bk.box_rays[:, :n] = (box_rays if b is None else b.box_rays)[:, sel]
        for k in bk.state():
            if k == "stack":
                bk.stack[:n, :S] = src[k][sel][:, :S]
            else:
                getattr(bk, k)[:n] = src[k][sel]
        bk.sp[n:] = 0

    bk = _bucket(tabs, occl, n, K, L, S, info)
    fill(bk, ids)
    b = bk
    info.update(replays=0, buckets=[b.B])
    while True:
        b.run()
        info["replays"] += 1
        alive = b.sp[:n] > 0
        if occl:
            alive &= ~b.blocked[:n].all(dim=1)
        got = torch.cat([b.hist.reshape(-1), alive.sum().reshape(1)]).tolist()
        counts += [(nl, nleaf) for nl, nleaf in zip(got[0:-1:2], got[1:-1:2]) if nl]
        n_live = got[-1]
        if n_live and (n_live > b.B // 2 or b.B == MIN_BUCKET):
            continue
        if occl:
            out[ids] = b.blocked[:n]
        else:
            out_t[ids] = b.t[:n]
            out_idx[ids] = b.idx[:n]
        if not n_live:
            break
        sel = alive.nonzero()[:, 0]
        ids, n = ids[sel], n_live
        bk = _bucket(tabs, occl, n, K, L, S, info)
        fill(bk, sel)
        b = bk
        info["buckets"].append(b.B)
    return out if occl else (out_t, out_idx)


SCHEDULES = ("auto", "split", "masked")


def _trace(tab: _Tables, o: Vec3, d: Vec3, L: int, S: int, max_dist2=None,
           stats: Optional[List[dict]] = None, schedule: str = "auto"):
    """Every packet of (P, K) ray planes at once: closest hit, or any hit
    when max_dist2 is given -> (t, idx, norm_dir) or blocked, (P, K).
    schedule "split" or "masked" ("auto": masked on the card, split on the
    CPU); both visit each packet's nodes in JAX's order and give the same
    bits. `stats` gets the pass's steps, packet visits (leaf visits among
    them), live packets a step, and host seconds (each schedule syncs with
    the device, so they include the device's); for "masked" also the
    replays, the bucket sizes and the seconds spent making (capturing) new
    buckets."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r}: one of {SCHEDULES}")
    t_start = time.perf_counter()
    P, K = o.x.shape
    if schedule == "auto":
        schedule = "masked" if o.x.device.type == "cuda" else "split"
    tri_rays = torch.stack([*_rotations(o), *_rotations(d)])            # (18, P, K)
    box_rays = torch.stack([*o, *clip_inv_dir(d)])                      # (6, P, K)
    counts, info = [], {}
    out = (_trace_masked if schedule == "masked" else _trace_split)(
        tab, tri_rays, box_rays, L, S, max_dist2, counts, info)
    if stats is not None:
        stats.append({"kind": "closest" if max_dist2 is None else "occluded",
                      "schedule": schedule, "packets": P, "lanes": K,
                      "steps": len(counts), "visits": sum(c[0] for c in counts),
                      "leaf_visits": sum(c[1] for c in counts),
                      "live": [c[0] for c in counts],
                      "seconds": time.perf_counter() - t_start, **info})
    if max_dist2 is not None:
        return out
    t, idx = out
    # norm_dir is the winner's det < 0, recomputed from its slot with the
    # leaf test's operations (the same bits); no hit keeps False.
    n = tab.tri[idx.clamp(min=0)][..., 15:18].movedim(-1, 0)
    nd = (idx >= 0) & (-_dot3(tri_rays[9:12] * n) < 0.0)
    return t, idx.to(torch.int32), nd


def batched_closest(bvh: DeviceBVH, ds, o: Vec3, d: Vec3, leaf_size: int = 4,
                    stack_depth: int = 64, stats: Optional[List[dict]] = None,
                    schedule: str = "auto") -> Hit:
    """Closest hit for P packets at once; o, d: Vec3 of (P, K) planes, one
    packet a row. What P calls of packet_closest return, bit for bit, on
    either schedule (_trace). `stats`, a list, gets the pass's steps, packet
    visits and live packets a step."""
    t, idx, nd = _trace(_tables(bvh, ds), o, d, leaf_size, stack_depth, stats=stats,
                        schedule=schedule)
    return Hit(t=t, idx=idx, norm_dir=nd)


def batched_occluded(bvh: DeviceBVH, ds, o: Vec3, d: Vec3, max_dist2: torch.Tensor,
                     leaf_size: int = 4, stack_depth: int = 64,
                     stats: Optional[List[dict]] = None,
                     schedule: str = "auto") -> torch.Tensor:
    """Any-hit occlusion for P packets at once, (P, K) planes: what P calls
    of packet_occluded return."""
    return _trace(_tables(bvh, ds), o, d, leaf_size, stack_depth, max_dist2, stats,
                  schedule)


def make_tracer(bvh: DeviceBVH, ds, leaf_size: int, stack_depth: int, packet: int,
                stats: Optional[List[dict]] = None, schedule: str = "auto"):
    """(closest, occluded) over flat (R,) ray planes, R % packet == 0 (JAX
    :234): each run of `packet` rays is one packet, and every packet of a
    call is traced at once (batched_closest, batched_occluded). Sphere
    primitives are tested in a dense post-pass (ops/spheres.wrap_tracer).
    `stats`, a list, gets one record a pass (steps, packet visits, live
    packets a step); `schedule` as _trace's."""
    tab = _tables(bvh, ds)

    def packets(o: Vec3) -> int:
        R = o.x.shape[0]
        if R % packet:
            raise ValueError(f"{R} rays are not whole packets of {packet}")
        return R // packet

    def closest(o: Vec3, d: Vec3) -> Hit:
        n = packets(o)
        t, idx, nd = _trace(tab, o.reshape(n, packet), d.reshape(n, packet),
                            leaf_size, stack_depth, stats=stats, schedule=schedule)
        return Hit(t=t.reshape(-1), idx=idx.reshape(-1), norm_dir=nd.reshape(-1))

    def occluded(o: Vec3, d: Vec3, max_dist2: torch.Tensor) -> torch.Tensor:
        n = packets(o)
        return _trace(tab, o.reshape(n, packet), d.reshape(n, packet), leaf_size,
                      stack_depth, max_dist2.reshape(n, packet), stats,
                      schedule).reshape(-1)

    return wrap_tracer(ds, closest, occluded)

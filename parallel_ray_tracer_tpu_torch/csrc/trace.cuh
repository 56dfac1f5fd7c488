// BVH traversal kernels for Hopper (sm_90a): closest hit, closest hit with
// attributes, any hit, and the fused whole-frame bounce loop, each for node
// arity A = 2, 4 and 8 (the frame for A = 4 and 8 only, as in JAX), and for
// the node-box format F of the table (RtBox below); closest and any hit also
// with streamed leaf rows (STREAM, A 4 and 8, F32 and PAIRS, as in JAX);
// closest, any hit and the frame also with the MXU leaf (MXU, A 4 and 8,
// F32 and PAIRS, leaf rows resident, as in JAX).
//
// They replace the Pallas TPU kernels of parallel_ray_tracer_tpu/ops/
// pallas_trace.py and compute the same functions:
//   closest_kernel<A, F, false>  <- _closest_dual_kernel(n_attr=0) :1774 (A 4, 8),
//                                   _closest4_kernel :825 (A 4, 8),
//                                   _closest_kernel :610 (A 2)
//   closest_kernel<A, F, true>   <- _closest_dual_kernel(n_attr=12) :1774 (A 4, 8),
//                                   _closest_attr_kernel :2437 (A 2, 4, 8)
//   occluded_kernel<A, F>        <- _occluded_dual_kernel :1835 (A 4, 8),
//                                   _occluded4_kernel :886 (A 4, 8),
//                                   _occluded_kernel :676 (A 2)
//   frame_kernel<A, F>           <- _frame_fused_kernel :2536 (A 4, 8)
//   frame_kernel<A, F, SPH = true>
//                                <- _frame_fused_kernel with num_spheres > 0:
//                                   sphere_t :2604, sphere_closest_merge :2626,
//                                   sphere_occluded_merge :2655
//   closest_kernel<A, F, FULL, STREAM = true>
//                                <- _closest_stream_kernel(n_attr=0, 12) :2070
//   occluded_kernel<A, F, STREAM = true>
//                                <- _occluded_stream_kernel :2253
//   closest_kernel<..., MXU = true>, occluded_kernel<..., MXU = true>,
//   frame_kernel<..., MXU = true>
//                                <- the same kernels' mxu=True instances:
//                                   the MXU leaf _mxu_* :1002-1466 on the
//                                   C-matrices of _build_cmat :227
// each at leaf size L = 8, 4, 2 and 1 (the kernels' last template parameter;
// the JAX factories' L; the MXU instances at L = 8 and 4 only), the frame
// with shadow rays in either direction, with F = RT_F32 for f32 tables, RT_PAIRS for those kernels' compressed=True
// instances at A 4 and 8 (_load_node_row :740-758, _child_extract :761-764,
// rows of pack_box_bf16_pairs :438), and RT_BF16 for _closest_kernel,
// _closest_attr_kernel and _occluded_kernel on a bf16 binary table
// (cbox_to_bf16 :487, read with .astype(f32)).
// The TPU kernels trace a 1024-ray packet with one scalar stack, popping one
// node (single pop) or two (dual pop) per step; the schedule changes the
// visit order, not the result. Here one thread traces one ray with a
// private stack, the design of the reference CUDA renderer, so single-pop
// and dual-pop callers reach the same instance; at L = 8 (the MXU any-hit
// pass at L = 4 too) the closest-hit and any-hit passes walk their warp's
// rays together ("the pass kernels" below: a while-while loop with a
// postponed leaf).
//
// What bounds them on this card: the traversal is a data-dependent loop of
// dependent loads (node row -> child boxes -> pushed entry -> next row), so
// latency of L1/L2 reads and warp divergence bound it, far below both the
// FP32 rate and the memory rate. The scene tables (about 9 MB for car_boxed,
// 31 MB of tri + attr for the dragon) sit in the 50 MB L2. What the design
// does about it: node rows are read as 16-byte loads through the read-only
// path (an f32 row three per pair of children, so the 8-wide row is not held
// in registers whole; a bf16 row half of that), leaf triangles as 3 float4
// loads each; children are sorted near-first and each stack entry keeps its
// box entry distance, so a closest-hit pop whose box lies beyond the current
// hit is dropped without a load; an any-hit ray stops at its first blocker;
// dead rays do not traverse. Rays are in tile-major order, so a warp holds
// 32 neighbouring pixels and its threads walk similar paths.
//
// bf16 boxes (RT_PAIRS, RT_BF16) are rounded conservatively when packed: min
// planes down, max planes up, so each box encloses its f32 box. Widening a
// bf16 value to f32 is exact (a 16-bit shift or mask), and the slab test is
// then the same arithmetic on a wider box. Culling stays exact: a child is
// dropped only if its wider box is missed, which the f32 box then is too.
// The drop of a pop whose entry distance is at or beyond t stays exact as
// well: rounding is monotone, so a wider box's entry distance is <= that of
// the f32 box, which is <= the t of any triangle inside it. The looser boxes
// can only add visits; the hits are the f32 tables' hits, up to the order in
// which equal-t triangles are met.
//
// Streamed leaf rows (STREAM): the instances for scenes whose leaf rows
// (tri, and attr for FULL) JAX's row model would not keep resident
// (ops/pack.stream_decision). The TPU kernels keep a ring of VMEM slots and
// DMA blocks of STREAM_BLK leaf groups into it ahead of use, because a TPU
// core cannot address the rows any other way. Here every thread addresses
// device memory and reads the rows with __ldg; the 50 MB L2 holds the node
// tables and, on every scene measured, most of the leaf rows, and a row
// that misses it waits out device-memory latency while the SM's other
// warps run. So a streamed instance is the resident traversal on the
// padded rows (whole blocks of STREAM_BLK rows, ops/pack.pad_stream_rows):
// the same visit order, drop of pops beyond t and leaf test, so the same
// hits to the bit, and nothing asked for ahead. Every way of asking the L2
// for rows ahead that was built here lost to asking for nothing, in turns
// on the H100, a scene with 128 MB of tri rows included (PERF.md, the
// streamed rows): a walk of the stack for the top leaf entries with a
// register ring of the blocks asked for (the TPU ring's ring_b);
// `cp.async.bulk.prefetch.L2` of 2 KB blocks, whose address must sit in a
// uniform register, so a lane-varying one compiles to a loop over the
// warp's distinct addresses; a __match_any_sync vote to send one per
// distinct block; `prefetch.global.L2` of the lines the leaf test reads,
// for the nearest leaf child each inner visit pushes; and a prefetch of
// the winner's attributes. A per-warp shared-memory ring filled by
// cp.async.bulk (the TPU ring's literal counterpart) would need
// warp-synchronous leaf steps before a slot could be reused, the kind of
// step the frame kernel measured losing on this card; it is not built.
//
// Leaf size: every traversal takes the leaf size L as a template parameter,
// instantiated at L = 8, 4, 2 and 1 (every power of two whose triangles fit
// a 128-lane row, as JAX's _pick_leaf_size accepts them); the MXU instances
// at L = 8 and 4 only, the sizes at which JAX takes its MXU leaf. A leaf
// group is one 128-float tri row at every L: L triangles of 12 floats, the
// rest of the row zero (at L = 1 only its first 12 floats hold a triangle,
// as JAX's packers leave them); slot g * L + j is triangle j of group g.
// A streamed block of RT_STREAM_BLK rows then holds 4L triangles.
//
// Shadow rays: the frame traces them from the light to the hit point, window
// (dist - EPS)^2 (the reference's reverse_shadows=True), or, in the frame
// kernel's FWD instances, from the hit point to the light, window dist^2
// (reverse_shadows=False, _frame_fused_kernel :2756-2762). The direction is
// a template parameter, so a reversed instance holds no code of the forward
// branch: a uniform kernel argument and its selects changed the registers
// of most frame instances, and the spills of some.
//
// The MXU leaf (MXU instances): Möller-Trumbore's four quantities (det,
// t_num, u_num, v_num) of a ray and a triangle are linear in the ray's
// features R = [d, o x d, o, 1, 0 x 6] (K = 16), so a leaf group's tests are
// the product of R with the group's (4L, 16) C-matrix (ops/pack.build_cmat;
// row Lq + j: quantity q of triangle j). JAX takes it on the MXU in bf16x3:
// both operands split into bf16 halves, Ch.Rh + Ch.Rl + Cl.Rh summed in f32
// (_mxu_leaf_quants_n :1393). Here it is the same product on the tensor
// cores, mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, in that order
// into one f32 accumulator. One thread still traces one ray with its own
// stack, but mma.sync is a warp instruction, so the leaf test is a step the
// warp takes together: every lane runs its inner visits (rt_visit,
// unchanged) until its next entry is a leaf group that survives the cut at
// t, or its stack is empty; then the converged warp serves the pending
// groups one at a time (the lowest pending lane's group, broadcast), and
// every lane whose group it is takes its result. That is the frame kernel's
// loop (rt_closest_mxu_on); the pass kernels walk the while-while loop with
// a postponed leaf and serve every distinct held group in one leaf step
// (rt_ww_mxu_on, below). A is R: m-tile m holds
// the rays of lanes 16m..16m+15, built once per traversal with shuffles and
// split into hi and lo in registers. B is the C-matrix transposed: n-tile q
// is C rows 8q..8q+7 of the group, 32-bit loads of the table's [hi | lo]
// rows (or of the four-group rows of pack_cmi4). At L = 8 that is quantity
// q of triangles 0..7 (four n-tiles), and in the accumulator fragment lane
// 4r + c holds the quantities of triangles 2c and 2c + 1 for rays r and
// r + 8 of the m-tile. At L = 4 a group has 16 rows, two n-tiles: n-tile p
// holds quantity 2p of triangles 0..3 (columns 0..3) and 2p + 1 (columns
// 4..7), so lane 4r + c holds quantity 2p + (c >> 1) of triangles 2(c & 1)
// and 2(c & 1) + 1; one exchange with lane c ^ 2 per value gives each lane
// all four quantities of those two triangles (lanes c and c ^ 2 then test
// the same pairs, which the quad's reduction absorbs). The L = 4 design is
// the simple one: one group per warp step, 12 mma instead of 24; serving
// two groups per step (JAX's default_nleaf doubles nleaf at L = 4) is
// later work. Each lane finishes its tests where they lie: JAX's divided hit test (_mxu_rows, IEEE 1/det) and the
// smallest t with the smallest j on ties (_mxu_winners), reduced over the
// quad and handed to the ray's lane, which merges it on a strict <
// (_mxu_merge_winner); or the division-free any-hit test (_mxu_occl_merge),
// reduced by ballots. An m-tile without a served lane is skipped. A lane
// with no ray (past n, dead, no shadow ray to trace, a finished frame ray)
// takes part in every step and takes no result. Visit order and the cut
// are those of the FP32 instances; the tensor cores sum in their own
// order, so the MXU hits are held to bounds against the plain version,
// not to the bit. What bounds it: a served group costs the warp 24 mma and
// 16 loads of 4 bytes a lane (L = 4: 12 and 8) whatever the number of lanes
// served, so the
// cost follows the distinct groups a warp's rays want per step (the
// counting instance counts these batches and the lanes served); a group's
// table rows are 2 KB, four times its tri row, and car_boxed's 17 MB table
// sits in the 50 MB L2 beside the other tables. A simple design that is
// right, not a fast one: no wgmma, TMA or shared-memory staging yet.
//
// Spheres (frame_kernel's SPH instances): as in JAX, spheres have no
// acceleration structure. After each closest traversal the ray is tested
// against every row of the (S, 16) sphere table (pack_spheres: centre, r,
// kd, ks, kr), and the nearest sphere replaces the triangle hit on a strict
// <; after each shadow traversal every sphere is tested against the shadow
// window. The table is copied to shared memory once per block; all threads
// read the same row at once (a broadcast). The solve is JAX's
// (ops/intersect.ray_sphere): guarded sqrt and denominator, true divisions.
// A scene carries few spheres, so S tests per traversal add little to the
// traversal's work; dead rays test none.
//
// Stack tiers: a visit grows a ray's stack by at most A - 1 entries, so the
// stack a tree needs follows its depth (ops/pack.stack_need). The standard
// tier (DEEP = false) keeps the stack in a private array of
// RtArity<A>::STACK entries, enough for the default bvh_max_depth = 32.
// A deeper tree takes the DEEP tier: its stack lives in a global buffer
// that the wrapper sizes to the tree (need entries per ray), entry k of
// ray i at k * n + i, so the 32 threads of a warp touch 32 neighbouring
// words. It has no depth limit, as JAX's stack, which is sized to the tree
// (pallas_trace.required_stack_depth). The wrapper picks the tier; the
// traversal is the same code, so the hits are the same.
//
// Work counters: each kernel has a counting instance (COUNT = true) that
// also sums, per launch, the node visits, the box tests of valid children,
// the leaf visits, the triangle tests of live slots (n != 0; padding slots
// can never hit) and the traversals; a STREAM instance also the block
// fills (prefetches sent: none, since nothing is asked for ahead) and the
// sync fetches (leaf visits whose row no prefetch asked for: every leaf
// visit); a pass kernel also its warp steps (RT_S_*). The
// timed instance (COUNT = false) compiles the counting out.
//
// Numerics: built with -fmad=false and without fast math, so each product
// and division rounds as in the JAX kernels and the plain PyTorch versions,
// and a triangle test gives the same bits in all three. Absent BVH4 / BVH8
// children are NaN boxes (in every format); they are skipped by the validity
// flags in cmeta, never by NaN arithmetic (fminf/fmaxf drop a NaN operand,
// jnp.minimum keeps it). The binary table has no flags: both children
// always exist.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RT_LANES 128           // floats per tri / attr row
#define RT_TRI_STRIDE 12       // [v0, e1, e2, n] per triangle
#define RT_ATTR_STRIDE 9       // [kd, ks, kr] per triangle
#define RT_LEAF 8              // triangles per leaf row of the default
                               // instances and of the microbench probes
#define RT_BLOCK 128           // threads per block
// Leaf groups per block of the TPU streamed kernels (STREAM_BLK,
// pallas_trace.py:1916): streamed tables are padded to whole blocks.
#define RT_STREAM_BLK 4        // STREAM_BLK

#define RT_FN __device__ __forceinline__
#define RT_WARP 0xffffffffu    // every lane of the warp

static constexpr float RT_EPS = 1e-3f;
static constexpr float RT_TMAX = 3.4028235e38f;
static constexpr float RT_INV_DIR_MAX = 1e30f;

// Node-box format of the cbox table (ops/pack.py):
//   RT_F32:   f32 rows, child k's [min.xyz, max.xyz] at floats [6k, 6k+6);
//   RT_PAIRS: f32-wide rows (A 4, 8) whose 32-bit lane 3k + c holds child
//             k's coordinate c as (bf16 min << 16) | bf16 max;
//   RT_BF16:  (N, 16) bf16 rows (A 2) laid out as RT_F32's binary rows.
enum RtBox { RT_F32 = 0, RT_PAIRS = 1, RT_BF16 = 2 };

// Node table layout per arity (ops/pack.py): floats per cbox row, ints per
// cmeta row, and the standard tier's per-ray stack entries. A visit grows
// the stack by at most A - 1, so the default bvh_max_depth = 32 needs
// 34 / 50 / 79 entries (pallas_trace.required_stack_depth); the wrapper
// takes the DEEP tier for a tree that needs more than STACK.
template <int A> struct RtArity;
template <> struct RtArity<2> { enum { BOX = 16, META = 8, STACK = 48 }; };
template <> struct RtArity<4> { enum { BOX = 32, META = 8, STACK = 64 }; };
template <> struct RtArity<8> { enum { BOX = 64, META = 16, STACK = 96 }; };

struct RtScene {
  const uint4* cbox;    // node rows in format F (RtBox), 16 bytes per load
  const int4* cmeta;    // (N+1) rows of META ints: encodings, validity flags
  const float4* tri;    // (G+1) rows of 32 float4
  const float* attr;    // (G+1) rows of 128 floats, or null
  // MXU: the C-matrix table as 32-bit words (two bf16 values each), rows of
  // cpitch bf16 values: 32 ([hi | lo] of one group's row) or 128 (four
  // groups, pack_cmi4); null otherwise.
  const unsigned* cmat;
  int cpitch;
};

struct RtRay {
  float3 o, d, inv, oi;  // inv: clipped 1/d; oi = o * inv (hoisted slab term)
};

// The DEEP tier's stack: a global buffer of need * n entries, entry k of
// ray i at k * n + i. The kernel passes it on offset to its ray (ent, dst
// point at entry 0 of ray i); the standard tier ignores it.
struct RtDeep {
  int* ent;       // encodings
  float* dst;     // box entry distances
  unsigned n;     // rays: the stride between entries k and k + 1
};

RT_FN RtDeep rt_deep_at(const RtDeep& g, int i) {
  RtDeep r = {g.ent + i, g.dst + i, g.n};
  return r;
}

// Entry k of one ray's DEEP stack, indexed as the standard tier's arrays.
template <class T>
struct RtSlots {
  T* p;
  unsigned n;
  RT_FN T& operator[](int k) const { return p[(size_t)k * n]; }
};

// Per-thread work counts; with ON = false every method is empty. The last
// two are kept by the STREAM instances (block fills, sync fetches) and the
// MXU ones (mma batches: one per group a warp serves, counted by one lane;
// lanes served), which never stream.
enum { RT_C_INNER, RT_C_BOX, RT_C_LEAF, RT_C_TRI, RT_C_RAYS, RT_C_FILLS,
       RT_C_SYNCS, RT_NCOUNTS };
enum { RT_C_BATCHES = RT_C_FILLS, RT_C_SERVED = RT_C_SYNCS };

__host__ __device__ constexpr int rt_ncounts(bool extra) {
  return extra ? RT_NCOUNTS : RT_C_FILLS;
}

// The pass kernels' counting instances (closest_kernel and occluded_kernel
// without MXU) also count warp steps, after their mode's counts (from
// rt_ncounts(STREAM)): the warp steps in which some lane visited an inner
// node, those in which some lane tested a leaf group, and the distinct leaf
// groups of each leaf step (__match_any_sync on g), summed. Each lane's
// visit still counts in RT_C_INNER / RT_C_LEAF, so inner visits / inner
// steps is the active lanes a step of that branch.
enum { RT_S_INNER, RT_S_LEAF, RT_S_ROWS, RT_NSTEPS };

template <bool ON, int N = RT_NCOUNTS>
struct RtCounts {
  static constexpr bool on = ON;
  unsigned v[N] = {};
  RT_FN void add(int k, unsigned n = 1u) {
    if (ON) v[k] += n;
  }
  // one triangle test; it counts only when the slot is live (n != 0)
  RT_FN void tri(float4 c) {
    if (ON) v[RT_C_TRI] += (c.y != 0.f || c.z != 0.f || c.w != 0.f) ? 1u : 0u;
  }
};

// One lane's warp-step counts as it takes one branch (B = the first step
// count, rt_ncounts(STREAM)): the step counts once, by the lowest lane in
// the branch; a leaf step also counts its distinct groups g, once each by
// its lowest lane. Only the pass kernels' counting instances keep room for
// them: elsewhere (the frame kernel) it compiles to nothing.
template <int B, bool ON, int N>
RT_FN void rt_step(RtCounts<ON, N>& c, bool leaf, int g) {
  if constexpr (ON && N >= B + RT_NSTEPS) {
    const unsigned m = __activemask();
    const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
    if ((m & lt) == 0u) c.add(B + (leaf ? RT_S_LEAF : RT_S_INNER));
    if (leaf && (__match_any_sync(m, g) & lt) == 0u) c.add(B + RT_S_ROWS);
  }
}

RT_FN float rt_clip_inv(float d) {
  return fminf(fmaxf(1.0f / d, -RT_INV_DIR_MAX), RT_INV_DIR_MAX);
}

RT_FN RtRay rt_ray(float3 o, float3 d) {
  RtRay r;
  r.o = o;
  r.d = d;
  r.inv = make_float3(rt_clip_inv(d.x), rt_clip_inv(d.y), rt_clip_inv(d.z));
  r.oi = make_float3(o.x * r.inv.x, o.y * r.inv.y, o.z * r.inv.z);
  return r;
}

RT_FN bool rt_dead(float3 d) { return d.x == 0.f && d.y == 0.f && d.z == 0.f; }

// Entry distance into one child box [lo, hi], or RT_TMAX when the box is
// missed or starts at or beyond t_cut (pallas_trace._slab_masked).
RT_FN float rt_slab(float3 lo, float3 hi, const RtRay& r, float t_cut) {
  float tx1 = lo.x * r.inv.x - r.oi.x;
  float tx2 = hi.x * r.inv.x - r.oi.x;
  float tmin = fminf(tx1, tx2);
  float tmax = fmaxf(tx1, tx2);
  float ty1 = lo.y * r.inv.y - r.oi.y;
  float ty2 = hi.y * r.inv.y - r.oi.y;
  tmin = fmaxf(tmin, fminf(ty1, ty2));
  tmax = fminf(tmax, fmaxf(ty1, ty2));
  float tz1 = lo.z * r.inv.z - r.oi.z;
  float tz2 = hi.z * r.inv.z - r.oi.z;
  tmin = fmaxf(tmin, fminf(tz1, tz2));
  tmax = fminf(tmax, fmaxf(tz1, tz2));
  bool ok = (tmax >= tmin) && (tmax > 0.f) && (tmin < t_cut);
  return ok ? tmin : RT_TMAX;
}

// Möller–Trumbore against one packed triangle (pallas_trace._mt_scalar_tri):
// a = (v0.xyz, e1.x), b = (e1.yz, e2.xy), c = (e2.z, n.xyz). Miss -> RT_TMAX.
RT_FN float rt_mt(const RtRay& r, float4 a, float4 b, float4 c, bool& neg) {
  float det = -(r.d.x * c.y + r.d.y * c.z + r.d.z * c.w);
  float invdet = 1.0f / det;
  float aox = r.o.x - a.x;
  float aoy = r.o.y - a.y;
  float aoz = r.o.z - a.z;
  float daox = aoy * r.d.z - aoz * r.d.y;
  float daoy = aoz * r.d.x - aox * r.d.z;
  float daoz = aox * r.d.y - aoy * r.d.x;
  float u = (b.z * daox + b.w * daoy + c.x * daoz) * invdet;
  float v = -(a.w * daox + b.x * daoy + b.y * daoz) * invdet;
  float t = (aox * c.y + aoy * c.z + aoz * c.w) * invdet;
  neg = det < 0.f;
  bool hit = (fabsf(det) >= RT_EPS) && (t > RT_EPS) && (u >= 0.f) &&
             (v >= 0.f) && ((u + v) <= 1.f);
  return hit ? t : RT_TMAX;
}

// Ascending sort of (distance, encoding) pairs by a comparator network that
// swaps on strict >, so equal distances keep their child order, as
// pallas_trace._sortn (:780-803) and the binary `left_near = ml <= mr`.
template <int N, int A>
RT_FN void rt_network(const int (&net)[N][2], float (&ms)[A], int (&es)[A]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    int i = net[c][0], j = net[c][1];
    if (ms[i] > ms[j]) {
      float tm = ms[i]; ms[i] = ms[j]; ms[j] = tm;
      int te = es[i]; es[i] = es[j]; es[j] = te;
    }
  }
}

template <int A>
RT_FN void rt_sort(float (&ms)[A], int (&es)[A]) {
  if constexpr (A == 2) {
    const int net[1][2] = {{0, 1}};
    rt_network(net, ms, es);
  } else if constexpr (A == 4) {
    const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
    rt_network(net, ms, es);
  } else {
    const int net[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3},
                            {4, 6}, {5, 7}, {1, 2}, {5, 6}, {0, 4}, {3, 7},
                            {1, 5}, {2, 6}, {1, 4}, {3, 6}, {2, 4}, {3, 5},
                            {3, 4}};
    rt_network(net, ms, es);
  }
}

// A bf16 value widened to f32, exactly: from the high half of a 32-bit lane,
// and from its low half.
RT_FN float rt_bf_hi(unsigned b) { return __uint_as_float(b & 0xFFFF0000u); }
RT_FN float rt_bf_lo(unsigned b) { return __uint_as_float(b << 16); }

// The boxes of children 2m and 2m+1 (f32: float4s 3m..3m+2 of the row;
// bf16: the first 12 values of the row, m = 0 only).
template <RtBox F>
RT_FN void rt_box_pair(const uint4* row, int m, float3 (&lo)[2], float3 (&hi)[2]) {
  if constexpr (F == RT_BF16) {
    uint4 a = __ldg(row);      // values 0..7: lo0.xyz, hi0.xyz, lo1.xy
    uint4 b = __ldg(row + 1);  // values 8..15: lo1.z, hi1.xyz, zeros
    lo[0] = make_float3(rt_bf_lo(a.x), rt_bf_hi(a.x), rt_bf_lo(a.y));
    hi[0] = make_float3(rt_bf_hi(a.y), rt_bf_lo(a.z), rt_bf_hi(a.z));
    lo[1] = make_float3(rt_bf_lo(a.w), rt_bf_hi(a.w), rt_bf_lo(b.x));
    hi[1] = make_float3(rt_bf_hi(b.x), rt_bf_lo(b.y), rt_bf_hi(b.y));
  } else {
    const float4* f = reinterpret_cast<const float4*>(row) + 3 * m;
    float4 p = __ldg(f);
    float4 q = __ldg(f + 1);
    float4 u = __ldg(f + 2);
    lo[0] = make_float3(p.x, p.y, p.z);
    hi[0] = make_float3(p.w, q.x, q.y);
    lo[1] = make_float3(q.z, q.w, u.x);
    hi[1] = make_float3(u.y, u.z, u.w);
  }
}

// The boxes of children 4m..4m+3 of a RT_PAIRS row: lanes 12m..12m+11,
// the 32-bit words of uint4s 3m..3m+2.
RT_FN void rt_box_quad(const uint4* row, int m, float3 (&lo)[4], float3 (&hi)[4]) {
  uint4 p = __ldg(row + 3 * m);
  uint4 q = __ldg(row + 3 * m + 1);
  uint4 u = __ldg(row + 3 * m + 2);
  const unsigned w[12] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w,
                          u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = make_float3(rt_bf_hi(w[3 * j]), rt_bf_hi(w[3 * j + 1]),
                        rt_bf_hi(w[3 * j + 2]));
    hi[j] = make_float3(rt_bf_lo(w[3 * j]), rt_bf_lo(w[3 * j + 1]),
                        rt_bf_lo(w[3 * j + 2]));
  }
}

// uint4s per cbox row: the f32 width (RT_PAIRS keeps it), or 32 bytes.
template <int A, RtBox F>
struct RtRow {
  enum { U4 = F == RT_BF16 ? 2 : RtArity<A>::BOX / 4 };
};

// Visit node row e: test its valid children against t_cut, sort them
// near-first and push far-to-near, so the nearest child pops first. Each
// entry keeps its entry distance. The row is read in groups of children
// that share 16-byte loads: pairs (RT_F32, RT_BF16) or quads (RT_PAIRS).
template <int A, RtBox F, class C, class SI, class SF>
RT_FN void rt_visit(const RtScene& s, int e, const RtRay& r, float t_cut,
                    SI& stk, SF& dst, int& sp, C& cnt) {
  static_assert(F == RT_F32 || (F == RT_PAIRS) == (A >= 4),
                "bf16 pairs at arity 4 and 8, raw bf16 at arity 2");
  const uint4* row = s.cbox + (size_t)e * RtRow<A, F>::U4;
  const int4* meta = s.cmeta + (size_t)e * (RtArity<A>::META / 4);
  int es[A];
  bool ok[A];
  if constexpr (A == 2) {
    int4 m = __ldg(meta);  // the binary row: two encodings, no flags
    es[0] = m.x;
    es[1] = m.y;
    ok[0] = ok[1] = true;
  } else {
#pragma unroll
    for (int q = 0; q < A / 4; ++q) {
      int4 enc = __ldg(meta + q);
      int4 val = __ldg(meta + A / 4 + q);
      es[4 * q] = enc.x; es[4 * q + 1] = enc.y;
      es[4 * q + 2] = enc.z; es[4 * q + 3] = enc.w;
      ok[4 * q] = val.x > 0; ok[4 * q + 1] = val.y > 0;
      ok[4 * q + 2] = val.z > 0; ok[4 * q + 3] = val.w > 0;
    }
  }
  float ms[A];
  cnt.add(RT_C_INNER);
  constexpr int G = F == RT_PAIRS ? 4 : 2;  // children per group of loads
#pragma unroll
  for (int m = 0; m < A / G; ++m) {
    float3 lo[G], hi[G];
    if constexpr (F == RT_PAIRS) {
      rt_box_quad(row, m, lo, hi);
    } else {
      rt_box_pair<F>(row, m, lo, hi);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int k = G * m + j;
      cnt.add(RT_C_BOX, ok[k] ? 1u : 0u);
      ms[k] = ok[k] ? rt_slab(lo[j], hi[j], r, t_cut) : RT_TMAX;
    }
  }
  rt_sort<A>(ms, es);
#pragma unroll
  for (int k = A - 1; k >= 0; --k) {
    if (ms[k] < RT_TMAX) {
      stk[sp] = es[k];
      dst[sp] = ms[k];
      ++sp;
    }
  }
}

// Closest hit of one ray: returns the slot g*L + j (or -1) and sets
// t and neg (det < 0 of the winner). Strict < keeps the first of equal hits.
// STREAM only counts its sync fetches; the traversal is unchanged. stk /
// dst: the ray's stack (a private array, or RtSlots of the DEEP tier).
template <int A, RtBox F, bool STREAM, int L, class C, class SI, class SF>
RT_FN int rt_closest_on(const RtScene& s, const RtRay& r, float& t, bool& neg,
                        C& cnt, SI& stk, SF& dst) {
  int sp = 1, idx = -1;
  stk[0] = 0;
  dst[0] = -RT_TMAX;
  t = RT_TMAX;
  neg = false;
  cnt.add(RT_C_RAYS);
  while (sp > 0) {
    --sp;
    int e = stk[sp];
    if (dst[sp] >= t) continue;  // box starts beyond the current hit
    if (e < 0) {
      int g = -e - 1;
      rt_step<rt_ncounts(STREAM)>(cnt, true, g);
      cnt.add(RT_C_LEAF);
      if constexpr (STREAM) cnt.add(RT_C_SYNCS);
      const float4* row = s.tri + (size_t)g * (RT_LANES / 4);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        bool nj;
        float4 c = __ldg(row + 3 * j + 2);
        cnt.tri(c);
        float tj = rt_mt(r, __ldg(row + 3 * j), __ldg(row + 3 * j + 1), c, nj);
        if (tj < t) {
          t = tj;
          idx = g * L + j;
          neg = nj;
        }
      }
    } else {
      rt_step<rt_ncounts(STREAM)>(cnt, false, 0);
      rt_visit<A, F>(s, e, r, t, stk, dst, sp, cnt);
    }
  }
  return idx;
}

// Any hit of one ray with t*t < max_dist2 (pallas_trace._run_occluded_dual);
// boxes are cut at sqrt(max_dist2), the ray stops at its first blocker.
// Nothing reads dst here, so the standard tier keeps no distance stack.
template <int A, RtBox F, bool STREAM, int L, class C, class SI, class SF>
RT_FN bool rt_occluded_on(const RtScene& s, const RtRay& r, float max_dist2,
                          C& cnt, SI& stk, SF& dst) {
  int sp = 1;
  stk[0] = 0;
  const float t_limit = sqrtf(max_dist2);
  cnt.add(RT_C_RAYS);
  while (sp > 0) {
    --sp;
    int e = stk[sp];
    if (e < 0) {
      int g = -e - 1;
      rt_step<rt_ncounts(STREAM)>(cnt, true, g);
      cnt.add(RT_C_LEAF);
      if constexpr (STREAM) cnt.add(RT_C_SYNCS);
      const float4* row = s.tri + (size_t)g * (RT_LANES / 4);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        bool nj;
        float4 c = __ldg(row + 3 * j + 2);
        cnt.tri(c);
        float tj = rt_mt(r, __ldg(row + 3 * j), __ldg(row + 3 * j + 1), c, nj);
        if (tj < RT_TMAX && tj * tj < max_dist2) return true;
      }
    } else {
      rt_step<rt_ncounts(STREAM)>(cnt, false, 0);
      rt_visit<A, F>(s, e, r, t_limit, stk, dst, sp, cnt);
    }
  }
  return false;
}

// The two traversals on the ray's stack tier: the standard tier's private
// arrays, or the DEEP tier's global slots (g already offset to the ray).
template <int A, RtBox F, bool STREAM, bool DEEP, int L, class C>
RT_FN int rt_closest(const RtScene& s, const RtRay& r, float& t, bool& neg,
                     C& cnt, const RtDeep& g) {
  if constexpr (DEEP) {
    RtSlots<int> stk = {g.ent, g.n};
    RtSlots<float> dst = {g.dst, g.n};
    return rt_closest_on<A, F, STREAM, L>(s, r, t, neg, cnt, stk, dst);
  } else {
    int stk[RtArity<A>::STACK];
    float dst[RtArity<A>::STACK];
    return rt_closest_on<A, F, STREAM, L>(s, r, t, neg, cnt, stk, dst);
  }
}

template <int A, RtBox F, bool STREAM, bool DEEP, int L, class C>
RT_FN bool rt_occluded(const RtScene& s, const RtRay& r, float max_dist2,
                       C& cnt, const RtDeep& g) {
  if constexpr (DEEP) {
    RtSlots<int> stk = {g.ent, g.n};
    RtSlots<float> dst = {g.dst, g.n};
    return rt_occluded_on<A, F, STREAM, L>(s, r, max_dist2, cnt, stk, dst);
  } else {
    int stk[RtArity<A>::STACK];
    float dst[RtArity<A>::STACK];
    return rt_occluded_on<A, F, STREAM, L>(s, r, max_dist2, cnt, stk, dst);
  }
}

// ---- the MXU leaf (MXU instances): a warp-cooperative tensor-core test ----

// This lane's A fragments of mma.m16n8k16 (16 x 16 bf16, row-major) for
// both m-tiles, hi and lo halves: a[0] rows r, a[1] rows r + 8 at columns
// 2c, 2c + 1; a[2], a[3] the same rows at columns 2c + 8, 2c + 9 (lane
// 4r + c); the row is the feature row R of the ray of lane 16m + row.
struct RtMxuA {
  unsigned h[2][4], l[2][4];
};

// B fragments of one group of L triangles: n-tile q is C rows 8q..8q+7
// of the group (column j = C row 8q + j; L = 8: quantity q of triangles
// 0..7; L = 4: quantities 2q and 2q + 1 of triangles 0..3), b[0] rows (k)
// 2c, 2c + 1 and b[1] rows 2c + 8, 2c + 9 of column r (lane 4r + c), hi
// and lo halves.
template <int L>
struct RtMxuBL {
  unsigned h[L / 2][2], l[L / 2][2];
};
using RtMxuB = RtMxuBL<RT_LEAF>;

// Two f32 values as bf16 halves (_split_bf16): hi = bf16(x), lo = bf16(x -
// hi), rounded to nearest even, packed two to a word, the lower column in
// the low half.
RT_FN void rt_split2(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
  const __nv_bfloat16 la = __float2bfloat16_rn(a - __bfloat162float(ha));
  const __nv_bfloat16 lb = __float2bfloat16_rn(b - __bfloat162float(hb));
  hi = (unsigned)__bfloat16_as_ushort(ha) | ((unsigned)__bfloat16_as_ushort(hb) << 16);
  lo = (unsigned)__bfloat16_as_ushort(la) | ((unsigned)__bfloat16_as_ushort(lb) << 16);
}

// The warp's feature rows R = [d, o x d, o, 1, 0 x 6] (_rmat_load) as A
// fragments; every lane takes part, whatever its ray.
RT_FN void rt_mxu_rays(const RtRay& r, RtMxuA& a) {
  const int lane = threadIdx.x & 31, row = lane >> 2, c = lane & 3;
  const float f[9] = {r.d.x, r.d.y, r.d.z,
                      r.o.y * r.d.z - r.o.z * r.d.y,
                      r.o.z * r.d.x - r.o.x * r.d.z,
                      r.o.x * r.d.y - r.o.y * r.d.x,
                      r.o.x, r.o.y, r.o.z};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = __shfl_sync(RT_WARP, f[k], 16 * m + row + 8 * s);
      // columns 2c, 2c + 1, and 2c + 8, 2c + 9 (o.z and the 1 at c = 0)
      const float x0 = c == 0 ? v[0] : c == 1 ? v[2] : c == 2 ? v[4] : v[6];
      const float x1 = c == 0 ? v[1] : c == 1 ? v[3] : c == 2 ? v[5] : v[7];
      const float x2 = c == 0 ? v[8] : 0.f;
      const float x3 = c == 0 ? 1.f : 0.f;
      rt_split2(x0, x1, a.h[m][s], a.l[m][s]);
      rt_split2(x2, x3, a.h[m][2 + s], a.l[m][2 + s]);
    }
  }
}

// Group g's B fragments from the C-matrix table: row 8q + r of the group
// starts at word ((g >> sh) * 4L + 8q + r) * cpitch / 2 + 16 * (g & (2^sh -
// 1)), sh = 0 for (rows, 32) and 2 for the four-group rows; its words 0..7
// are hi, 8..15 lo.
template <int L>
RT_FN void rt_mxu_load(const RtScene& s, int g, RtMxuBL<L>& b) {
  const int lane = threadIdx.x & 31, row = lane >> 2, c = lane & 3;
  const int sh = s.cpitch == 128 ? 2 : 0;
  const size_t words = (size_t)(s.cpitch / 2);
  const unsigned* base = s.cmat + ((size_t)(g >> sh) * (4 * L) + row) * words
                         + 16 * (g & ((1 << sh) - 1));
#pragma unroll
  for (int q = 0; q < L / 2; ++q) {
    const unsigned* w = base + (size_t)(8 * q) * words;
    b.h[q][0] = __ldg(w + c);
    b.h[q][1] = __ldg(w + 4 + c);
    b.l[q][0] = __ldg(w + 8 + c);
    b.l[q][1] = __ldg(w + 12 + c);
  }
}

RT_FN void rt_mma(float (&acc)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The lane's first triangle of a group: its two are j and j + 1 (lane
// 4r + c; see RtMxuBL).
template <int L>
RT_FN int rt_mxu_tri0() {
  const int c = threadIdx.x & 3;
  return L == 8 ? 2 * c : 2 * (c & 1);
}

// The four quantities of m-tile m against one group: acc[q][2s + k] is
// quantity q of triangle rt_mxu_tri0<L>() + k for ray r + 8s of the m-tile
// (lane 4r + c), summed as Ch.Rh, then Ch.Rl, then Cl.Rh. At L = 4 each
// n-tile's values are exchanged with lane c ^ 2, which holds the other
// quantity of the same triangles. The warp must be converged.
template <int L>
RT_FN void rt_mxu_quants(const RtMxuA& a, int m, const RtMxuBL<L>& b, float (&acc)[4][4]) {
  static_assert(L == 8 || L == 4, "the MXU leaf holds 4 or 8 triangles a group");
  if constexpr (L == 8) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
      rt_mma(acc[q], a.h[m], b.h[q]);
      rt_mma(acc[q], a.l[m], b.h[q]);
      rt_mma(acc[q], a.h[m], b.l[q]);
    }
  } else {
    const bool upper = (threadIdx.x & 2) != 0;  // columns 4..7: quantity 2p + 1
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      rt_mma(v, a.h[m], b.h[p]);
      rt_mma(v, a.l[m], b.h[p]);
      rt_mma(v, a.h[m], b.l[p]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float o = __shfl_xor_sync(RT_WARP, v[e], 2);
        acc[2 * p][e] = upper ? o : v[e];
        acc[2 * p + 1][e] = upper ? v[e] : o;
      }
    }
  }
}

// _mxu_rows and _mxu_winners on the fragments of m-tile m: each lane tests
// its two triangles for its two rays, the quad keeps the smallest t (the
// smallest j on ties) and its det < 0, and the lanes of the m-tile take
// their ray's winner: t, and j | nd << 3.
template <int L = RT_LEAF>
RT_FN void rt_mxu_closest_tile(const float (&acc)[4][4], int m, float& t_own,
                               int& code_own) {
  const int lane = threadIdx.x & 31, j0 = rt_mxu_tri0<L>();
  float bt[2];
  int bc[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = 2 * s + k;
      const float det = acc[0][e];
      const float invdet = 1.0f / det;
      const float tt = acc[1][e] * invdet;
      const float u = acc[2][e] * invdet;
      const float v = acc[3][e] * invdet;
      const bool hit = (fabsf(det) >= RT_EPS) && (tt > RT_EPS) && (u >= 0.f) &&
                       (v >= 0.f) && ((u + v) <= 1.f);
      const float tc = hit ? tt : RT_TMAX;
      const int code = (j0 + k) | (det < 0.f ? 8 : 0);
      if (k == 0 || tc < bt[s]) {
        bt[s] = tc;
        bc[s] = code;
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      const float ot = __shfl_xor_sync(RT_WARP, bt[s], x);
      const int oc = __shfl_xor_sync(RT_WARP, bc[s], x);
      if (ot < bt[s] || (ot == bt[s] && (oc & 7) < (bc[s] & 7))) {
        bt[s] = ot;
        bc[s] = oc;
      }
    }
  }
  // ray 16m + q sits in quad q & 7, row slot q >> 3
  const int src = 4 * (lane & 7);
  const float t0 = __shfl_sync(RT_WARP, bt[0], src);
  const float t1 = __shfl_sync(RT_WARP, bt[1], src);
  const int c0 = __shfl_sync(RT_WARP, bc[0], src);
  const int c1 = __shfl_sync(RT_WARP, bc[1], src);
  if ((lane >> 4) == m) {
    const bool hi = (lane >> 3) & 1;
    t_own = hi ? t1 : t0;
    code_own = hi ? c1 : c0;
  }
}

// _mxu_occl_merge on the fragments of m-tile m: the division-free tests of
// the lane's two triangles for its two rays (m2[s]: the shadow window of
// ray r + 8s), reduced by ballots; true for a lane of the m-tile whose ray
// one of the group's triangles blocks.
RT_FN bool rt_mxu_occluded_tile(const float (&acc)[4][4], int m, const float (&m2)[2]) {
  const int lane = threadIdx.x & 31;
  const float eps = RT_EPS, eps2 = RT_EPS * RT_EPS;
  unsigned w[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    bool blk = false;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = 2 * s + k;
      const float det = acc[0][e], tn = acc[1][e];
      const float d2 = det * det;
      const float pu = acc[2][e] * det;
      const float pv = acc[3][e] * det;
      blk = blk || ((d2 >= eps2) && (tn * det > eps * d2) && (pu >= 0.f) &&
                    (pv >= 0.f) && (pu + pv <= d2) && (tn * tn < m2[s] * d2));
    }
    w[s] = __ballot_sync(RT_WARP, blk);
  }
  const unsigned mine = ((lane >> 3) & 1) ? w[1] : w[0];
  return (lane >> 4) == m && ((mine >> (4 * (lane & 7))) & 0xFu) != 0u;
}

// One lane served with group g: a leaf visit, a lane served, and (counting
// instance) its live slots' triangle tests, as the FP32 instances count.
template <int L, class C>
RT_FN void rt_mxu_served(const RtScene& s, int g, C& cnt) {
  cnt.add(RT_C_LEAF);
  cnt.add(RT_C_SERVED);
  if constexpr (C::on) {
    const float4* row = s.tri + (size_t)g * (RT_LANES / 4);
#pragma unroll
    for (int j = 0; j < L; ++j) cnt.tri(__ldg(row + 3 * j + 2));
  }
}

// The lane that leads a batch (the lowest pending lane) and the group it
// broadcasts; the lanes whose group it is.
RT_FN int rt_mxu_next(unsigned pend, int g, unsigned& served, int& leader) {
  leader = __ffs(pend) - 1;
  const int gl = __shfl_sync(RT_WARP, g, leader);
  served = __ballot_sync(RT_WARP, g == gl);
  return gl;
}

// Closest hit of the lane's ray with the MXU leaf (every lane of the warp
// calls it; `active` false: no ray, -1 and t = RT_TMAX). The traversal,
// the drop of pops beyond t and the merge order are rt_closest_on's.
template <int A, RtBox F, int L, class C, class SI, class SF>
RT_FN int rt_closest_mxu_on(const RtScene& s, const RtRay& r, bool active,
                            float& t, bool& neg, C& cnt, SI& stk, SF& dst) {
  const int lane = threadIdx.x & 31;
  int sp = 0, idx = -1;
  t = RT_TMAX;
  neg = false;
  if (active) {
    stk[0] = 0;
    dst[0] = -RT_TMAX;
    sp = 1;
    cnt.add(RT_C_RAYS);
  }
  if (!__any_sync(RT_WARP, active)) return idx;
  RtMxuA a;
  rt_mxu_rays(r, a);
  for (;;) {
    int g = -1;  // the pending leaf group
    while (sp > 0) {
      --sp;
      const int e = stk[sp];
      if (dst[sp] >= t) continue;  // box starts beyond the current hit
      if (e < 0) {
        g = -e - 1;
        break;
      }
      rt_visit<A, F>(s, e, r, t, stk, dst, sp, cnt);
    }
    unsigned pend = __ballot_sync(RT_WARP, g >= 0);
    if (pend == 0u) break;
    __syncwarp();
    do {
      unsigned served;
      int leader;
      const int gl = rt_mxu_next(pend, g, served, leader);
      RtMxuBL<L> b;
      rt_mxu_load(s, gl, b);
      float tn = RT_TMAX;
      int code = 0;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (served & (0xFFFFu << (16 * m))) {  // the same for every lane
          float acc[4][4];
          rt_mxu_quants(a, m, b, acc);
          rt_mxu_closest_tile<L>(acc, m, tn, code);
        }
      }
      if (lane == leader) cnt.add(RT_C_BATCHES);
      if (g == gl) {
        rt_mxu_served<L>(s, gl, cnt);
        if (tn < t) {
          t = tn;
          idx = gl * L + (code & 7);
          neg = (code >> 3) != 0;
        }
      }
      pend &= ~served;
    } while (pend != 0u);
  }
  return idx;
}

// Any hit of the lane's ray with the MXU leaf (rt_occluded_on's traversal;
// every lane calls it; a blocked ray leaves its loop as an inactive lane).
template <int A, RtBox F, int L, class C, class SI, class SF>
RT_FN bool rt_occluded_mxu_on(const RtScene& s, const RtRay& r, bool active,
                              float max_dist2, C& cnt, SI& stk, SF& dst) {
  const int lane = threadIdx.x & 31, row = lane >> 2;
  int sp = 0;
  bool blocked = false;
  const float t_limit = sqrtf(max_dist2);
  if (active) {
    stk[0] = 0;
    sp = 1;
    cnt.add(RT_C_RAYS);
  }
  if (!__any_sync(RT_WARP, active)) return false;
  RtMxuA a;
  rt_mxu_rays(r, a);
  float m2[2][2];  // the windows of rays row and row + 8 of each m-tile
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    m2[m][0] = __shfl_sync(RT_WARP, max_dist2, 16 * m + row);
    m2[m][1] = __shfl_sync(RT_WARP, max_dist2, 16 * m + row + 8);
  }
  for (;;) {
    int g = -1;
    while (sp > 0) {
      --sp;
      const int e = stk[sp];
      if (e < 0) {
        g = -e - 1;
        break;
      }
      rt_visit<A, F>(s, e, r, t_limit, stk, dst, sp, cnt);
    }
    unsigned pend = __ballot_sync(RT_WARP, g >= 0);
    if (pend == 0u) break;
    __syncwarp();
    do {
      unsigned served;
      int leader;
      const int gl = rt_mxu_next(pend, g, served, leader);
      RtMxuBL<L> b;
      rt_mxu_load(s, gl, b);
      bool hit = false;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (served & (0xFFFFu << (16 * m))) {
          float acc[4][4];
          rt_mxu_quants(a, m, b, acc);
          hit = rt_mxu_occluded_tile(acc, m, m2[m]) || hit;
        }
      }
      if (lane == leader) cnt.add(RT_C_BATCHES);
      if (g == gl) {
        rt_mxu_served<L>(s, gl, cnt);
        if (hit) {
          blocked = true;
          sp = 0;
        }
      }
      pend &= ~served;
    } while (pend != 0u);
  }
  return blocked;
}

template <int A, RtBox F, bool DEEP, int L, class C>
RT_FN int rt_closest_mxu(const RtScene& s, const RtRay& r, bool active, float& t,
                         bool& neg, C& cnt, const RtDeep& g) {
  if constexpr (DEEP) {
    RtSlots<int> stk = {g.ent, g.n};
    RtSlots<float> dst = {g.dst, g.n};
    return rt_closest_mxu_on<A, F, L>(s, r, active, t, neg, cnt, stk, dst);
  } else {
    int stk[RtArity<A>::STACK];
    float dst[RtArity<A>::STACK];
    return rt_closest_mxu_on<A, F, L>(s, r, active, t, neg, cnt, stk, dst);
  }
}

template <int A, RtBox F, bool DEEP, int L, class C>
RT_FN bool rt_occluded_mxu(const RtScene& s, const RtRay& r, bool active,
                           float max_dist2, C& cnt, const RtDeep& g) {
  if constexpr (DEEP) {
    RtSlots<int> stk = {g.ent, g.n};
    RtSlots<float> dst = {g.dst, g.n};
    return rt_occluded_mxu_on<A, F, L>(s, r, active, max_dist2, cnt, stk, dst);
  } else {
    int stk[RtArity<A>::STACK];
    float dst[RtArity<A>::STACK];
    return rt_occluded_mxu_on<A, F, L>(s, r, active, max_dist2, cnt, stk, dst);
  }
}

RT_FN float rt_rsq(float v) { return 1.0f / sqrtf(fmaxf(v, 1e-30f)); }

// Raw normal and kd/ks/kr of slot idx (HitFull layout: n, kd, ks, kr).
template <int L>
RT_FN void rt_slot_attrs(const RtScene& s, int idx, float* av) {
  int g = idx / L, j = idx - g * L;
  const float* trow = reinterpret_cast<const float*>(s.tri) + (size_t)g * RT_LANES;
  const float* arow = s.attr + (size_t)g * RT_LANES;
#pragma unroll
  for (int k = 0; k < 3; ++k) av[k] = __ldg(trow + RT_TRI_STRIDE * j + 9 + k);
#pragma unroll
  for (int k = 0; k < 9; ++k) av[3 + k] = __ldg(arow + RT_ATTR_STRIDE * j + k);
}

// One ray against one sphere row (c.xyz, r, ...): the nearest t > EPS in
// units of |d|, or RT_TMAX (pallas_trace sphere_t :2604, the formula of
// ops/intersect.ray_sphere). a = d.d; c_sp = |o - c|^2 - r^2 (< 0: the
// origin is inside). A dead ray (d = 0) has a = 0 and misses.
RT_FN float rt_sphere_t(float3 o, float3 d, float a, const float* row,
                        float& c_sp) {
  const float ocx = o.x - row[0], ocy = o.y - row[1], ocz = o.z - row[2];
  const float half_b = ocx * d.x + ocy * d.y + ocz * d.z;
  c_sp = ocx * ocx + ocy * ocy + ocz * ocz - row[3] * row[3];
  const float disc = half_b * half_b - a * c_sp;
  const float sq = sqrtf(fmaxf(disc, 1e-30f));
  const float a_safe = a > 1e-20f ? a : 1.f;
  const float t0 = (-half_b - sq) / a_safe;
  const float t1 = (-half_b + sq) / a_safe;
  const float ts = t0 > RT_EPS ? t0 : t1;
  const bool hit = (disc >= 0.f) && (ts > RT_EPS) && (a > 1e-20f);
  return hit ? ts : RT_TMAX;
}

// sphere_closest_merge (:2626): each of the ns rows of sph in turn replaces
// the hit on a strict <, so the triangle keeps a tie and the first of equal
// spheres wins. Returns the winning row (or -1) and sets t and neg (the
// origin is inside it).
RT_FN int rt_sphere_closest(const float* sph, int ns, float3 o, float3 d,
                            float& t, bool& neg) {
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  int win = -1;
  for (int k = 0; k < ns; ++k) {
    float c_sp;
    const float ts = rt_sphere_t(o, d, a, sph + 16 * k, c_sp);
    if (ts < t) {
      t = ts;
      win = k;
      neg = c_sp < 0.f;
    }
  }
  return win;
}

// sphere_occluded_merge (:2655): some sphere hit lies in the shadow window.
// Every row is tested, as in JAX.
RT_FN bool rt_sphere_blocked(const float* sph, int ns, float3 o, float3 d,
                             float max_dist2) {
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  bool blocked = false;
  for (int k = 0; k < ns; ++k) {
    float c_sp;
    const float ts = rt_sphere_t(o, d, a, sph + 16 * k, c_sp);
    blocked = blocked || ((ts < RT_TMAX) && (ts * ts < max_dist2));
  }
  return blocked;
}

// A sphere winner's HitFull attributes: the raw normal p - c at
// p = o + d * t, and kd / ks / kr from the row's columns 4-12.
RT_FN void rt_sphere_attrs(const float* row, float3 o, float3 d, float t,
                           float* av) {
  av[0] = o.x + d.x * t - row[0];
  av[1] = o.y + d.y * t - row[1];
  av[2] = o.z + d.z * t - row[2];
#pragma unroll
  for (int k = 0; k < 9; ++k) av[3 + k] = row[4 + k];
}

// The whole Whitted bounce loop of one ray (pallas_trace._frame_fused_kernel).
// lamb: nl light rows (pos.xyz, kl.rgb, 0, 0) + ambient. SPH: the ns sphere
// rows of sph are merged after each traversal. Shadow rays run from the
// light to the hit point, window (dist - EPS)^2, or with FWD from the hit
// point to the light, window dist^2 (the JAX kernel's reverse_shadows
// branches, :2745-2762). MXU: every lane of the warp
// calls the MXU traversals at every bounce and for every light, with
// `active` false where it has no ray to trace (no ray at all, a finished
// ray, a back-facing light), until no lane of the warp is alive; a
// finished lane's colour does not change. Without MXU a finished ray
// leaves the loop.
template <int A, RtBox F, bool SPH, bool DEEP, bool MXU, int L, bool FWD, class C>
RT_FN float3 rt_frame_ray(const RtScene& s, const float* lamb, int nl,
                          const float* sph, int ns, float3 o, float3 d,
                          int bounces, bool active, const RtDeep& g, C& cnt) {
  const float EPS2 = (float)(1e-3 * 1e-3);
  const float ax = lamb[8 * nl], ay = lamb[8 * nl + 1], az = lamb[8 * nl + 2];
  float mx = 1.f, my = 1.f, mz = 1.f;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  bool alive = active;
  for (int b = 0; b < bounces; ++b) {
    if constexpr (MXU) {
      if (!__any_sync(RT_WARP, alive)) break;
    }
    float t = RT_TMAX;
    bool neg = false;
    int idx = -1, win = -1;
    const bool tr = alive && !rt_dead(d);
    if constexpr (MXU) {
      idx = rt_closest_mxu<A, F, DEEP, L>(s, rt_ray(o, d), tr, t, neg, cnt, g);
    } else if (tr) {
      idx = rt_closest<A, F, false, DEEP, L>(s, rt_ray(o, d), t, neg, cnt, g);
    }
    if constexpr (SPH) {
      if (tr) win = rt_sphere_closest(sph, ns, o, d, t, neg);
    }
    if (alive && !(t < RT_TMAX)) {  // miss: multiplier * ambient, the ray ends
      fx = fx + mx * ax;
      fy = fy + my * ay;
      fz = fz + mz * az;
      alive = false;
    }
    if constexpr (!MXU) {
      if (!alive) break;
    }
    float av[12];
    if (SPH && win >= 0) {
      rt_sphere_attrs(sph + 16 * win, o, d, t, av);
    } else if (alive) {
      rt_slot_attrs<L>(s, idx, av);
    } else {
#pragma unroll
      for (int k = 0; k < 12; ++k) av[k] = 0.f;
    }
    float ninv = rt_rsq(av[0] * av[0] + av[1] * av[1] + av[2] * av[2]);
    float sgn = (neg ? -1.f : 1.f) * ninv;
    float nx = av[0] * sgn, ny = av[1] * sgn, nz = av[2] * sgn;
    float px = o.x + d.x * t, py = o.y + d.y * t, pz = o.z + d.z * t;
    float cx = av[3] * ax, cy = av[4] * ay, cz = av[5] * az;
    for (int i = 0; i < nl; ++i) {
      const float* lr = lamb + 8 * i;
      float lvx = lr[0] - px, lvy = lr[1] - py, lvz = lr[2] - pz;
      float mag2 = lvx * lvx + lvy * lvy + lvz * lvz;
      float imag = rt_rsq(mag2);
      float lx = lvx * imag, ly = lvy * imag, lz = lvz * imag;
      float ndl = nx * lx + ny * ly + nz * lz;
      // half vector with the reference's unnormalised view -d
      float hx = lx - d.x, hy = ly - d.y, hz = lz - d.z;
      float ih = rt_rsq(hx * hx + hy * hy + hz * hz);
      float coeff = fmaxf(0.f, (nx * hx + ny * hy + nz * hz) * ih);
      float dterm = fmaxf(0.f, ndl);
      bool backface = (lvx * nx + lvy * ny + lvz * nz) < 0.f;
      const bool need = alive && !backface;
      bool blocked = false;
      // light -> hit point, window (dist - EPS)^2; or (FWD) hit point ->
      // light, window dist^2
      float3 so, sd;
      float sm2;
      if constexpr (FWD) {
        so = make_float3(px, py, pz);
        sd = make_float3(lx, ly, lz);
        sm2 = mag2;
      } else {
        const float q = fmaxf(mag2 * imag - RT_EPS, 0.f);
        so = make_float3(lr[0], lr[1], lr[2]);
        sd = make_float3(-lx, -ly, -lz);
        sm2 = q * q;
      }
      if constexpr (MXU) {
        blocked = rt_occluded_mxu<A, F, DEEP, L>(s, rt_ray(so, sd), need, sm2, cnt, g);
      } else if (need) {
        blocked = rt_occluded<A, F, false, DEEP, L>(s, rt_ray(so, sd), sm2, cnt, g);
      }
      if constexpr (SPH) {
        if (need) blocked = rt_sphere_blocked(sph, ns, so, sd, sm2) || blocked;
      }
      float vis = (backface ? 0.f : 1.f) * (1.f - (blocked ? 1.f : 0.f));
      float w = vis / fmaxf(mag2, 1e-30f);
      cx = cx + lr[3] * (av[3] * dterm + av[6] * coeff) * w;
      cy = cy + lr[4] * (av[4] * dterm + av[7] * coeff) * w;
      cz = cz + lr[5] * (av[5] * dterm + av[8] * coeff) * w;
    }
    if (alive) {
      fx = fx + mx * cx;
      fy = fy + my * cy;
      fz = fz + mz * cz;
      // the EPS^2 exit is checked before the kr update (raytracer.cu:103-106)
      bool live = (mx * mx + my * my + mz * mz) >= EPS2;
      mx = mx * av[9];
      my = my * av[10];
      mz = mz * av[11];
      float adn = 2.f * fabsf(d.x * nx + d.y * ny + d.z * nz);
      float rx = d.x + nx * adn, ry = d.y + ny * adn, rz = d.z + nz * adn;
      float ir = rt_rsq(rx * rx + ry * ry + rz * rz);
      o = make_float3(px, py, pz);
      d = make_float3(rx * ir, ry * ir, rz * ir);
      alive = live;
    }
    if constexpr (!MXU) {
      if (!alive) break;
    }
  }
  return make_float3(fx, fy, fz);
}

// Per-warp sums of the first N work counts, one atomic per count and warp.
template <int N, bool ON, int M>
RT_FN void rt_count(unsigned long long* counts, const RtCounts<ON, M>& c) {
  if (!ON) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    unsigned sum = __reduce_add_sync(0xffffffffu, c.v[k]);
    if ((threadIdx.x & 31) == 0) atomicAdd(counts + k, (unsigned long long)sum);
  }
}

struct RtRays {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
};

RT_FN void rt_load(const RtRays& p, int i, float3& o, float3& d) {
  o = make_float3(p.ox[i], p.oy[i], p.oz[i]);
  d = make_float3(p.dx[i], p.dy[i], p.dz[i]);
}

// A ray of the MXU instances: lane i < n loads its planes, a lane past n
// takes part in the warp's steps with no ray (d = 0, inactive).
RT_FN bool rt_load_lane(const RtRays& p, int i, int n, float3& o, float3& d) {
  o = d = make_float3(0.f, 0.f, 0.f);
  if (i >= n) return false;
  rt_load(p, i, o, d);
  return true;
}

// ---- the pass kernels: closest_kernel and occluded_kernel without MXU ----
//
// At L = 8 on the standard stack tier, one thread still traces one ray with
// its own stack, but the warp walks the rays of its lanes together in the
// "while-while" loop of Aila & Laine, "Understanding the Efficiency of Ray
// Traversal on GPUs" (HPG 2009), with a postponed leaf: each pop step,
// every lane pops one entry; a lane that pops a leaf group keeps it and goes
// on with its inner nodes (a lane that pops a second leaf puts it back and
// waits); the warp takes its leaf step once no lane is still looking for a
// leaf or RT_LEAF_SHARE lanes hold one, and every lane holding a leaf tests
// it then, so lanes that hold the same row load it in the same step. In
// rt_closest_on's loop a warp step runs its inner-node lanes and then its
// leaf lanes: on synthetic_600k 14.8 lanes of 32 took an inner step and 13.5
// a leaf step; here 13.1 and 20.4 (share 16; PERF.md §6). The warp stays
// converged: every lane runs every step, with its own predicate. Each ray
// tests the leaves rt_closest_on tests, in its order: an inner node visited
// while a leaf waits is cut at the t before that leaf's test, so it can only
// push entries that the pop then cuts (a child's box lies inside its
// parent's, in f32 or rounded outward), hence the same t, idx, det sign and
// blocked, to the bit.
//
// Where it lost in turns on the H100 the instances keep rt_closest_on's
// loop (rt_while_while): at L = 4, 2 and 1 a leaf step tests too few
// triangles to pay for the extra pop steps (1.01-1.11x at share 16), and
// on the DEEP tier's chain scene a warp's rays walk inner nodes almost
// only (1.05x). Persistent warps that fetch rays from a counter of the
// launch whenever fewer than 16 lanes still trace were built too, alone
// and with this loop, and lost everywhere (1.13-1.58x; PERF.md §6).
static constexpr int RT_LEAF_SHARE = 16;

template <int L, bool DEEP>
__host__ __device__ constexpr bool rt_while_while() {
  return L == RT_LEAF && !DEEP;
}

// Any hit reads no entry distance: its dst takes the pushes and keeps none.
struct RtSink {
  float v;
  RT_FN float& operator[](int) { return v; }
};

// The while-while loop's pop steps, until no lane is still looking for a
// leaf or `share` lanes hold one: each step every lane pops one entry (a
// closest-hit pop whose box starts at or beyond the lane's t is dropped;
// cut is its t, or an any-hit ray's window); a lane that pops a leaf group
// keeps it in lf, a lane that pops a second one puts it back and waits
// (parked), and an inner node is visited. Returns the lanes holding a leaf.
template <int A, RtBox F, bool OCC, int B, class C, class SI, class SF>
RT_FN unsigned rt_ww_pops(const RtScene& s, const RtRay& r, float cut, int share, int& sp,
                          int& lf, bool& parked, C& cnt, SI& stk, SF& dst) {
  for (;;) {
    const unsigned seek = __ballot_sync(RT_WARP, lf < 0 && sp > 0);
    const unsigned hold = __ballot_sync(RT_WARP, lf >= 0);
    if (seek == 0u || __popc(hold) >= share) return hold;
    if (sp > 0 && !parked) {
      --sp;
      const int e = stk[sp];
      if (!OCC && dst[sp] >= cut) {
        // the box starts beyond the current hit
      } else if (e < 0) {
        if (lf < 0) {
          lf = -e - 1;
        } else {  // a second leaf: back on the stack until the leaf step
          ++sp;
          parked = true;
        }
      } else {
        rt_step<B>(cnt, false, 0);
        rt_visit<A, F>(s, e, r, cut, stk, dst, sp, cnt);
      }
    }
  }
}

// The while-while traversal of the lane's ray, called by every lane of the
// warp, `active` false where the lane has no ray to trace. Closest hit
// (OCC = false): returns the slot (or -1) and sets t and neg, as
// rt_closest_on. Any hit (OCC): sets blocked, as rt_occluded_on, with
// lim = max_dist2; the ray stops at its first blocker.
template <int A, RtBox F, bool OCC, bool STREAM, int L, class C, class SI, class SF>
RT_FN int rt_ww_on(const RtScene& s, const RtRay& r, bool active, float lim, float& t,
                   bool& neg, bool& blocked, C& cnt, SI& stk, SF& dst) {
  constexpr int B = rt_ncounts(STREAM);
  int sp = 0, lf = -1, idx = -1;  // lf: the postponed leaf group, or -1
  bool parked = false;            // a second leaf is back on the stack
  const float cut = OCC ? sqrtf(lim) : 0.f;
  t = RT_TMAX;
  neg = blocked = false;
  if (active) {
    stk[0] = 0;
    dst[0] = -RT_TMAX;
    sp = 1;
    cnt.add(RT_C_RAYS);
  }
  while (__any_sync(RT_WARP, sp > 0)) {
    rt_ww_pops<A, F, OCC, B>(s, r, OCC ? cut : t, RT_LEAF_SHARE, sp, lf, parked, cnt, stk,
                             dst);
    // the leaf step: every lane holding a leaf group tests it
    if (lf >= 0) {
      rt_step<B>(cnt, true, lf);
      cnt.add(RT_C_LEAF);
      if constexpr (STREAM) cnt.add(RT_C_SYNCS);
      const float4* row = s.tri + (size_t)lf * (RT_LANES / 4);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (OCC && blocked) break;
        bool nj;
        float4 c = __ldg(row + 3 * j + 2);
        cnt.tri(c);
        float tj = rt_mt(r, __ldg(row + 3 * j), __ldg(row + 3 * j + 1), c, nj);
        if constexpr (OCC) {
          blocked = tj < RT_TMAX && tj * tj < lim;
        } else if (tj < t) {
          t = tj;
          idx = lf * L + j;
          neg = nj;
        }
      }
      if (OCC && blocked) sp = 0;  // the ray stops at its first blocker
      lf = -1;
      parked = false;
    }
  }
  return idx;
}

// The two while-while traversals on the standard tier's private stack.
template <int A, RtBox F, bool STREAM, int L, class C>
RT_FN int rt_closest_ww(const RtScene& s, const RtRay& r, bool active, float& t, bool& neg,
                        C& cnt) {
  int stk[RtArity<A>::STACK];
  float dst[RtArity<A>::STACK];
  bool blocked;
  return rt_ww_on<A, F, false, STREAM, L>(s, r, active, 0.f, t, neg, blocked, cnt, stk, dst);
}

template <int A, RtBox F, bool STREAM, int L, class C>
RT_FN bool rt_occluded_ww(const RtScene& s, const RtRay& r, bool active, float max_dist2,
                          C& cnt) {
  int stk[RtArity<A>::STACK];
  RtSink dst;
  float t;
  bool neg, blocked;
  rt_ww_on<A, F, true, STREAM, L>(s, r, active, max_dist2, t, neg, blocked, cnt, stk, dst);
  return blocked;
}

// ---- the MXU pass kernels: closest_kernel and occluded_kernel with MXU ----
//
// rt_ww_on's loop with the MXU leaf: the same pop steps (each lane pops one
// entry a step, keeps the first leaf group it pops, parks a second one back
// on the stack), and once no lane still seeks a leaf or rt_mxu_share lanes
// hold one, a leaf step that serves every held group on the tensor cores.
// __match_any_sync on the held groups finds the distinct ones at once (a
// group's leader is the lowest lane of its peers), and each holding lane
// packs its group with the m-tiles its peers occupy, so the warp serves the
// leaders in turn, lowest first, with one shuffle a group. The leaf test is
// rt_closest_mxu_on's and rt_occluded_mxu_on's: the A fragments built once
// a traversal, rt_mxu_quants' bf16x3 order, JAX's divided closest epilogue
// and its division-free any-hit epilogue, an m-tile that serves no lane
// skipped, and no lane falls back to the FP32 leaf. Each ray tests the same
// groups in the same order at the same t as in that loop (the argument above
// rt_ww_on), and an output element of an mma is the product of one ray's
// row with one triangle's column, whatever the other lanes of the batch; so
// t, idx, the det sign and blocked are that loop's, to the bit.
//
// Closest hit keeps the warp's A fragments in shared memory (RtMxuStash)
// and reads a tile's back for each batch: 16 registers fewer through the
// traversal, 64 instead of 77 at A = 4, 32 warps an SM instead of 24. Any
// hit (72 registers) keeps them in registers: there the reads cost more than
// the warps gained. What lost in turns on the H100 (PERF.md §6): loading
// the next group's fragments into a second register set before the current
// group's mma chains (91-98 registers, 20 warps an SM: 1.08-1.13x the
// parent's loop), that set capped at 80 registers (spills, 1.11x), a
// prefetch.global.L1 of its rows (no gain), and shares of 8, 12, 24 and 32
// for closest hit (16 is best); any hit gains from 12. Where the loop lost
// to rt_closest_mxu_on's (closest hit at L = 4, 1.00x; the DEEP tier's
// chain, 1.04-1.07x for closest hit, any hit within its noise), the
// instances keep that loop (rt_mxu_while_while).
template <int L, bool DEEP, bool OCC>
__host__ __device__ constexpr bool rt_mxu_while_while() {
  return !DEEP && (L == RT_LEAF || OCC);
}

// Lanes holding a leaf group at which the pop steps stop.
__host__ __device__ constexpr int rt_mxu_share(bool occ) { return occ ? 12 : 16; }

// One warp-step count k (RT_S_*) of the MXU pass kernels' counting instances,
// after their mode's counts B; nothing where the counts keep no room for it.
template <int B, bool ON, int N>
RT_FN void rt_step_add(RtCounts<ON, N>& c, int k) {
  if constexpr (ON && N >= B + RT_NSTEPS) c.add(B + k);
}

// The block's A fragments in shared memory, word-major (word k of thread i at
// w[k][i]): each lane writes and reads its own column only, so no barrier
// is needed. ON = false keeps nothing.
template <bool ON>
struct RtMxuStash {
  unsigned (*w)[RT_BLOCK];
  RT_FN void put(const RtMxuA& a) const {
    if constexpr (ON) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[4 * m + k][threadIdx.x] = a.h[m][k];
          w[8 + 4 * m + k][threadIdx.x] = a.l[m][k];
        }
      }
    }
  }
  // m-tile m's fragments back into a (volatile: read at each batch, not
  // held in registers between them)
  RT_FN void get(int m, RtMxuA& a) const {
    if constexpr (ON) {
      const volatile unsigned* c = &w[0][threadIdx.x];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a.h[m][k] = c[(4 * m + k) * RT_BLOCK];
        a.l[m][k] = c[(8 + 4 * m + k) * RT_BLOCK];
      }
    }
  }
};

// The while-while traversal with the MXU leaf (rt_ww_on's arguments and
// results), called by every lane of the warp.
template <int A, RtBox F, bool OCC, int L, class C, class SI, class SF>
RT_FN int rt_ww_mxu_on(const RtScene& s, const RtRay& r, bool active, float lim, float& t,
                       bool& neg, bool& blocked, C& cnt, SI& stk, SF& dst) {
  constexpr int B = rt_ncounts(true);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int sp = 0, lf = -1, idx = -1;  // lf: the postponed leaf group, or -1
  bool parked = false;            // a second leaf is back on the stack
  const float cut = OCC ? sqrtf(lim) : 0.f;
  t = RT_TMAX;
  neg = blocked = false;
  if (active) {
    stk[0] = 0;
    dst[0] = -RT_TMAX;
    sp = 1;
    cnt.add(RT_C_RAYS);
  }
  if (!__any_sync(RT_WARP, active)) return idx;
  __shared__ unsigned a_s[OCC ? 1 : 16][RT_BLOCK];
  const RtMxuStash<!OCC> stash = {a_s};
  RtMxuA a;
  rt_mxu_rays(r, a);
  stash.put(a);
  float m2[2][2];  // any hit: the windows of rays row and row + 8 of each m-tile
  if constexpr (OCC) {
    const int row = lane >> 2;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      m2[m][0] = __shfl_sync(RT_WARP, lim, 16 * m + row);
      m2[m][1] = __shfl_sync(RT_WARP, lim, 16 * m + row + 8);
    }
  }
  for (;;) {
    const unsigned hold = rt_ww_pops<A, F, OCC, B>(s, r, OCC ? cut : t, rt_mxu_share(OCC), sp,
                                                   lf, parked, cnt, stk, dst);
    if (hold == 0u) break;  // no lane seeks or holds a leaf: every stack is empty
    // the leaf step: one tensor-core batch per distinct held group
    const unsigned peers = __match_any_sync(RT_WARP, lf);
    const bool leads = lf >= 0 && (peers & below) == 0u;
    const int key = (lf << 2) | ((peers & 0xFFFFu) != 0u ? 1 : 0) | ((peers >> 16) != 0u ? 2 : 0);
    unsigned lead = __ballot_sync(RT_WARP, leads);
    if (lane == __ffs(hold) - 1) rt_step_add<B>(cnt, RT_S_LEAF);
    if (leads) {
      cnt.add(RT_C_BATCHES);
      rt_step_add<B>(cnt, RT_S_ROWS);
    }
    if (lf >= 0) rt_mxu_served<L>(s, lf, cnt);
    while (lead != 0u) {  // the same for every lane
      const int kc = __shfl_sync(RT_WARP, key, __ffs(lead) - 1);
      lead &= lead - 1u;
      const int gl = kc >> 2;
      RtMxuBL<L> b;
      rt_mxu_load(s, gl, b);
      float tn = RT_TMAX;
      int code = 0;
      bool hit = false;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (kc & (1 << m)) {  // some lane of m-tile m holds the group
          float acc[4][4];
          stash.get(m, a);
          rt_mxu_quants(a, m, b, acc);
          if constexpr (OCC) {
            hit = rt_mxu_occluded_tile(acc, m, m2[m]) || hit;
          } else {
            rt_mxu_closest_tile<L>(acc, m, tn, code);
          }
        }
      }
      if (lf == gl) {
        if constexpr (OCC) {
          blocked = blocked || hit;
        } else if (tn < t) {
          t = tn;
          idx = gl * L + (code & 7);
          neg = (code >> 3) != 0;
        }
      }
    }
    if (OCC && blocked) sp = 0;  // the ray stops at its first blocker
    lf = -1;
    parked = false;
  }
  return idx;
}

// The two MXU while-while traversals on the standard tier's private stack
// (rt_mxu_while_while leaves the DEEP tier on rt_closest_mxu_on's loop).
template <int A, RtBox F, int L, class C>
RT_FN int rt_closest_ww_mxu(const RtScene& s, const RtRay& r, bool active, float& t,
                            bool& neg, C& cnt) {
  int stk[RtArity<A>::STACK];
  float dst[RtArity<A>::STACK];
  bool blocked;
  return rt_ww_mxu_on<A, F, false, L>(s, r, active, 0.f, t, neg, blocked, cnt, stk, dst);
}

template <int A, RtBox F, int L, class C>
RT_FN bool rt_occluded_ww_mxu(const RtScene& s, const RtRay& r, bool active,
                              float max_dist2, C& cnt) {
  int stk[RtArity<A>::STACK];
  RtSink dst;
  float t;
  bool neg, blocked;
  rt_ww_mxu_on<A, F, true, L>(s, r, active, max_dist2, t, neg, blocked, cnt, stk, dst);
  return blocked;
}

// One thread per ray; the grid covers n rays exactly once. Threads past n
// stay for the warp-wide count reduction (and, MXU or while-while, the
// warp's steps). STREAM: the streamed leaf rows (arity 4 and 8, f32 or pair
// rows; tri and attr padded to whole blocks). DEEP: the stack tier with the
// global stack g (need * n entries). MXU: the MXU leaf on s.cmat. L:
// triangles per leaf group (8, 4, 2 or 1; MXU 8 or 4). Without MXU, the
// while-while traversal where rt_while_while takes it, else rt_closest_on's
// loop; with MXU, rt_ww_mxu_on where rt_mxu_while_while takes it, else
// rt_closest_mxu_on's loop. Their counting instances also count warp steps,
// but on rt_closest_mxu_on's loop, which counts none (its step counts read
// 0: the wrappers' buffer has room for them).
template <int A, RtBox F, bool FULL, bool COUNT, bool STREAM, bool DEEP, bool MXU = false,
          int L = RT_LEAF>
__global__ void __launch_bounds__(RT_BLOCK)
closest_kernel(RtRays rays, RtScene s, int n, RtDeep g, float* t_out,
               int* idx_out, int* nd_out, float* attr_out,
               unsigned long long* counts) {
  static_assert(!STREAM || (A >= 4 && F != RT_BF16),
                "leaf rows stream at arity 4 and 8 only, as in JAX");
  static_assert(!MXU || (A >= 4 && !STREAM && F != RT_BF16),
                "the MXU leaf is resident, at arity 4 and 8, as in JAX");
  constexpr bool WW = MXU ? rt_mxu_while_while<L, DEEP, false>() : rt_while_while<L, DEEP>();
  constexpr int NC = rt_ncounts(MXU || STREAM) + (MXU && !WW ? 0 : RT_NSTEPS);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  RtCounts<COUNT, NC> cnt;
  float t = RT_TMAX;
  bool neg = false;
  int idx = -1;
  if constexpr (MXU) {
    float3 o, d;
    const bool in = rt_load_lane(rays, i, n, o, d);
    const bool tr = in && !rt_dead(d);
    if constexpr (WW) {
      idx = rt_closest_ww_mxu<A, F, L>(s, rt_ray(o, d), tr, t, neg, cnt);
    } else {
      idx = rt_closest_mxu<A, F, DEEP, L>(s, rt_ray(o, d), tr, t, neg, cnt,
                                          rt_deep_at(g, in ? i : 0));
    }
  } else if constexpr (WW) {
    float3 o, d;
    const bool in = rt_load_lane(rays, i, n, o, d);
    idx = rt_closest_ww<A, F, STREAM, L>(s, rt_ray(o, d), in && !rt_dead(d), t, neg, cnt);
  } else if (i < n) {
    float3 o, d;
    rt_load(rays, i, o, d);
    if (!rt_dead(d))
      idx = rt_closest<A, F, STREAM, DEEP, L>(s, rt_ray(o, d), t, neg, cnt,
                                              rt_deep_at(g, i));
  }
  if (i < n) {
    t_out[i] = t;
    idx_out[i] = idx;
    nd_out[i] = neg ? 1 : 0;
    if (FULL) {
      float av[12];
      if (idx >= 0) {
        rt_slot_attrs<L>(s, idx, av);
      } else {
#pragma unroll
        for (int k = 0; k < 12; ++k) av[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 12; ++k) attr_out[(size_t)k * n + i] = av[k];
    }
  }
  rt_count<NC>(counts, cnt);
}

template <int A, RtBox F, bool COUNT, bool STREAM, bool DEEP, bool MXU = false,
          int L = RT_LEAF>
__global__ void __launch_bounds__(RT_BLOCK)
occluded_kernel(RtRays rays, const float* max_dist2, RtScene s, int n,
                RtDeep g, int* blocked_out, unsigned long long* counts) {
  static_assert(!STREAM || (A >= 4 && F != RT_BF16),
                "leaf rows stream at arity 4 and 8 only, as in JAX");
  static_assert(!MXU || (A >= 4 && !STREAM && F != RT_BF16),
                "the MXU leaf is resident, at arity 4 and 8, as in JAX");
  constexpr bool WW = MXU ? rt_mxu_while_while<L, DEEP, true>() : rt_while_while<L, DEEP>();
  constexpr int NC = rt_ncounts(MXU || STREAM) + (MXU && !WW ? 0 : RT_NSTEPS);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  RtCounts<COUNT, NC> cnt;
  bool blocked = false;
  if constexpr (MXU) {
    float3 o, d;
    const bool in = rt_load_lane(rays, i, n, o, d);
    const bool tr = in && !rt_dead(d);
    const float m2 = in ? max_dist2[i] : 0.f;
    if constexpr (WW) {
      blocked = rt_occluded_ww_mxu<A, F, L>(s, rt_ray(o, d), tr, m2, cnt);
    } else {
      blocked = rt_occluded_mxu<A, F, DEEP, L>(s, rt_ray(o, d), tr, m2, cnt,
                                               rt_deep_at(g, in ? i : 0));
    }
  } else if constexpr (WW) {
    float3 o, d;
    const bool in = rt_load_lane(rays, i, n, o, d);
    blocked = rt_occluded_ww<A, F, STREAM, L>(s, rt_ray(o, d), in && !rt_dead(d),
                                              in ? max_dist2[i] : 0.f, cnt);
  } else if (i < n) {
    float3 o, d;
    rt_load(rays, i, o, d);
    if (!rt_dead(d))
      blocked = rt_occluded<A, F, STREAM, DEEP, L>(s, rt_ray(o, d), max_dist2[i],
                                                   cnt, rt_deep_at(g, i));
  }
  if (i < n) blocked_out[i] = blocked ? 1 : 0;
  rt_count<NC>(counts, cnt);
}

// The light table, and with SPH the ns sphere rows after it, are copied to
// shared memory once per block. FWD: forward shadow rays (rt_frame_ray).
template <int A, RtBox F, bool COUNT, bool SPH, bool DEEP, bool MXU = false,
          int L = RT_LEAF, bool FWD = false>
__global__ void __launch_bounds__(RT_BLOCK)
frame_kernel(RtRays rays, RtScene s, const float* lamb, int nl,
             const float* sph, int ns, int n, int bounces, RtDeep g,
             float* col_out, unsigned long long* counts) {
  static_assert(A >= 4, "the fused frame exists for arity 4 and 8 only");
  static_assert(!MXU || F != RT_BF16, "the MXU leaf runs on f32 or pair rows");
  extern __shared__ float lamb_s[];
  float* sph_s = lamb_s + 8 * (nl + 1);
  for (int q = threadIdx.x; q < 8 * (nl + 1); q += blockDim.x) lamb_s[q] = lamb[q];
  if constexpr (SPH) {
    for (int q = threadIdx.x; q < 16 * ns; q += blockDim.x) sph_s[q] = sph[q];
  }
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  RtCounts<COUNT> cnt;
  float3 c = make_float3(0.f, 0.f, 0.f);
  if constexpr (MXU) {
    float3 o, d;
    const bool in = rt_load_lane(rays, i, n, o, d);
    c = rt_frame_ray<A, F, SPH, DEEP, true, L, FWD>(s, lamb_s, nl, sph_s, ns, o, d,
                                                    bounces, in,
                                                    rt_deep_at(g, in ? i : 0), cnt);
  } else if (i < n) {
    float3 o, d;
    rt_load(rays, i, o, d);
    c = rt_frame_ray<A, F, SPH, DEEP, false, L, FWD>(s, lamb_s, nl, sph_s, ns, o, d,
                                                     bounces, true, rt_deep_at(g, i),
                                                     cnt);
  }
  if (i < n) {
    col_out[i] = c.x;
    col_out[(size_t)n + i] = c.y;
    col_out[2 * (size_t)n + i] = c.z;
  }
  rt_count<rt_ncounts(MXU)>(counts, cnt);
}

// Host launchers, one set per arity, box format, stack tier and leaf size:
// defined in trace_launch.cuh and instantiated in trace_a{2,4,8}.cu
// (RT_F32), trace_a{4,8}p.cu (RT_PAIRS) and trace_a2h.cu (RT_BF16), the
// streamed ones (STREAM = true) in trace_a{4,8}s.cu and trace_a{4,8}ps.cu,
// the MXU ones (MXU = true) in trace_a{4,8}m.cu and trace_a{4,8}pm.cu, the
// DEEP tier of each in the unit of the same name with a `d` suffix
// (trace_a4d.cu, ...), each unit at L = 8 and again at L = 4, 2 and 1 (the
// MXU units at L = 8 and 4 only; RT_UNIT_LEAF), all of which nvcc compiles
// in parallel. Each launches one kernel on stream st
// (the counting instance when counts is non-null), does not synchronise,
// and returns cudaGetLastError() after the launch. The frame launcher takes
// the SPH instance when ns > 0, and the FWD instance when fwd != 0.
template <int A, RtBox F, bool STREAM, bool DEEP, bool MXU = false, int L = RT_LEAF>
struct RtLaunch {
  static int closest(const RtRays& rays, const RtScene& s, int n,
                     const RtDeep& g, float* t, int* idx, int* nd,
                     float* attr_out, unsigned long long* counts,
                     cudaStream_t st);
  static int occluded(const RtRays& rays, const float* max_dist2,
                      const RtScene& s, int n, const RtDeep& g, int* blocked,
                      unsigned long long* counts, cudaStream_t st);
};

template <int A, RtBox F, bool DEEP, bool MXU = false, int L = RT_LEAF>
struct RtFrameLaunch {
  static int frame(const RtRays& rays, const RtScene& s, const float* lamb,
                   int num_lights, const float* sph, int ns, int n,
                   int bounces, int fwd, const RtDeep& g, float* col,
                   unsigned long long* counts, cudaStream_t st);
  // the timed instance's occupancy, registers, stack frame and shared
  // memory (rt_detail::frame_info)
  static int info(int num_lights, int ns, int fwd, int* out);
};

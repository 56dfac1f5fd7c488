// Row 15m of the microbench probes (microbench/mxu_inner.py): does a
// tensor-core (mma.sync m16n8k16) inner-node test beat the FP32 slab test,
// at the same 32 children an iteration?
//
// It replaces `_run` of scripts/microbench_mxu_inner.py (:108, pallas_call
// :141) with the bodies of its `main` (:275). The slab plane distances are
// linear in the ray features S = [inv, oi]: lo_x inv_x - oi_x is the row
// [lo_x at feature 0, -1 at feature 3] against S. So a visit's distances are
// one product W S, W's rows built at pack time (`w_table` :68: row n (6A) +
// q A + k of node n holds quantity q (tx1, tx2, ty1, ty2, tz1, tz2) of child
// k), and the min/max chain runs on the product (`_node_minmax` :230). Each
// iteration visits NPOP nodes (e + 37 i) % 512 (32 children), then e = |e'|
// % 512:
//   MBM_VPU (I, `body_vpu4(True)` :183)   8 BVH4 nodes of qbox: per ray
//        rt_slab (t_cut T_MAX), each child's packet minimum, per node the
//        4 minima and meta4's encodings sorted (rt_sort<4>) and pushed
//        (`_push` :175: four unconditional stores, the pointer bumped where
//        the child was hit; one stack from 0 an iteration); e' = e + 1 + sp.
//   MBM_VPU_VEC (M, `body_vpu4(False)`)   I's slabs, one minimum over all;
//        e' = e + 1 + (s < 0), acc += s.
//   MBM_MXU (J, `body_mxu(8, 4, True)` :248; K, `body_mxu(4, 8, True)`)
//        NPOP = 4 BVH8 nodes of w8 (J) or 8 BVH4 nodes of w4 (K): three
//        m16n8k16 bf16 products with f32 accumulation per fragment,
//        Ch.Sh, Ch.Sl, Cl.Sh, each in its own accumulator, added in the
//        script's order (`_mxu_quants` :214-227); `_node_minmax` per child
//        and ray (no t_cut: ok = tmax >= tmin & tmax > 0), the warp minimum
//        per child, rt_sort<A> and the pushes (meta8 / meta4).
//   MBM_MXU_VEC (L, `body_mxu(8, 4, False)`)   J's products and minima; s
//        the sum of the node minima; e' = e + 1 + (s < 0), acc += s.
// The VPU bodies run at P = 1 (one ray a thread, its own e chain: the
// port's visit) and P = 32 (the warp as the packet, minima by warp
// reductions over order-preserving keys). mma.sync is a warp instruction:
// the MXU bodies run at P = 32 only.
//
// The fragments (the MXU leaf's code of trace.cuh, rt_mma and rt_mxu_load):
// the RAYS are the A operand (16 x 16, row-major): m-tile m holds the rays
// of lanes 16m .. 16m + 15, row r the ray of lane 16m + r, columns the 16
// features [inv x, y, z, oi x, y, z, 0 x 10], split into bf16 halves Sh, Sl
// once before the loop (`_split_bf16` :122-128; rt_split2). W is the B
// operand: n-tile t of a node is its W rows 8t .. 8t + 7, read from the
// [h | l] table by rt_mxu_load<3A / 2> (6A rows a node = 4L with L = 3A / 2).
// So lane 4r + c holds, per n-tile, W rows 8t + 2c and 8t + 2c + 1 for the
// rays of lanes 16m + r and 16m + r + 8. At A = 8, n-tile t is quantity t of
// children 0..7: the lane holds all six quantities of children 2c, 2c + 1.
// At A = 4, n-tile t is quantities 2t (columns 0..3) and 2t + 1 (4..7) of
// children 0..3; one __shfl_xor_sync(..., 2) per value gives lanes c and
// c ^ 2 both (children 2 (c & 1), 2 (c & 1) + 1), as the MXU leaf at L = 4.
// Each lane takes its children's minima over its 4 rays, a butterfly over
// lanes 4r + c (xor 4, 8, 16) the warp's, and child k's minimum is read
// from lane k / 2. An iteration issues 192 W rows x 2 m-tiles / 8 x 3 = 144
// mma at J and K alike.
//
// Traps, and what the design does about them:
// 1. Dead stores: the script's stack (SMEM, 512 ints) is never read. Each
//    thread writes `top`, the entry below the final pointer (stk[sp - 1] of
//    the last iteration, 0 if nothing was pushed), read at a run-time index,
//    so every push stays live; the stack is a local array of the script's
//    512 ints, indexed as the script indexes it. The K loop is not unrolled:
//    microbench/sass.py counts the STL of one iteration in the built object.
// 2. Rounding: the unit builds with -fmad=false; I and M round as the plain
//    version's torch ops (the CPU tests walk XLA's FMA contraction of the
//    script). Each product of the MXU bodies has two nonzero terms per
//    fragment element (the lo row's lo x inv and -1 x oi): the plain version
//    sums them in f32 exactly once; the tensor cores may round their
//    internal sum otherwise. So J and K's e and top are held exactly, and
//    L's acc, as the MXU leaf's (row 15i's Lf), to K 1e-6 + 1e-5 |acc|
//    (chip_smoke.py).
//
// What bounds it: per iteration a ray's 32 slab tests (25 FP32 operations
// each) or 32 min/max chains (14 each: the two adds of the products and
// the chain) beside 144 mma a warp, the sorts (25 per 4-sort, 95 per
// 8-sort) and 32 pushes; the tables (512 nodes) live in L1 / L2, and the
// chain through e makes each iteration's loads depend on the last one's.

#include "trace.cuh"

#define MBM_NODES 512     // N_NODES of the script
#define MBM_STACK 512     // the script's SMEM stack (ints)

enum MbMxuBody { MBM_VPU = 0, MBM_VPU_VEC = 1, MBM_MXU = 2, MBM_MXU_VEC = 3 };

struct MbMxuArgs {
  RtRays rays;
  int n_src;              // rays in the planes, a multiple of 32
  const float* qbox;      // (512, 32) f32 BVH4 rows: child k's [min, max] at [6k, 6k + 6)
  const int* meta4;       // (512, 8) i32: 4 encodings, 4 validity flags
  const unsigned* w8;     // (512 * 48, 32) bf16 rows [h | l] as 32-bit words
  const int* meta8;       // (512, 16) i32: 8 encodings, 8 flags
  const unsigned* w4;     // (512 * 24, 32) bf16 rows [h | l]
  int iters;              // K
  int* e_out;
  float* acc_out;
  int* top_out;
};

RT_FN int mbm_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
RT_FN float mbm_unkey(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

template <int P>
RT_FN float mbm_pmin(float x) {
  if constexpr (P == 1) {
    return x;
  } else {
    return mbm_unkey(__reduce_min_sync(RT_WARP, mbm_key(x)));
  }
}

RT_FN int mbm_row(int e, int i) { return (e + 37 * i) % MBM_NODES; }

// Far-to-near pushes of one node (`_push`): store at sp, bump when hit.
template <int A>
RT_FN void mbm_push(int (&stk)[MBM_STACK], int& sp, const float (&ms)[A], const int (&es)[A]) {
#pragma unroll
  for (int k = A - 1; k >= 0; --k) {
    stk[sp] = es[k];
    sp += ms[k] < RT_TMAX ? 1 : 0;
  }
}

// The warp's feature rows S as A fragments (hi and lo halves, both
// m-tiles): lane 4r + c, row r + 8s of m-tile m is the ray of lane 16m + r
// + 8s; columns 2c, 2c + 1 are features (inv x, y), (inv z, oi x), (oi y,
// oi z), (0, 0) for c = 0..3; columns 8..15 are zero.
RT_FN void mbm_rays(const RtRay& r, RtMxuA& a) {
  const int lane = threadIdx.x & 31, row = lane >> 2, c = lane & 3;
  const float f[6] = {r.inv.x, r.inv.y, r.inv.z, r.oi.x, r.oi.y, r.oi.z};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float v[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] = __shfl_sync(RT_WARP, f[k], 16 * m + row + 8 * s);
      const float x0 = c == 0 ? v[0] : c == 1 ? v[2] : c == 2 ? v[4] : 0.f;
      const float x1 = c == 0 ? v[1] : c == 1 ? v[3] : c == 2 ? v[5] : 0.f;
      rt_split2(x0, x1, a.h[m][s], a.l[m][s]);
      a.h[m][2 + s] = a.l[m][2 + s] = 0u;
    }
  }
}

// One product fragment: (Ch.Sh + Ch.Sl) + Cl.Sh, each in its own accumulator.
RT_FN void mbm_product(const RtMxuA& a, int m, const unsigned (&bh)[2], const unsigned (&bl)[2],
                       float (&out)[4]) {
  float hh[4] = {0.f, 0.f, 0.f, 0.f}, hl[4] = {0.f, 0.f, 0.f, 0.f}, lh[4] = {0.f, 0.f, 0.f, 0.f};
  rt_mma(hh, a.h[m], bh);
  rt_mma(hl, a.l[m], bh);
  rt_mma(lh, a.h[m], bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = __fadd_rn(__fadd_rn(hh[e], hl[e]), lh[e]);
}

// The six quantities of m-tile m for this lane's two children: q[Q][2s + kk]
// is quantity Q of child 2c + kk (A = 8) or 2 (c & 1) + kk (A = 4) for the
// ray of lane 16m + r + 8s.
template <int A>
RT_FN void mbm_quants(const RtMxuA& a, int m, const RtMxuBL<3 * A / 2>& b, float (&q)[6][4]) {
  static_assert(A == 8 || A == 4, "BVH8 or BVH4 W rows");
  if constexpr (A == 8) {
#pragma unroll
    for (int t = 0; t < 6; ++t) mbm_product(a, m, b.h[t], b.l[t], q[t]);
  } else {
    const bool upper = (threadIdx.x & 2) != 0;   // columns 4..7: quantity 2t + 1
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      float v[4];
      mbm_product(a, m, b.h[t], b.l[t], v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float o = __shfl_xor_sync(RT_WARP, v[e], 2);
        q[2 * t][e] = upper ? o : v[e];
        q[2 * t + 1][e] = upper ? v[e] : o;
      }
    }
  }
}

// `_node_minmax` of one child and ray: tmin where the box is hit, else T_MAX.
RT_FN float mbm_minmax(const float (&q)[6][4], int e) {
  float tmin = fminf(q[0][e], q[1][e]);
  float tmax = fmaxf(q[0][e], q[1][e]);
  tmin = fmaxf(tmin, fminf(q[2][e], q[3][e]));
  tmax = fminf(tmax, fmaxf(q[2][e], q[3][e]));
  tmin = fmaxf(tmin, fminf(q[4][e], q[5][e]));
  tmax = fminf(tmax, fmaxf(q[4][e], q[5][e]));
  return (tmax >= tmin && tmax > 0.f) ? tmin : RT_TMAX;
}

template <int BODY, int A, int NPOP, int P>
__global__ void __launch_bounds__(RT_BLOCK) mb_mxu_inner_kernel(MbMxuArgs p) {
  static_assert(P == 1 || P == 32, "packet of one ray or one warp");
  constexpr bool MXU = BODY == MBM_MXU || BODY == MBM_MXU_VEC;
  static_assert(!MXU || P == 32, "mma.sync is a warp instruction");
  static_assert(A * NPOP == 32, "32 children an iteration");
  static_assert(MXU || A == 4, "the VPU bodies visit BVH4 rows");
  const int i = blockIdx.x * RT_BLOCK + threadIdx.x;
  float3 o, d;
  rt_load(p.rays, i % p.n_src, o, d);
  const RtRay r = rt_ray(o, d);
  int e = 0;
  float acc = 0.f;
  int stk[MBM_STACK];
  int sp = 0;
  RtMxuA sa;
  if constexpr (MXU) mbm_rays(r, sa);
#pragma unroll 1
  for (int it = 0; it < p.iters; ++it) {
    int en;
    sp = 0;
    if constexpr (!MXU) {
      float v[32];
#pragma unroll
      for (int n = 0; n < NPOP; ++n) {
        const uint4* row = reinterpret_cast<const uint4*>(p.qbox) + (size_t)mbm_row(e, n) * 8;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float3 lo[2], hi[2];
          rt_box_pair<RT_F32>(row, m, lo, hi);
          v[4 * n + 2 * m] = rt_slab(lo[0], hi[0], r, RT_TMAX);
          v[4 * n + 2 * m + 1] = rt_slab(lo[1], hi[1], r, RT_TMAX);
        }
      }
      if constexpr (BODY == MBM_VPU_VEC) {
        float m = v[0];
#pragma unroll
        for (int c = 1; c < 32; ++c) m = fminf(m, v[c]);
        const float s = mbm_pmin<P>(m);
        en = e + 1 + (s < 0.f ? 1 : 0);
        acc = __fadd_rn(acc, s);
      } else {
#pragma unroll
        for (int n = 0; n < NPOP; ++n) {
          const int4 enc = __ldg(reinterpret_cast<const int4*>(p.meta4) + 2 * mbm_row(e, n));
          float ms[4];
          int es[4] = {enc.x, enc.y, enc.z, enc.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) ms[k] = mbm_pmin<P>(v[4 * n + k]);
          rt_sort<4>(ms, es);
          mbm_push<4>(stk, sp, ms, es);
        }
        en = e + 1 + sp;
      }
    } else {
      const RtScene sc{nullptr, nullptr, nullptr, nullptr, A == 8 ? p.w8 : p.w4, 32};
      float s = 0.f;
#pragma unroll
      for (int n = 0; n < NPOP; ++n) {
        const int node = mbm_row(e, n);
        __syncwarp();
        RtMxuBL<3 * A / 2> b;
        rt_mxu_load(sc, node, b);
        float vmin[2] = {RT_TMAX, RT_TMAX};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float q[6][4];
          mbm_quants<A>(sa, m, b, q);
#pragma unroll
          for (int el = 0; el < 4; ++el) vmin[el & 1] = fminf(vmin[el & 1], mbm_minmax(q, el));
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          vmin[0] = fminf(vmin[0], __shfl_xor_sync(RT_WARP, vmin[0], off));
          vmin[1] = fminf(vmin[1], __shfl_xor_sync(RT_WARP, vmin[1], off));
        }
        if constexpr (BODY == MBM_MXU_VEC) {
          float nm = fminf(vmin[0], vmin[1]);
          nm = fminf(nm, __shfl_xor_sync(RT_WARP, nm, 1));
          nm = fminf(nm, __shfl_xor_sync(RT_WARP, nm, 2));
          s = __fadd_rn(s, nm);
        } else {
          const int* meta = A == 8 ? p.meta8 + node * 16 : p.meta4 + node * 8;
          float ms[A];
          int es[A];
#pragma unroll
          for (int k = 0; k < A; ++k) {
            ms[k] = __shfl_sync(RT_WARP, vmin[k & 1], k >> 1);
            es[k] = __ldg(meta + k);
          }
          rt_sort<A>(ms, es);
          mbm_push<A>(stk, sp, ms, es);
        }
      }
      if constexpr (BODY == MBM_MXU_VEC) {
        en = e + 1 + (s < 0.f ? 1 : 0);
        acc = __fadd_rn(acc, s);
      } else {
        en = e + 1 + sp;
      }
    }
    e = abs(en) % MBM_NODES;
  }
  int top = 0;
  if constexpr (BODY == MBM_VPU || BODY == MBM_MXU) top = sp > 0 ? stk[sp - 1] : 0;
  p.e_out[i] = e;
  p.acc_out[i] = acc;
  p.top_out[i] = top;
}

namespace {

constexpr int mbm_inst(int body, int arity, int npop, int packet) {
  return ((body * 16 + arity) * 16 + npop) * 64 + packet;
}

template <int BODY, int A, int NPOP, int P>
int mbm_launch(const MbMxuArgs& p, int n, cudaStream_t st) {
  mb_mxu_inner_kernel<BODY, A, NPOP, P><<<n / RT_BLOCK, RT_BLOCK, 0, st>>>(p);
  return (int)cudaGetLastError();
}

#define MBM_CASE(BODY, A, NPOP, P) \
  case mbm_inst(BODY, A, NPOP, P): return mbm_launch<BODY, A, NPOP, P>(p, n, st);

int mbm_dispatch(const MbMxuArgs& p, int key, int n, cudaStream_t st) {
  switch (key) {
    MBM_CASE(MBM_VPU, 4, 8, 1)
    MBM_CASE(MBM_VPU, 4, 8, 32)
    MBM_CASE(MBM_VPU_VEC, 4, 8, 1)
    MBM_CASE(MBM_VPU_VEC, 4, 8, 32)
    MBM_CASE(MBM_MXU, 8, 4, 32)
    MBM_CASE(MBM_MXU, 4, 8, 32)
    MBM_CASE(MBM_MXU_VEC, 8, 4, 32)
  }
  return (int)cudaErrorInvalidValue;
}

#undef MBM_CASE

}  // namespace

extern "C" {

// One launch of a row-15m instance on `stream` (no synchronisation, no
// allocation): n threads (a multiple of RT_BLOCK), thread i on ray i % n_src.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// an instance not built (body, arity, npop, packet).
int mb_mxu_inner(const float* ox, const float* oy, const float* oz, const float* dx,
                 const float* dy, const float* dz, int n_src, const float* qbox,
                 const int* meta4, const void* w8, const int* meta8, const void* w4, int body,
                 int arity, int npop, int packet, int iters, int n, int* e_out, float* acc_out,
                 int* top_out, void* stream) {
  const MbMxuArgs p{RtRays{ox, oy, oz, dx, dy, dz}, n_src, qbox, meta4,
                    static_cast<const unsigned*>(w8), meta8, static_cast<const unsigned*>(w4),
                    iters, e_out, acc_out, top_out};
  return mbm_dispatch(p, mbm_inst(body, arity, npop, packet), n,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// Kernel D of the microbench probes (microbench/overlap.py): does an FP32
// inner visit overlap a tensor-core leaf step on the card?
//
// It replaces `_run` (scripts/microbench_overlap.py:160, pallas_call :168)
// with the loop bodies of `main` :193 (`_inner8` :101, and the MXU leaf
// steps `_mxu_leaf_closest_n` / `_mxu_leaf_occluded_n` of pallas_trace.py).
// Each iteration of a warp runs one body:
//   INNER      8 inner visits: node rows (e0 + 37 i) % N, i < 8, each through
//              rt_visit<4, RT_F32> (rt_slab on its 4 children, rt_sort, the
//              pushes) with t_cut = RT_TMAX, onto a stack whose pushes start
//              at entry 8, as _inner8 pushes onto its SMEM stack;
//   LEAF = 1   the MXU closest-hit step of NG groups (e + 11 q) % G, q < NG,
//              each served through rt_mxu_next, rt_mxu_load, rt_mxu_quants
//              and rt_mxu_closest_tile and merged on a strict <;
//   LEAF = 2   the MXU any-hit step of the same groups (rt_mxu_occluded_tile
//              against the window t * t);
//   both       the leaf step on e, then the inner visits on e + 1.
// The loop index e is chained through each iteration's results as the
// script chains it, with lane 0 in the place of the TPU packet's ray (0, 0),
// so e stays the same for every lane of a warp (one group per batch, every
// lane served, the packet's case):
//   INNER:        e' = e + sp + stk[0]
//   LEAF = 1:     e' = e + idx + 1          LEAF = 2:     e' = e + nd + 1
//   both, LEAF 1: e' = e + sp + idx + stk[0]
//   both, LEAF 2: e' = e + sp + nd + stk[0]
// then e = |e'| % N. The script never writes stack[0]; the Pallas
// interpreter gives unwritten int scratch the value INT32_MIN, so stk[0]
// holds that here and the chain is the script's on the CPU. One thread
// traces ray i % n_src; each thread writes its e, t, idx, nd, the count sp
// of its stack after the last inner visits, and the stack's top entry and
// its distance (the entry the traversal would pop next), which keeps every
// push live: the script's pushes go to SMEM scratch, which Mosaic keeps.
//
// What bounds it: the inner visits are FP32 slab tests (25 operations a
// box, 32 boxes) and dependent node loads; a leaf step is 24 mma.sync per
// group and the epilogue. If the SM overlaps the two, a "both" iteration
// costs the larger of the two, not their sum.

#include <climits>

#include "trace.cuh"

#define MB_STACK 40        // 8 unwritten entries + 8 visits x 4 pushes
#define MB_UNWRITTEN INT_MIN

struct MbOverlapArgs {
  RtRays rays;
  int n_src;
  RtScene s;       // cbox (N, 32) f32, cmeta (N, 8), cmat (G * 32, 32) bf16
  int n_nodes;     // N
  int n_groups;    // G
  int iters;
  int n;
  int *e_out, *idx_out, *nd_out, *sp_out, *top_out;
  float *t_out, *topd_out;
};

template <bool INNER, int LEAF, int NG>
__global__ void __launch_bounds__(RT_BLOCK) mb_overlap_kernel(MbOverlapArgs p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, row = lane >> 2;
  float3 o, d;
  rt_load(p.rays, i % p.n_src, o, d);
  const RtRay r = rt_ray(o, d);
  RtMxuA a;
  if (LEAF) rt_mxu_rays(r, a);
  int stk[MB_STACK];
  float dst[MB_STACK];
  stk[0] = MB_UNWRITTEN;
  RtCounts<false> cnt;
  int e = 0, idx = -1, nd = 0, sp = 0;
  float t = RT_TMAX;
  for (int it = 0; it < p.iters; ++it) {
    if (LEAF == 1) {
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const int g = (e + 11 * q) % p.n_groups;
        unsigned pend = __ballot_sync(RT_WARP, true);
        __syncwarp();
        do {
          unsigned served;
          int leader;
          const int gl = rt_mxu_next(pend, g, served, leader);
          RtMxuB b;
          rt_mxu_load(p.s, gl, b);
          float tn = RT_TMAX;
          int code = 0;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (served & (0xFFFFu << (16 * m))) {
              float acc[4][4];
              rt_mxu_quants(a, m, b, acc);
              rt_mxu_closest_tile(acc, m, tn, code);
            }
          }
          if (g == gl && tn < t) {
            t = tn;
            idx = gl * RT_LEAF + (code & 7);
            nd = code >> 3;
          }
          pend &= ~served;
        } while (pend != 0u);
      }
    } else if (LEAF == 2) {
      const float m2l = t * t;
      float m2[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        m2[m][0] = __shfl_sync(RT_WARP, m2l, 16 * m + row);
        m2[m][1] = __shfl_sync(RT_WARP, m2l, 16 * m + row + 8);
      }
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const int g = (e + 11 * q) % p.n_groups;
        unsigned pend = __ballot_sync(RT_WARP, true);
        __syncwarp();
        do {
          unsigned served;
          int leader;
          const int gl = rt_mxu_next(pend, g, served, leader);
          RtMxuB b;
          rt_mxu_load(p.s, gl, b);
          bool hit = false;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (served & (0xFFFFu << (16 * m))) {
              float acc[4][4];
              rt_mxu_quants(a, m, b, acc);
              hit = rt_mxu_occluded_tile(acc, m, m2[m]) || hit;
            }
          }
          if (g == gl && hit) nd = 1;
          pend &= ~served;
        } while (pend != 0u);
      }
    }
    if (INNER) {
      const int e0 = LEAF ? e + 1 : e;
      sp = 8;
      for (int k = 0; k < 8; ++k)
        rt_visit<4, RT_F32>(p.s, (e0 + 37 * k) % p.n_nodes, r, RT_TMAX, stk, dst, sp, cnt);
    }
    int en;
    if (INNER && LEAF == 0) {
      en = e + sp + stk[0];
    } else if (!INNER) {
      en = e + (LEAF == 1 ? idx : nd) + 1;
    } else {
      en = e + sp + (LEAF == 1 ? idx : nd) + stk[0];
    }
    en = __shfl_sync(RT_WARP, en, 0);
    e = abs(en) % p.n_nodes;
  }
  if (i < p.n) {
    p.e_out[i] = e;
    p.t_out[i] = t;
    p.idx_out[i] = idx;
    p.nd_out[i] = nd;
    p.sp_out[i] = sp;
    p.top_out[i] = sp > 8 ? stk[sp - 1] : 0;
    p.topd_out[i] = sp > 8 ? dst[sp - 1] : 0.f;
  }
}

namespace {

template <bool INNER, int LEAF, int NG>
int mb_overlap_launch(const MbOverlapArgs& p, cudaStream_t st) {
  mb_overlap_kernel<INNER, LEAF, NG><<<p.n / RT_BLOCK, RT_BLOCK, 0, st>>>(p);
  return (int)cudaGetLastError();
}

constexpr int mb_body(int inner, int leaf, int ng) { return 64 * inner + 16 * leaf + ng; }

}  // namespace

extern "C" {

// Launches kernel D on `stream` (no synchronisation, no allocation): n
// threads (a multiple of RT_BLOCK) over the n_src rays (a multiple of 32).
// The bodies with instances: inner alone (inner 1, leaf 0, ng 0), each leaf
// step of 4 groups alone (inner 0, leaf 1 or 2, ng 4), and both with 4 and
// 6 groups (leaf 1 or 2) and 8 groups (leaf 2), as the script's `main` runs
// them. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a body without an instance.
int mb_overlap(const float* ox, const float* oy, const float* oz, const float* dx,
               const float* dy, const float* dz, int n_src, const void* cbox,
               const int* cmeta, const void* cmat, int n_nodes, int n_groups,
               int inner, int leaf, int ng, int iters, int n, int* e_out,
               float* t_out, int* idx_out, int* nd_out, int* sp_out, int* top_out,
               float* topd_out, void* stream) {
  MbOverlapArgs p;
  p.rays = RtRays{ox, oy, oz, dx, dy, dz};
  p.n_src = n_src;
  p.s = RtScene{static_cast<const uint4*>(cbox), reinterpret_cast<const int4*>(cmeta),
                nullptr, nullptr, static_cast<const unsigned*>(cmat), 32};
  p.n_nodes = n_nodes;
  p.n_groups = n_groups;
  p.iters = iters;
  p.n = n;
  p.e_out = e_out;
  p.t_out = t_out;
  p.idx_out = idx_out;
  p.nd_out = nd_out;
  p.sp_out = sp_out;
  p.top_out = top_out;
  p.topd_out = topd_out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mb_body(inner, leaf, ng)) {
    case mb_body(1, 0, 0): return mb_overlap_launch<true, 0, 0>(p, st);
    case mb_body(0, 1, 4): return mb_overlap_launch<false, 1, 4>(p, st);
    case mb_body(0, 2, 4): return mb_overlap_launch<false, 2, 4>(p, st);
    case mb_body(1, 1, 4): return mb_overlap_launch<true, 1, 4>(p, st);
    case mb_body(1, 2, 4): return mb_overlap_launch<true, 2, 4>(p, st);
    case mb_body(1, 1, 6): return mb_overlap_launch<true, 1, 6>(p, st);
    case mb_body(1, 2, 6): return mb_overlap_launch<true, 2, 6>(p, st);
    case mb_body(1, 2, 8): return mb_overlap_launch<true, 2, 8>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

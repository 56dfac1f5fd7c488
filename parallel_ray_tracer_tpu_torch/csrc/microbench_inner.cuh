// Rows 15i and 15j of the microbench probes (microbench/inner.py,
// microbench/glue.py): what one inner visit costs on the card, part by part.
//
// It replaces `_run` of scripts/microbench_inner.py (:98, pallas_call :108)
// and of scripts/microbench_glue.py (:132, pallas_call :135), with their loop
// kernels `_loop_kernel` (inner :70, glue :103) and every body of both
// scripts. On the TPU one 8 x 128 packet of 1,024 rays runs K iterations of
// one body: node row e (or rows e + 3i) is visited, each child's entry
// distance is reduced to one packet minimum (the "block-min extract"), the
// body's scalar work (meta reads, sort, pushes) runs on those minima, and
// the next e comes from the visit, e = |e'| % 4096. The script's cost per
// iteration is the marginal (K_hi - K_lo) cost.
//
// The port has no packet: one thread traces one ray. So every body runs at
// two packet sizes P (template parameter):
//   P = 1   the port's own inner visit: each thread follows its own e chain,
//           slab-tests its own ray and decides alone; the block-min extracts
//           are register reads. This prices rt_visit (csrc/trace.cuh) part
//           by part: rt_slab, rt_box_pair and rt_sort are the production
//           device functions.
//   P = 32  the scripts' semantics with the warp as the packet: each packet
//           minimum is a warp minimum over order-preserving integer keys
//           (__reduce_min_sync, as mb_slab_kernel of microbench_bf16.cu), so
//           e, the sort and the pushes are warp-uniform values.
// Thread i traces ray i % n_src; each thread writes its e, acc and `top`
// after K iterations (for P = 32 the same for the 32 lanes of a warp).
//
// Bodies (MbBody; the script's letter or name, its line):
//   inner  A full :138, B vec :160, C extract4 :173, D meta :187,
//          E meta_smem :196, F sort :205, G push :212, H meta4 :220,
//          I full_smem :229, J rowload :250, K extract24 :257,
//          N slabconst :267, M dual :280, M2 dual2 :338 (_one_dual :309),
//          M4 quad :346 and M8 oct :382 (MB_MQ, NPOP nodes), Lf2 and Lf4
//          (_leaf_body :431; MB_LF, NPOP groups; P = 32 only)
//   glue   full :214, nosort :236, nopush :256, nopush1 :272,
//          noextract :290, vec :300, sel1stack :321, ranksel :385
//          (_rank_dests :344), rankdual :404, full_x2 :465,
//          x2_nosortpush :499, full_x4 :526, full_xs :570, xb :612
//          (NPOP = npop, 4 or 8; arity 4)
// The stack indices are the scripts': inner pushes from 8 (M2's second
// visit from 64, G from 0), glue's inner and leaf stacks from 8, the
// two-ended top at 500, the dump slot at 511, so e follows the script.
//
// Extraction at P = 32 (glue's strategies in their nearest warp form):
//   production (full and the rest)  one warp reduction per child;
//   x2 (full_x2, x2_nosortpush)     ONE reduction over all children at once:
//                                   a reduce-scatter butterfly leaves child
//                                   c's minimum in lane c, then one shuffle
//                                   per child reads it (the script's grouped
//                                   vector reduce, then one read per child);
//   x4 (full_x4)                    a full shuffle butterfly per child;
//   xb                              one __ballot_sync per child packed into a
//                                   32-bit mask, unpacked with shifts (the
//                                   script's two 16-bit sums).
// At P = 1 there is nothing to reduce: x2 and x4 are full, xb builds its mask
// from the thread's own compares.
//
// Traps, and what the design does about them:
// 1. Dead stores. The scripts never read their stacks back; nvcc deletes
//    stores to a local array that nothing reads, and the push bodies would
//    time nothing. Each thread writes `top` after the loop: the entries at
//    the final stack pointers (stk[sp - 1] of each stack, the two-ended
//    stack's stk[ltp + 1]), read at run-time indices, so every store of
//    the loop stays live; e is untouched and stays the script's. The K loop
//    is not unrolled (#pragma unroll 1), so the STL / STS of one iteration
//    are the function's; microbench/sass.py counts them in the built object
//    and the records carry the count beside the time.
// 2. (microbench_cond.cu.)
// 3. Memory spaces and occupancy. The scripts' SMEM tables become a copy in
//    shared memory (MS = MB_SHARED): meta_flat (4,096 x 8 i32, 128 KB; E,
//    I) and meta_s (4,096 x 4, 64 KB; full_xs, xb), copied by each block
//    before its loop (outside the marginal); the production read is __ldg
//    from global memory (MS = MB_GLOBAL). Those instances run in blocks of
//    1,024 threads (BLOCK): 1 block of 128 KB or 2 of 64 KB per SM. Each
//    has a global-memory twin at the same block size, launched with the
//    same dynamic shared memory unused, so that the two differ in the
//    memory space and not in occupancy. The stack's placement is an axis of
//    G and glue's full (SP): MB_LOCAL, the production per-thread array, or
//    MB_SHARED, a per-thread column in shared memory, entry k of thread t
//    at k * BLOCK + t, trimmed to the entries the body touches; the local
//    twin is launched with the same shared memory unused. The wrapper
//    reports each launch's occupancy (cudaOccupancyMaxActiveBlocksPer-
//    Multiprocessor).
// 4. Rounding. The unit builds with -fmad=false: rt_slab's lo * inv - oi
//    rounds twice, as the plain version's torch ops do, so the kernel is
//    held to its plain version bit for bit (e, acc, top). (XLA's CPU code
//    may contract the script's product and difference into one FMA: the
//    CPU tests compare the plain version with the script, and walk the
//    script's rounding where an ulp flips a near tie.) Lf's products are
//    the tensor cores', summed in their own order: its e and top are held
//    exactly, its acc to K x 1e-6 + 1e-5 |acc| (chip_smoke.py).
//
// What bounds it: per iteration a thread does up to 32 slab tests (25 FP32
// operations each), sort networks (5 compare-exchanges per node) and loads
// from tables of 640 KB (node rows and meta) that live in L1 / L2; the
// chain through e makes each iteration's loads depend on the last one, so
// latency and instruction throughput, not bytes, bound it.

#pragma once

#include "trace.cuh"

#define MB_NODES 4096      // N_NODES of both scripts
#define MB_LF_GROUPS 512   // G of _leaf_body
#define MB_TWO_END 500     // glue's two-ended stack: the leaf top
#define MB_DUMP 511        // glue's dump slot for invalid children

enum MbBody {
  MB_A = 0, MB_B = 1, MB_C = 2, MB_D = 3, MB_E = 4, MB_F = 5, MB_G = 6, MB_H = 7,
  MB_I = 8, MB_J = 9, MB_K = 10, MB_N = 11, MB_M = 12, MB_M2 = 13, MB_MQ = 14,
  MB_LF = 15,
  MB_GL_FULL = 20, MB_GL_NOSORT = 21, MB_GL_NOPUSH = 22, MB_GL_NOPUSH1 = 23,
  MB_GL_NOEXTRACT = 24, MB_GL_VEC = 25, MB_GL_SEL1 = 26, MB_GL_RANKSEL = 27,
  MB_GL_RANKDUAL = 28, MB_GL_FULL_X2 = 29, MB_GL_X2_ONLY = 30, MB_GL_FULL_X4 = 31,
  MB_GL_FULL_XS = 32, MB_GL_XB = 33
};
enum MbPlace { MB_LOCAL = 0, MB_GLOBAL = 0, MB_SHARED = 1 };

struct MbInnerArgs {
  RtRays rays;
  int n_src;               // rays in the planes, a multiple of 32
  const uint4* cbox;       // (4096, 32) f32 node rows
  const int4* cmeta;       // (4096, 8) i32: 4 encodings, 4 validity flags
  const int* mtab;         // E, I: meta_flat (4096 * 8); full_xs, xb: meta_s (4096 * 4)
  int mtab_ints;           // ints in mtab (a multiple of 4)
  const unsigned* cmi;     // Lf: (512 * 32, 32) bf16 rows [Ch | Cl] as 32-bit words
  const float* rmat;       // Lf: (16, n_src) f32 feature rows
  int iters;               // K
  int* e_out;
  float* acc_out;
  int* top_out;
};

extern __shared__ int4 mbi_smem4[];

// An f32 distance as an int whose signed order is the float order (the two
// zeros aside: the fixtures never give an exact zero).
RT_FN int mbi_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
RT_FN float mbi_unkey(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

// The packet minimum: the thread's own value (P = 1) or the warp's (P = 32).
template <int P>
RT_FN float mbi_pmin(float x) {
  if constexpr (P == 1) {
    return x;
  } else {
    return mbi_unkey(__reduce_min_sync(RT_WARP, mbi_key(x)));
  }
}

// x mod N with the sign of N, as jnp's % (Python's).
RT_FN int mbi_pymod(int x) {
  const int r = x % MB_NODES;
  return r < 0 ? r + MB_NODES : r;
}

// Entry distances of the 4 children of node row e for this ray (rt_visit's
// loads: 3 float4 per pair of children; rt_slab with t_cut = RT_TMAX).
RT_FN void mbi_slab4(const uint4* cbox, int e, const RtRay& r, float (&v)[4]) {
  const uint4* row = cbox + (size_t)e * 8;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float3 lo[2], hi[2];
    rt_box_pair<RT_F32>(row, m, lo, hi);
    v[2 * m] = rt_slab(lo[0], hi[0], r, RT_TMAX);
    v[2 * m + 1] = rt_slab(lo[1], hi[1], r, RT_TMAX);
  }
}

RT_FN float mbi_min4(const float (&v)[4]) {
  return fminf(fminf(v[0], v[1]), fminf(v[2], v[3]));
}

// A meta-table int: the shared copy (MS = MB_SHARED) or __ldg from global.
template <int MS>
RT_FN int mbi_mread(const int* g, int k) {
  if constexpr (MS == MB_SHARED) {
    return reinterpret_cast<const int*>(mbi_smem4)[k];
  } else {
    return __ldg(g + k);
  }
}

// A per-thread stack holding indices BASE..BASE+SIZE-1: local, an array
// of the script's scratch size (LOCAL: 256 inner, 512 glue), indexed as the
// script indexes it (a trimmed array of a few entries would be kept in
// registers by nvcc, dynamic indices and all, as select chains: no longer
// the production's per-thread stack in local memory); or a column of
// shared memory after `off` ints, trimmed to the touched entries.
template <int SP, int BASE, int SIZE, int BLOCK, int LOCAL>
struct MbiStack {
  static_assert(BASE + SIZE <= LOCAL, "the script's scratch holds the stack");
  int v[LOCAL];
  RT_FN MbiStack(int) {}
  RT_FN int& operator[](int k) { return v[k]; }
};
template <int BASE, int SIZE, int BLOCK, int LOCAL>
struct MbiStack<MB_SHARED, BASE, SIZE, BLOCK, LOCAL> {
  int* col;
  RT_FN MbiStack(int off) {
    col = reinterpret_cast<int*>(mbi_smem4) + off + threadIdx.x - BASE * BLOCK;
  }
  RT_FN int& operator[](int k) { return col[k * BLOCK]; }
};

template <class S>
RT_FN int mbi_top(S& st, int sp, int base) {
  return sp > base ? st[sp - 1] : 0;
}

// One node's 4 child minima (masked by its validity flags when MASK) and
// encodings from cmeta.
template <int P, bool MASK>
RT_FN void mbi_node(const MbInnerArgs& p, int e, const RtRay& r, float (&ms)[4],
                    int (&es)[4]) {
  float v[4];
  mbi_slab4(p.cbox, e, r, v);
  const int4 enc = __ldg(p.cmeta + 2 * e);
  es[0] = enc.x; es[1] = enc.y; es[2] = enc.z; es[3] = enc.w;
#pragma unroll
  for (int k = 0; k < 4; ++k) ms[k] = mbi_pmin<P>(v[k]);
  if constexpr (MASK) {
    const int4 val = __ldg(p.cmeta + 2 * e + 1);
    const int f[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) ms[k] = f[k] > 0 ? ms[k] : RT_TMAX;
  }
}

// Push far-to-near onto one stack: store at sp, bump when the child was hit
// (the scripts' form: the store is unconditional, the bump predicated).
template <class S>
RT_FN void mbi_push4(S& st, int& sp, const float (&ms)[4], const int (&es)[4]) {
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    st[sp] = es[k];
    sp += ms[k] < RT_TMAX ? 1 : 0;
  }
}

// _one_dual (microbench_inner.py:316): the dual visit of rows e and e + 1;
// returns e + pushes + es1[0] and ms1[0] through `ms0`.
template <int P, class S>
RT_FN int mbi_dual(const MbInnerArgs& p, int e, const RtRay& r, S& st, int& sp, float& ms0) {
  const int e2 = (e + 1) % MB_NODES;
  float ms1[4], ms2[4];
  int es1[4], es2[4];
  mbi_node<P, true>(p, e, r, ms1, es1);
  mbi_node<P, true>(p, e2, r, ms2, es2);
  rt_sort<4>(ms1, es1);
  rt_sort<4>(ms2, es2);
  const int sp0 = sp;
  mbi_push4(st, sp, ms2, es2);
  mbi_push4(st, sp, ms1, es1);
  ms0 = ms1[0];
  return e + sp - sp0 + es1[0];
}

// ---- glue's extraction strategies at P = 32 -----------------------------------

// x2: a reduce-scatter butterfly over C = 16 or 32 children leaves child c's
// warp minimum in lane c (and c + 16 for C = 16); one shuffle per child
// reads it. Each stage is its own instance (HALF a constant), so every
// index is known at compile time and the values stay in registers.
template <int HALF, int C>
RT_FN void mbi_x2_stage(float (&v)[C]) {
  const bool up = ((threadIdx.x & 31) & HALF) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = up ? v[j] : v[j + HALF];
    const float keep = up ? v[j + HALF] : v[j];
    v[j] = fminf(keep, __shfl_xor_sync(RT_WARP, send, HALF));
  }
  if constexpr (HALF > 1) mbi_x2_stage<HALF / 2>(v);
}

template <int C>
RT_FN void mbi_x2(float (&v)[C], float (&ms)[C]) {
  mbi_x2_stage<C / 2>(v);
  if constexpr (C == 16) v[0] = fminf(v[0], __shfl_xor_sync(RT_WARP, v[0], 16));
#pragma unroll
  for (int c = 0; c < C; ++c) ms[c] = __shfl_sync(RT_WARP, v[0], c);
}

// x4: a full shuffle butterfly per child.
RT_FN float mbi_x4(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x = fminf(x, __shfl_xor_sync(RT_WARP, x, off));
  return x;
}

// ranksel / rankdual (_rank_dests :344): each child's rank among the valid
// children of its kind that push before it (farther, ties by index).
RT_FN void mbi_ranks(const float (&ms)[4], const int (&es)[4], bool (&inner)[4],
                     bool (&leaf)[4], int (&ri)[4], int (&rl)[4], int& n_in, int& n_lf) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool ok = ms[k] < RT_TMAX, lc = es[k] < 0;
    inner[k] = ok && !lc;
    leaf[k] = ok && lc;
  }
  n_in = n_lf = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ri[k] = rl[k] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j == k) continue;
      const bool gt = j < k ? ms[j] >= ms[k] : ms[j] > ms[k];
      ri[k] += (gt && inner[j]) ? 1 : 0;
      rl[k] += (gt && leaf[j]) ? 1 : 0;
    }
    n_in += inner[k] ? 1 : 0;
    n_lf += leaf[k] ? 1 : 0;
  }
}

// ---- Lf: the bf16x3 leaf step on random feature rows ---------------------------

// The warp's A fragments from this lane's preloaded features fv[m][s][w]
// (features 2c, 2c+1, 2c+8, 2c+9 of the ray of lane 16m + row + 8s) plus
// the e-dependent nudge, split into bf16 halves (_split_bf16).
RT_FN void mbi_lf_a(const float (&fv)[2][2][4], float nudge, RtMxuA& a) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* f = fv[m][s];
      rt_split2(__fadd_rn(f[0], nudge), __fadd_rn(f[1], nudge), a.h[m][s], a.l[m][s]);
      rt_split2(__fadd_rn(f[2], nudge), __fadd_rn(f[3], nudge), a.h[m][2 + s],
                a.l[m][2 + s]);
    }
  }
}

// ---- the kernel ------------------------------------------------------------------

// Ints of dynamic shared memory before the stack columns: the meta table.
template <int MS>
RT_FN int mbi_stack_off(const MbInnerArgs& p) {
  return MS == MB_SHARED ? p.mtab_ints : 0;
}

template <int BODY, int NPOP, int P, int SP, int MS, int BLOCK>
__global__ void __launch_bounds__(BLOCK) mb_inner_kernel(MbInnerArgs p) {
  static_assert(P == 1 || P == 32, "packet of one ray or one warp");
  static_assert(BODY != MB_LF || P == 32, "the leaf step is a warp step");
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if constexpr (MS == MB_SHARED) {
    const int4* src = reinterpret_cast<const int4*>(p.mtab);
    for (int k = threadIdx.x; k < p.mtab_ints / 4; k += BLOCK) mbi_smem4[k] = __ldg(src + k);
    __syncthreads();
  }
  const int soff = mbi_stack_off<MS>(p);
  float3 o, d;
  rt_load(p.rays, i % p.n_src, o, d);
  const RtRay r = rt_ray(o, d);
  int e = 0;
  float acc = 0.f;
  int top = 0;

  if constexpr (BODY == MB_LF) {
    // features of the rays of this lane's A rows, loaded once
    const int lane = threadIdx.x & 31, row = lane >> 2, c = lane & 3;
    const int base = (i - lane) % p.n_src;
    float fv[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int ray = base + 16 * m + row + 8 * s;
        const int ks[4] = {2 * c, 2 * c + 1, 2 * c + 8, 2 * c + 9};
#pragma unroll
        for (int w = 0; w < 4; ++w) fv[m][s][w] = __ldg(p.rmat + (size_t)ks[w] * p.n_src + ray);
      }
    }
    const RtScene sc{nullptr, nullptr, nullptr, nullptr, p.cmi, 32};
    int idx = -1;
#pragma unroll 1
    for (int it = 0; it < p.iters; ++it) {
      RtMxuA a;
      mbi_lf_a(fv, __fmul_rn((float)e, 1e-9f), a);
      float t = RT_TMAX;
      idx = -1;
#pragma unroll
      for (int n = 0; n < NPOP; ++n) {
        const int g = (e + 5 * n) % MB_LF_GROUPS;
        __syncwarp();
        RtMxuB b;
        rt_mxu_load(sc, g, b);
        float tn = RT_TMAX;
        int code = 0;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float q[4][4];
          rt_mxu_quants(a, m, b, q);
          rt_mxu_closest_tile(q, m, tn, code);
        }
        if (tn < t) {
          t = tn;
          idx = g * RT_LEAF + (code & 7);
        }
      }
      const float m0 = mbi_pmin<P>(t);
      const int en = e + 1 + (m0 < 0.f ? 1 : 0) + __shfl_sync(RT_WARP, idx, 0);
      acc = __fadd_rn(acc, m0);
      e = abs(en) % MB_NODES;
    }
    top = idx;
  } else if constexpr (BODY < MB_GL_FULL) {
    // ---- microbench_inner.py ----
    constexpr int SBASE = BODY == MB_G ? 0 : 8;
    // entries from SBASE: G 0..7; A, I 8..12; M 8..16; M2 8..72 (its second
    // visit pushes from 64); MQ 8..8 + 4 NPOP
    constexpr int SSIZE = BODY == MB_G ? 8 : BODY == MB_M ? 9 : BODY == MB_M2 ? 65
                          : BODY == MB_MQ ? 4 * NPOP + 1 : 5;
    MbiStack<SP, SBASE, SSIZE, BLOCK, 256> st(soff);
    int sp = SBASE, sp2 = 64;
#pragma unroll 1
    for (int it = 0; it < p.iters; ++it) {
      int en;
      if constexpr (BODY == MB_A || BODY == MB_I) {
        float ms[4];
        int es[4];
        if constexpr (BODY == MB_A) {
          mbi_node<P, true>(p, e, r, ms, es);
        } else {
          float v[4];
          mbi_slab4(p.cbox, e, r, v);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ms[k] = mbi_pmin<P>(v[k]);
            es[k] = mbi_mread<MS>(p.mtab, e * 8 + k);
          }
        }
        rt_sort<4>(ms, es);
        sp = 8;
        mbi_push4(st, sp, ms, es);
        en = e + sp + es[0];
        acc = __fadd_rn(acc, ms[0]);
      } else if constexpr (BODY == MB_B || BODY == MB_N) {
        float v[4];
        if constexpr (BODY == MB_B) {
          mbi_slab4(p.cbox, e, r, v);
        } else {
          const float ef = (float)e;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float b = __fadd_rn(ef, (float)k);
            v[k] = rt_slab(make_float3(b, __fadd_rn(b, 1.f), __fadd_rn(b, 2.f)),
                           make_float3(__fadd_rn(b, 3.f), __fadd_rn(b, 4.f), __fadd_rn(b, 5.f)),
                           r, RT_TMAX);
          }
        }
        const float m0 = mbi_pmin<P>(mbi_min4(v));
        en = e + 1 + (m0 < 0.f ? 1 : 0);
        acc = __fadd_rn(acc, m0);
      } else if constexpr (BODY == MB_C) {
        float v[4];
        mbi_slab4(p.cbox, e, r, v);
        float ms[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) ms[k] = mbi_pmin<P>(v[k]);
        const float s = __fadd_rn(__fadd_rn(__fadd_rn(ms[0], ms[1]), ms[2]), ms[3]);
        en = e + 1 + (s < 0.f ? 1 : 0);
        acc = __fadd_rn(acc, s);
      } else if constexpr (BODY == MB_D || BODY == MB_H) {
        const int4 enc = __ldg(p.cmeta + 2 * e);
        int s = enc.x + enc.y + enc.z + enc.w;
        if constexpr (BODY == MB_D) {
          const int4 val = __ldg(p.cmeta + 2 * e + 1);
          s += val.x + val.y + val.z + val.w;
        }
        en = e + 1 + s;
      } else if constexpr (BODY == MB_E) {
        int s = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) s += mbi_mread<MS>(p.mtab, e * 8 + k);
        en = e + 1 + s;
      } else if constexpr (BODY == MB_F) {
        float ms[4];
        int es[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ms[k] = __fadd_rn(acc, (float)k);
          es[k] = e + k;
        }
        rt_sort<4>(ms, es);
        en = es[0] + es[3];
        acc = __fsub_rn(__fadd_rn(acc, ms[0]), ms[3]);
      } else if constexpr (BODY == MB_G) {
        sp = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          st[sp] = e + k;
          sp += ((e + k) % 2 == 0) ? 1 : 0;
        }
        en = e + sp;
      } else if constexpr (BODY == MB_J) {
        const float v = __ldg(reinterpret_cast<const float*>(p.cbox) + (size_t)e * 32);
        en = e + 1 + (v < 0.f ? 1 : 0);
        acc = __fadd_rn(acc, v);
      } else if constexpr (BODY == MB_K) {
        const uint4* row = p.cbox + (size_t)e * 8;
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float3 lo[2], hi[2];
          rt_box_pair<RT_F32>(row, m, lo, hi);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s = __fadd_rn(s, lo[j].x); s = __fadd_rn(s, lo[j].y); s = __fadd_rn(s, lo[j].z);
            s = __fadd_rn(s, hi[j].x); s = __fadd_rn(s, hi[j].y); s = __fadd_rn(s, hi[j].z);
          }
        }
        en = e + 1 + (s < 0.f ? 1 : 0);
        acc = __fadd_rn(acc, s);
      } else if constexpr (BODY == MB_M) {
        sp = 8;
        float ms0;
        en = mbi_dual<P>(p, e, r, st, sp, ms0) + 8;   // e + sp + es1[0]
        acc = __fadd_rn(acc, ms0);
      } else if constexpr (BODY == MB_M2) {
        const int eb = (e * 7 + 13) % MB_NODES;
        float ma, mb;
        sp = 8;
        sp2 = 64;
        const int ea_n = mbi_dual<P>(p, e, r, st, sp, ma);
        const int eb_n = mbi_dual<P>(p, eb, r, st, sp2, mb);
        en = mbi_pymod(ea_n + eb_n);
        acc = __fadd_rn(__fadd_rn(acc, ma), mb);
      } else {  // MB_MQ: NPOP nodes (e + 3k) % N, one stack
        sp = 8;
        int e_next = 0;
        float m_acc = 0.f;
#pragma unroll
        for (int n = 0; n < NPOP; ++n) {
          float ms[4];
          int es[4];
          mbi_node<P, true>(p, (e + 3 * n) % MB_NODES, r, ms, es);
          rt_sort<4>(ms, es);
          mbi_push4(st, sp, ms, es);
          e_next += es[0];
          m_acc = __fadd_rn(m_acc, ms[0]);
        }
        en = mbi_pymod(e + e_next + sp);
        acc = __fadd_rn(acc, m_acc);
      }
      e = abs(en) % MB_NODES;
    }
    if constexpr (BODY == MB_G) {
      top = mbi_top(st, sp, 0);
    } else if constexpr (BODY == MB_M2) {
      top = mbi_top(st, sp, 8) + mbi_top(st, sp2, 64);
    } else if constexpr (BODY == MB_A || BODY == MB_I || BODY == MB_M || BODY == MB_MQ) {
      top = mbi_top(st, sp, 8);
    }
  } else {
    // ---- microbench_glue.py: NPOP nodes (e + 3i) % N, arity 4 ----
    constexpr bool TWO_END = BODY == MB_GL_SEL1 || BODY == MB_GL_RANKSEL;
    constexpr bool BIG = TWO_END || BODY == MB_GL_RANKDUAL;   // indices up to 511
    constexpr int SSIZE = BIG ? 512 - 8 : 4 * NPOP + 1;
    MbiStack<SP, 8, SSIZE, BLOCK, 512> ist(soff);
    MbiStack<SP, 8, SSIZE, BLOCK, 512> lst(soff + SSIZE * BLOCK);
    int isp = 8, lsp = 8;
#pragma unroll 1
    for (int it = 0; it < p.iters; ++it) {
      int ens[NPOP];
      float v[NPOP][4];
#pragma unroll
      for (int n = 0; n < NPOP; ++n) {
        ens[n] = (e + 3 * n) % MB_NODES;
        mbi_slab4(p.cbox, ens[n], r, v[n]);
      }
      int en;
      if constexpr (BODY == MB_GL_VEC || BODY == MB_GL_NOEXTRACT) {
        float m = mbi_min4(v[0]);
#pragma unroll
        for (int n = 1; n < NPOP; ++n) m = fminf(m, mbi_min4(v[n]));
        const float m0 = mbi_pmin<P>(m);
        en = e + 1 + (m0 < 0.f ? 1 : 0);
        if constexpr (BODY == MB_GL_NOEXTRACT) en += __ldg(p.cmeta + 2 * ens[0]).x;
      } else {
        // the child minima ms[n][k] and encodings es[n][k]
        float ms[NPOP][4];
        int es[NPOP][4];
        bool okb[NPOP][4];
#pragma unroll
        for (int n = 0; n < NPOP; ++n) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if constexpr (BODY == MB_GL_FULL_XS || BODY == MB_GL_XB) {
              es[n][k] = mbi_mread<MS>(p.mtab, ens[n] * 4 + k);
            }
          }
          if constexpr (!(BODY == MB_GL_FULL_XS || BODY == MB_GL_XB)) {
            const int4 enc = __ldg(p.cmeta + 2 * ens[n]);
            es[n][0] = enc.x; es[n][1] = enc.y; es[n][2] = enc.z; es[n][3] = enc.w;
          }
        }
        if constexpr (BODY == MB_GL_XB) {
          // per-child hit bits packed into one mask, unpacked with shifts
          unsigned mask = 0u;
#pragma unroll
          for (int n = 0; n < NPOP; ++n) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              bool hit = v[n][k] < RT_TMAX;
              if constexpr (P == 32) hit = __ballot_sync(RT_WARP, hit) != 0u;
              mask |= (hit ? 1u : 0u) << (4 * n + k);
            }
          }
#pragma unroll
          for (int n = 0; n < NPOP; ++n) {
#pragma unroll
            for (int k = 0; k < 4; ++k) okb[n][k] = ((mask >> (4 * n + k)) & 1u) != 0u;
          }
        } else if constexpr (P == 32 && (BODY == MB_GL_FULL_X2 || BODY == MB_GL_X2_ONLY)) {
          float flat[4 * NPOP], red[4 * NPOP];
#pragma unroll
          for (int c = 0; c < 4 * NPOP; ++c) flat[c] = v[c / 4][c % 4];
          mbi_x2<4 * NPOP>(flat, red);
#pragma unroll
          for (int c = 0; c < 4 * NPOP; ++c) ms[c / 4][c % 4] = red[c];
        } else {
#pragma unroll
          for (int n = 0; n < NPOP; ++n) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if constexpr (P == 32 && BODY == MB_GL_FULL_X4) {
                ms[n][k] = mbi_x4(v[n][k]);
              } else {
                ms[n][k] = mbi_pmin<P>(v[n][k]);
              }
            }
          }
        }
        int chk = 0;
        if constexpr (BODY == MB_GL_X2_ONLY) {
          float s = 0.f;
#pragma unroll
          for (int n = 0; n < NPOP; ++n) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              s = __fadd_rn(s, ms[n][k]);
              chk += es[n][k];
            }
          }
          en = e + chk + (s < 0.f ? 1 : 0);
        } else if constexpr (BODY == MB_GL_NOPUSH) {
#pragma unroll
          for (int n = NPOP - 1; n >= 0; --n) {
            rt_sort<4>(ms[n], es[n]);
#pragma unroll
            for (int k = 3; k >= 0; --k) chk += ms[n][k] < RT_TMAX ? es[n][k] : 0;
          }
          en = e + chk;
        } else if constexpr (BODY == MB_GL_NOPUSH1) {
          isp = 8;
#pragma unroll
          for (int n = NPOP - 1; n >= 0; --n) {
            rt_sort<4>(ms[n], es[n]);
            mbi_push4(ist, isp, ms[n], es[n]);
            chk += es[n][0];
          }
          en = e + isp + chk;
        } else if constexpr (BODY == MB_GL_SEL1) {
          isp = 8;
          lsp = MB_TWO_END;
#pragma unroll
          for (int n = NPOP - 1; n >= 0; --n) {
            rt_sort<4>(ms[n], es[n]);
#pragma unroll
            for (int k = 3; k >= 0; --k) {
              const bool ok = ms[n][k] < RT_TMAX, lc = es[n][k] < 0;
              ist[lc ? lsp : isp] = es[n][k];
              isp += (ok && !lc) ? 1 : 0;
              lsp -= (ok && lc) ? 1 : 0;
            }
            chk += es[n][0];
          }
          en = e + isp + lsp + chk;
        } else if constexpr (BODY == MB_GL_RANKSEL || BODY == MB_GL_RANKDUAL) {
          isp = 8;
          lsp = BODY == MB_GL_RANKSEL ? MB_TWO_END : 8;
#pragma unroll
          for (int n = NPOP - 1; n >= 0; --n) {
            bool inner[4], leaf[4];
            int ri[4], rl[4], n_in, n_lf;
            mbi_ranks(ms[n], es[n], inner, leaf, ri, rl, n_in, n_lf);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if constexpr (BODY == MB_GL_RANKSEL) {
                ist[inner[k] ? isp + ri[k] : leaf[k] ? lsp - rl[k] : MB_DUMP] = es[n][k];
              } else {
                ist[inner[k] ? isp + ri[k] : MB_DUMP] = es[n][k];
                lst[leaf[k] ? lsp + rl[k] : MB_DUMP] = es[n][k];
              }
            }
            isp += n_in;
            lsp += BODY == MB_GL_RANKSEL ? -n_lf : n_lf;
            chk += es[n][0];
          }
          en = e + isp + lsp + chk;
        } else {
          // full, full_x2, full_x4, full_xs (sorted); nosort, xb (unsorted):
          // every child stored to both stacks, the pointer of its kind bumped
          isp = lsp = 8;
#pragma unroll
          for (int n = NPOP - 1; n >= 0; --n) {
            if constexpr (BODY != MB_GL_NOSORT && BODY != MB_GL_XB) rt_sort<4>(ms[n], es[n]);
#pragma unroll
            for (int k = 3; k >= 0; --k) {
              bool ok;
              if constexpr (BODY == MB_GL_XB) {
                ok = okb[n][k];
              } else {
                ok = ms[n][k] < RT_TMAX;
              }
              const bool lc = es[n][k] < 0;
              ist[isp] = es[n][k];
              isp += (ok && !lc) ? 1 : 0;
              lst[lsp] = es[n][k];
              lsp += (ok && lc) ? 1 : 0;
            }
            chk += es[n][0];
          }
          en = e + isp + lsp + chk;
        }
      }
      e = abs(en) % MB_NODES;
    }
    if constexpr (TWO_END) {
      top = mbi_top(ist, isp, 8) + (lsp < MB_TWO_END ? ist[lsp + 1] : 0);
    } else if constexpr (BODY == MB_GL_NOPUSH1) {
      top = mbi_top(ist, isp, 8);
    } else if constexpr (BODY != MB_GL_NOPUSH && BODY != MB_GL_NOEXTRACT &&
                         BODY != MB_GL_VEC && BODY != MB_GL_X2_ONLY) {
      top = mbi_top(ist, isp, 8) + mbi_top(lst, lsp, 8);
    }
  }
  p.e_out[i] = e;
  p.acc_out[i] = acc;
  p.top_out[i] = top;
}

// The C side of one instance: launch (grid n / BLOCK, `smem` bytes of
// dynamic shared memory, allowed first when past 48 KB) and occupancy.
template <int BODY, int NPOP, int P, int SP, int MS, int BLOCK>
struct MbInnerLaunch {
  static int launch(const MbInnerArgs& p, int n, int smem, cudaStream_t st) {
    auto k = mb_inner_kernel<BODY, NPOP, P, SP, MS, BLOCK>;
    if (smem > 48 * 1024) {
      const cudaError_t rc =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    k<<<n / BLOCK, BLOCK, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  static int occupancy(int smem, int* blocks) {
    auto k = mb_inner_kernel<BODY, NPOP, P, SP, MS, BLOCK>;
    if (smem > 48 * 1024) {
      const cudaError_t rc =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, BLOCK, smem);
  }
};

// An instance's key: body, npop (or nodes / groups), packet, stack and meta
// placement, block size.
constexpr int mbi_inst(int body, int npop, int packet, int sp, int ms, int block) {
  return (((body * 16 + npop) * 64 + packet) * 4 + sp * 2 + ms) * 2 + (block == 1024 ? 1 : 0);
}

#define MBI_CASE(BODY, NPOP, P, SP, MS, BLOCK)                                        \
  case mbi_inst(BODY, NPOP, P, SP, MS, BLOCK):                                         \
    return occ ? MbInnerLaunch<BODY, NPOP, P, SP, MS, BLOCK>::occupancy(smem, occ)    \
               : MbInnerLaunch<BODY, NPOP, P, SP, MS, BLOCK>::launch(p, n, smem, st);

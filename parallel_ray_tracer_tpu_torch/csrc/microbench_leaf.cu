// Kernel A of the microbench probes: K visits of 8-triangle leaves per ray,
// timed to ask the card what one leaf visit costs (microbench/mxu_leaf.py).
//
// It replaces the harness `pallas_run` (scripts/microbench_mxu_leaf.py:161,
// pallas_call :162) with its stage bodies: `vpu_kernel` :312 (the FP32
// leaf), `v1_kernel` :341 (operand placement), `v2_kernel` :387 (the product
// in f32 and in one bf16 pass), `v4_kernel` :478 and `v5_kernel` :590
// (bf16x3, with winner tracking), `v6_kernel_t1` :625 and `v6_kernel_t2`
// :652 (the C-matrix table's layout). On the TPU one 1,024-ray packet walks
// G resident groups, g = (g + 1) & (G - 1), and keeps the smallest t per ray.
//
// Here thread i traces ray i % n_src and walks the same ring of groups from
// an offset set by its lane: with D distinct groups per warp (`distinct`),
// lanes 32k/D .. 32(k+1)/D - 1 start at group k * G / D, so D = 1 is the
// TPU packet's case (every lane wants the same group) and D = 32 gives every
// lane its own. After K visits it writes t, and with FULL the winner's slot
// g * 8 + j (the first minimal t in visit order, the smallest j within a
// group), as the production traversals merge on a strict <. The grid is
// sized by the caller to fill the card.
//
// Modes, each visit of one group g by one ray:
//   MB_MT      the FP32 leaf: rt_mt on the 8 triangles of tri row g, read
//              with __ldg as rt_closest_on does (vpu_kernel);
//   MB_F32     the C-matrix product on the FP32 pipe: the group's 32 C rows
//              (f32, 2 KB) against the ray's features R, each quantity a
//              sum over k = 0..15 in order, then the divided test of
//              _hit_rows (v2_kernel in f32);
//   MB_BF16    one bf16 tensor-core pass: bf16(R) . bf16(C) in f32
//              (v2_kernel with dtype=bfloat16);
//   MB_BF16X3  the production leaf: rt_mxu_quants (Ch.Rh + Ch.Rl + Cl.Rh) and
//              rt_mxu_closest_tile (v5_kernel, v6_kernel_t2).
// The tensor-core modes go through the production serve loop: each visit
// the warp takes the pending groups one at a time (rt_mxu_next), loads the
// group's B fragments, skips an m-tile with no served lane, and every lane
// whose group it is takes its result. Table layouts (v6): the interleaved
// [hi | lo] rows of ops/pack.split_cmat (rt_mxu_load, pitch 32; the
// production layout), two tables of hi and lo rows (G*32, 16) each, and the
// four-group rows of ops/pack.pack_cmi4 (rt_mxu_load, pitch 128). Operand
// placement (v1 against v2): the rays in A and the C rows in B (production,
// rt_mxu_rays), or the C rows in A and the rays in B (c_in_a: 2 m-tiles of
// C rows by 4 n-tiles of 8 rays; lane 4r + c then holds the four
// quantities of triangle r for rays 2c, 2c + 1 of each n-tile, reduced over
// the 8 triangles by shuffles).
//
// What bounds it: a resident group is 384 bytes of tri row or 2 KB of C
// rows, read from L1 or L2; the FP32 leaf does 8 x 47 FP32 operations per
// ray and visit, the MXU leaf 24 mma.sync per served group whatever the
// lanes served, plus an epilogue of 14 operations a test and the shuffles.
// The design keeps the production device functions, so the probe measures
// the main path's leaf, not a copy of it.

#include "trace.cuh"

enum MbLeafMode { MB_MT = 0, MB_F32 = 1, MB_BF16 = 2, MB_BF16X3 = 3 };
enum MbLayout { MB_INTERLEAVED = 0, MB_TWO_TABLES = 1, MB_FOUR_GROUP = 2 };

struct MbLeafArgs {
  RtRays rays;
  int n_src;              // rays in the planes; thread i traces ray i % n_src
  const float4* tri;      // MB_MT: (G, 32) float4 rows
  const float* cf32;      // MB_F32: (G * 32, 16) f32 C rows
  const unsigned* cmat;   // bf16 modes: the table as 32-bit words
  const unsigned* clo;    // MB_TWO_TABLES: the lo table (cmat is hi)
  int cpitch;             // bf16 values per row of cmat: 32, 128 or 16
  int groups;             // G, a power of two
  int distinct;           // D: distinct groups per warp, a power of two <= 32
  int iters;              // K
  int n;                  // threads
  float* t_out;
  int* idx_out;
};

// The group that lane `lane` visits at visit v.
RT_FN int mb_group(const MbLeafArgs& p, int lane, int v) {
  const int cls = lane / (32 / p.distinct);
  return (cls * (p.groups / p.distinct) + v) & (p.groups - 1);
}

// The divided hit test of one triangle's quantities (_hit_rows,
// rt_mxu_closest_tile): t, or RT_TMAX on a miss.
RT_FN float mb_divided(float det, float tn, float un, float vn) {
  const float invdet = 1.0f / det;
  const float tt = tn * invdet;
  const float u = un * invdet;
  const float v = vn * invdet;
  const bool hit = (fabsf(det) >= RT_EPS) && (tt > RT_EPS) && (u >= 0.f) &&
                   (v >= 0.f) && ((u + v) <= 1.f);
  return hit ? tt : RT_TMAX;
}

// The ray's feature row R = [d, o x d, o, 1, 0 x 6] (_rmat_load).
RT_FN void mb_features(const RtRay& r, float (&f)[16]) {
  f[0] = r.d.x; f[1] = r.d.y; f[2] = r.d.z;
  f[3] = r.o.y * r.d.z - r.o.z * r.d.y;
  f[4] = r.o.z * r.d.x - r.o.x * r.d.z;
  f[5] = r.o.x * r.d.y - r.o.y * r.d.x;
  f[6] = r.o.x; f[7] = r.o.y; f[8] = r.o.z; f[9] = 1.f;
#pragma unroll
  for (int k = 10; k < 16; ++k) f[k] = 0.f;
}

// Merge a group's winner (t, j) into the ray's hit: strict <, as the
// production traversals merge.
template <bool FULL>
RT_FN void mb_merge(float tn, int g, int j, float& t, int& idx) {
  if (FULL) {
    if (tn < t) {
      t = tn;
      idx = g * RT_LEAF + j;
    }
  } else {
    t = fminf(t, tn);
  }
}

// B fragments of group g from the two-table layout: hi and lo rows of 16
// bf16 values (8 words) each, row 8q + r of the group at word (g*32 + 8q +
// r) * 8 of its table.
RT_FN void mb_load_two(const unsigned* hi, const unsigned* lo, int g, RtMxuB& b) {
  const int lane = threadIdx.x & 31, row = lane >> 2, c = lane & 3;
  const unsigned* bh = hi + ((size_t)g * 32 + row) * 8;
  const unsigned* bl = lo + ((size_t)g * 32 + row) * 8;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    b.h[q][0] = __ldg(bh + 64 * q + c);
    b.h[q][1] = __ldg(bh + 64 * q + 4 + c);
    b.l[q][0] = __ldg(bl + 64 * q + c);
    b.l[q][1] = __ldg(bl + 64 * q + 4 + c);
  }
}

template <int LAYOUT>
RT_FN void mb_load(const MbLeafArgs& p, const RtScene& s, int g, RtMxuB& b) {
  if constexpr (LAYOUT == MB_TWO_TABLES) {
    mb_load_two(p.cmat, p.clo, g, b);
  } else {
    rt_mxu_load(s, g, b);
  }
}

// rt_mxu_quants with one bf16 pass: Rh . Ch.
RT_FN void mb_quants_bf16(const RtMxuA& a, int m, const RtMxuB& b, float (&acc)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
    rt_mma(acc[q], a.h[m], b.h[q]);
  }
}

// ---- operand placement c_in_a: the C rows in A, the rays in B -------------

// The warp's rays as B fragments: n-tile t holds rays 8t..8t+7; lane 4r + c
// holds features 2c, 2c + 1 (word 0) and 2c + 8, 2c + 9 (word 1) of ray
// 8t + r, hi and lo halves (the columns of rt_mxu_rays).
struct MbRaysB {
  unsigned h[4][2], l[4][2];
};

RT_FN void mb_rays_b(const RtRay& r, MbRaysB& rb) {
  const int lane = threadIdx.x & 31, row = lane >> 2, c = lane & 3;
  float f[16];
  mb_features(r, f);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = __shfl_sync(RT_WARP, f[k], 8 * t + row);
    const float x0 = c == 0 ? v[0] : c == 1 ? v[2] : c == 2 ? v[4] : v[6];
    const float x1 = c == 0 ? v[1] : c == 1 ? v[3] : c == 2 ? v[5] : v[7];
    const float x2 = c == 0 ? v[8] : 0.f;
    const float x3 = c == 0 ? 1.f : 0.f;
    rt_split2(x0, x1, rb.h[t][0], rb.l[t][0]);
    rt_split2(x2, x3, rb.h[t][1], rb.l[t][1]);
  }
}

// Group g's C rows as A fragments of the interleaved table: m-tile m holds
// C rows 16m..16m+15 (quantities 2m and 2m + 1 of triangles 0..7); lane
// 4r + c: a[0] row r at columns 2c, 2c + 1 (word c), a[1] row r + 8, a[2]
// and a[3] the same rows at columns 2c + 8, 2c + 9 (word 4 + c); lo at +8.
struct MbCmatA {
  unsigned h[2][4], l[2][4];
};

RT_FN void mb_cmat_a(const unsigned* cmat, int g, MbCmatA& ca) {
  const int lane = threadIdx.x & 31, row = lane >> 2, c = lane & 3;
  const unsigned* base = cmat + (size_t)g * 32 * 16;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const unsigned* ra = base + (size_t)(16 * m + row) * 16;
    const unsigned* rb = ra + 8 * 16;
    ca.h[m][0] = __ldg(ra + c);
    ca.h[m][1] = __ldg(rb + c);
    ca.h[m][2] = __ldg(ra + 4 + c);
    ca.h[m][3] = __ldg(rb + 4 + c);
    ca.l[m][0] = __ldg(ra + 8 + c);
    ca.l[m][1] = __ldg(rb + 8 + c);
    ca.l[m][2] = __ldg(ra + 12 + c);
    ca.l[m][3] = __ldg(rb + 12 + c);
  }
}

// One served group with the C rows in A: for each n-tile with a served lane,
// the quantities of triangle r (lane 4r + c) for rays 2c, 2c + 1, the
// divided test, the winner over the 8 triangles (smallest t, smallest j on
// ties) by shuffles across r, and the ray's lane takes its winner.
template <int MODE>
RT_FN void mb_group_c_in_a(const MbCmatA& ca, const MbRaysB& rb, unsigned served,
                           float& t_own, int& j_own) {
  const int lane = threadIdx.x & 31, row = lane >> 2;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!(served & (0xFFu << (8 * t)))) continue;  // the same for every lane
    float acc[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
      rt_mma(acc[m], ca.h[m], rb.h[t]);
      if (MODE == MB_BF16X3) {
        rt_mma(acc[m], ca.h[m], rb.l[t]);
        rt_mma(acc[m], ca.l[m], rb.h[t]);
      }
    }
    float bt[2];
    int bj[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // acc[0]: det (row r), t_num (row r + 8); acc[1]: u_num, v_num
      bt[k] = mb_divided(acc[0][k], acc[0][2 + k], acc[1][k], acc[1][2 + k]);
      bj[k] = row;
#pragma unroll
      for (int x = 4; x <= 16; x <<= 1) {
        const float ot = __shfl_xor_sync(RT_WARP, bt[k], x);
        const int oj = __shfl_xor_sync(RT_WARP, bj[k], x);
        if (ot < bt[k] || (ot == bt[k] && oj < bj[k])) {
          bt[k] = ot;
          bj[k] = oj;
        }
      }
    }
    // ray 8t + 2c + k of the warp sits in lane c's register k
    const int src = (lane >> 1) & 3;
    const float t0 = __shfl_sync(RT_WARP, bt[0], src);
    const float t1 = __shfl_sync(RT_WARP, bt[1], src);
    const int j0 = __shfl_sync(RT_WARP, bj[0], src);
    const int j1 = __shfl_sync(RT_WARP, bj[1], src);
    if ((lane >> 3) == t) {
      t_own = (lane & 1) ? t1 : t0;
      j_own = (lane & 1) ? j1 : j0;
    }
  }
}

template <int MODE, bool FULL, int LAYOUT, bool C_IN_A>
__global__ void __launch_bounds__(RT_BLOCK) mb_leaf_kernel(MbLeafArgs p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float3 o, d;
  rt_load(p.rays, i % p.n_src, o, d);
  const RtRay r = rt_ray(o, d);
  float t = RT_TMAX;
  int idx = -1;
  if constexpr (MODE == MB_MT) {
    for (int v = 0; v < p.iters; ++v) {
      const int g = mb_group(p, lane, v);
      const float4* row = p.tri + (size_t)g * (RT_LANES / 4);
      float tg = RT_TMAX;
      int jg = 0;
#pragma unroll
      for (int j = 0; j < RT_LEAF; ++j) {
        bool nj;
        const float tj = rt_mt(r, __ldg(row + 3 * j), __ldg(row + 3 * j + 1),
                               __ldg(row + 3 * j + 2), nj);
        if (tj < tg) {
          tg = tj;
          jg = j;
        }
      }
      mb_merge<FULL>(tg, g, jg, t, idx);
    }
  } else if constexpr (MODE == MB_F32) {
    float f[16];
    mb_features(r, f);
    for (int v = 0; v < p.iters; ++v) {
      const int g = mb_group(p, lane, v);
      const float4* c4 = reinterpret_cast<const float4*>(p.cf32) + (size_t)g * 32 * 4;
      float tg = RT_TMAX;
      int jg = 0;
#pragma unroll
      for (int j = 0; j < RT_LEAF; ++j) {
        float qv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4* cr = c4 + (size_t)(8 * q + j) * 4;
          float acc = 0.f;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float4 cw = __ldg(cr + w);
            acc = acc + cw.x * f[4 * w];
            acc = acc + cw.y * f[4 * w + 1];
            acc = acc + cw.z * f[4 * w + 2];
            acc = acc + cw.w * f[4 * w + 3];
          }
          qv[q] = acc;
        }
        const float tj = mb_divided(qv[0], qv[1], qv[2], qv[3]);
        if (tj < tg) {
          tg = tj;
          jg = j;
        }
      }
      mb_merge<FULL>(tg, g, jg, t, idx);
    }
  } else if constexpr (C_IN_A) {
    static_assert(LAYOUT == MB_INTERLEAVED, "c_in_a reads the interleaved table");
    MbRaysB rb;
    mb_rays_b(r, rb);
    for (int v = 0; v < p.iters; ++v) {
      const int g = mb_group(p, lane, v);
      unsigned pend = __ballot_sync(RT_WARP, true);
      __syncwarp();
      float tg = RT_TMAX;
      int jg = 0;
      do {
        unsigned served;
        int leader;
        const int gl = rt_mxu_next(pend, g, served, leader);
        MbCmatA ca;
        mb_cmat_a(p.cmat, gl, ca);
        float tb = RT_TMAX;
        int jb = 0;
        mb_group_c_in_a<MODE>(ca, rb, served, tb, jb);
        if (g == gl) {
          tg = tb;
          jg = jb;
        }
        pend &= ~served;
      } while (pend != 0u);
      mb_merge<FULL>(tg, g, jg, t, idx);
    }
  } else {
    const RtScene s = {nullptr, nullptr, nullptr, nullptr, p.cmat, p.cpitch};
    RtMxuA a;
    rt_mxu_rays(r, a);
    for (int v = 0; v < p.iters; ++v) {
      const int g = mb_group(p, lane, v);
      unsigned pend = __ballot_sync(RT_WARP, true);
      __syncwarp();
      float tg = RT_TMAX;
      int code = 0;
      do {
        unsigned served;
        int leader;
        const int gl = rt_mxu_next(pend, g, served, leader);
        RtMxuB b;
        mb_load<LAYOUT>(p, s, gl, b);
        float tb = RT_TMAX;
        int cb = 0;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (served & (0xFFFFu << (16 * m))) {  // the same for every lane
            float acc[4][4];
            if (MODE == MB_BF16X3) {
              rt_mxu_quants(a, m, b, acc);
            } else {
              mb_quants_bf16(a, m, b, acc);
            }
            rt_mxu_closest_tile(acc, m, tb, cb);
          }
        }
        if (g == gl) {
          tg = tb;
          code = cb;
        }
        pend &= ~served;
      } while (pend != 0u);
      mb_merge<FULL>(tg, g, code & 7, t, idx);
    }
  }
  if (i < p.n) {
    p.t_out[i] = t;
    p.idx_out[i] = idx;
  }
}

namespace {

template <int MODE, bool FULL, int LAYOUT = MB_INTERLEAVED, bool C_IN_A = false>
int mb_leaf_launch(const MbLeafArgs& p, cudaStream_t st) {
  mb_leaf_kernel<MODE, FULL, LAYOUT, C_IN_A><<<p.n / RT_BLOCK, RT_BLOCK, 0, st>>>(p);
  return (int)cudaGetLastError();
}

constexpr int mb_key(int mode, int full, int layout, int c_in_a) {
  return 64 * c_in_a + 16 * layout + 2 * mode + full;
}

}  // namespace

extern "C" {

// Launches kernel A on `stream` (no synchronisation, no allocation): n
// threads (a multiple of RT_BLOCK) over the n_src rays of the planes (a
// multiple of 32). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a combination without an instance. The
// instances: MB_MT, MB_F32, MB_BF16 and MB_BF16X3 with and without `full`
// on the interleaved table; MB_BF16X3 without `full` on the two-table and
// four-group layouts, and with the C rows in A.
int mb_leaf(const float* ox, const float* oy, const float* oz, const float* dx,
            const float* dy, const float* dz, int n_src, const void* tri,
            const void* cf32, const void* cmat, const void* clo, int cpitch,
            int groups, int mode, int full, int layout, int c_in_a,
            int distinct, int iters, int n, float* t_out, int* idx_out,
            void* stream) {
  MbLeafArgs p;
  p.rays = RtRays{ox, oy, oz, dx, dy, dz};
  p.n_src = n_src;
  p.tri = static_cast<const float4*>(tri);
  p.cf32 = static_cast<const float*>(cf32);
  p.cmat = static_cast<const unsigned*>(cmat);
  p.clo = static_cast<const unsigned*>(clo);
  p.cpitch = cpitch;
  p.groups = groups;
  p.distinct = distinct;
  p.iters = iters;
  p.n = n;
  p.t_out = t_out;
  p.idx_out = idx_out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mb_key(mode, full, layout, c_in_a)) {
    case mb_key(MB_MT, 0, 0, 0): return mb_leaf_launch<MB_MT, false>(p, st);
    case mb_key(MB_MT, 1, 0, 0): return mb_leaf_launch<MB_MT, true>(p, st);
    case mb_key(MB_F32, 0, 0, 0): return mb_leaf_launch<MB_F32, false>(p, st);
    case mb_key(MB_F32, 1, 0, 0): return mb_leaf_launch<MB_F32, true>(p, st);
    case mb_key(MB_BF16, 0, 0, 0): return mb_leaf_launch<MB_BF16, false>(p, st);
    case mb_key(MB_BF16, 1, 0, 0): return mb_leaf_launch<MB_BF16, true>(p, st);
    case mb_key(MB_BF16X3, 0, 0, 0): return mb_leaf_launch<MB_BF16X3, false>(p, st);
    case mb_key(MB_BF16X3, 1, 0, 0): return mb_leaf_launch<MB_BF16X3, true>(p, st);
    case mb_key(MB_BF16X3, 0, MB_TWO_TABLES, 0):
      return mb_leaf_launch<MB_BF16X3, false, MB_TWO_TABLES>(p, st);
    case mb_key(MB_BF16X3, 0, MB_FOUR_GROUP, 0):
      return mb_leaf_launch<MB_BF16X3, false, MB_FOUR_GROUP>(p, st);
    case mb_key(MB_BF16X3, 0, MB_INTERLEAVED, 1):
      return mb_leaf_launch<MB_BF16X3, false, MB_INTERLEAVED, true>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

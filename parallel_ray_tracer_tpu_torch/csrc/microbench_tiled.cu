// Row 15k of the microbench probes (microbench/tiled.py): does a warp whose
// lanes split the children between them beat one rt_slab per child per ray?
//
// It replaces `_run` of scripts/microbench_tiled.py (:78, pallas_call :103)
// with the bodies of its `main` (:272). One iteration loads the 8 node rows
// (e + 37 i) % 4096 (`_loads` :128; arity 4, so 32 children, child c = 4 i
// + k of row i), tests every child against the packet, takes each child's
// packet minimum and sums the 32 minima in child order into s
// (`body_current` :139, :150-151); then e = |e + 1 + (s < 0)| % 4096 and
// acc += s. The TPU variants lay the same work out in different ways on the
// vector unit; every one of them gives the same per-child minima. Here the
// packet is the warp (P = 32: the warp's 32 rays) or one ray (P = 1: the
// port's own per-ray visit, each thread with its own e chain):
//   MBT_CURRENT (A :139)            per ray, rt_slab on each child in the
//                                   order (row i, child k), the production
//                                   loads (rt_box_pair); P = 32: one warp
//                                   minimum per child (order-preserving
//                                   integer keys, __reduce_min_sync).
//   MBT_CHUNK, CH (B :188 at CH = 32; H, F, G: make_body_chunked(1, 2, 4)
//                 :233 at CH = 4, 8, 16)
//                                   the child-parallel form, P = 32. The warp
//                                   is CH children x 32 / CH lanes: lane l
//                                   loads child l % CH of the chunk (so the
//                                   rows are read once, coalesced, across the
//                                   warp) and tests it against the CH rays
//                                   (l / CH) CH + j, taking each ray's inv and
//                                   oi from its lane with __shfl_sync and
//                                   keeping a running minimum. The 32 / CH
//                                   lanes of a child are reduced by a
//                                   shuffle butterfly (none at CH = 32: child
//                                   c's minimum ends in lane c). The warp runs
//                                   32 / CH chunks an iteration.
//   MBT_CURRENT_NOREDUCE (C :199)   A with one minimum over all 32 children
//                                   and the packet.
//   MBT_CHUNK_NOREDUCE (D :211)     B with one minimum (the warp minimum of
//                                   the lanes' running minima).
//   MBT_CONSTRUCT (E :255)          B's child-parallel loads and lane layout
//                                   alone, with the script's checksum: for
//                                   each of the six planes (lo x, y, z, hi x,
//                                   y, z), s = s + p[0, 0] + p[255, 7], child
//                                   0's coordinate (lane 0), then child 31's
//                                   (lane 31).
//   MBT_LOADS (:264)                the 8 row loads, s = s + row[0] + row[5]
//                                   row by row; P = 1 each thread loads the 8
//                                   rows, P = 32 lane i < 8 loads row i and
//                                   the warp sums them in row order by
//                                   shuffles.
// s is the sum of the per-child minima in child order whatever the layout
// (the chunked forms add each chunk's minima, read from lanes 0..CH-1, in
// order), so every form equals its plain version bit for bit; min is exact,
// so the noreduce bodies need no order. Each thread writes its e and acc
// after K iterations (the K loop is not unrolled), which keeps every
// iteration live.
//
// Rounding: the unit builds with -fmad=false, so rt_slab's lo * inv - oi
// rounds twice, as the plain version's torch ops do. (XLA's CPU code may
// contract the script's product and difference into one FMA: the CPU tests
// hold the plain version to the script and walk its rounding where an ulp
// flips a near tie.)
//
// What bounds it: per iteration a thread does 32 slab tests (25 FP32
// operations each); the child-parallel forms add six shuffles per test for
// the ray's planes. The table (4,096 rows of 128 B) lives in L1 / L2 and
// each iteration's loads depend on the last one's e.

#include "trace.cuh"

#define MBT_NODES 4096   // N_NODES of the script
#define MBT_NPOP 8       // rows an iteration
#define MBT_NCH 32       // children an iteration (NPOP x arity 4)

enum MbTiledBody {
  MBT_CURRENT = 0, MBT_CHUNK = 1, MBT_CURRENT_NOREDUCE = 2, MBT_CHUNK_NOREDUCE = 3,
  MBT_CONSTRUCT = 4, MBT_LOADS = 5
};

struct MbTiledArgs {
  RtRays rays;
  int n_src;            // rays in the planes, a multiple of 32
  const float* cbox;    // (4096, 32) f32 node rows: child k's [min, max] at [6k, 6k + 6)
  int iters;            // K
  int* e_out;
  float* acc_out;
};

// An f32 as an int whose signed order is the float order (the two zeros
// aside: the fixtures never give an exact zero).
RT_FN int mbt_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
RT_FN float mbt_unkey(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

// The packet minimum: the thread's own value (P = 1) or the warp's (P = 32).
template <int P>
RT_FN float mbt_pmin(float x) {
  if constexpr (P == 1) {
    return x;
  } else {
    return mbt_unkey(__reduce_min_sync(RT_WARP, mbt_key(x)));
  }
}

// Row i of the iteration at e.
RT_FN int mbt_row(int e, int i) { return (e + 37 * i) % MBT_NODES; }

// Child c's box: floats 6k..6k+5 of row (e + 37 (c / 4)) % N, k = c % 4
// (three 8-byte loads).
RT_FN void mbt_child(const float* cbox, int e, int c, float3& lo, float3& hi) {
  const float2* b = reinterpret_cast<const float2*>(
      cbox + (size_t)mbt_row(e, c >> 2) * 32 + 6 * (c & 3));
  const float2 a = __ldg(b), m = __ldg(b + 1), z = __ldg(b + 2);
  lo = make_float3(a.x, a.y, m.x);
  hi = make_float3(m.y, z.x, z.y);
}

// The slab terms of the ray of lane `src` (rt_slab reads inv and oi only).
RT_FN RtRay mbt_ray_of(const RtRay& r, int src) {
  RtRay q;
  q.o = q.d = make_float3(0.f, 0.f, 0.f);
  q.inv = make_float3(__shfl_sync(RT_WARP, r.inv.x, src), __shfl_sync(RT_WARP, r.inv.y, src),
                      __shfl_sync(RT_WARP, r.inv.z, src));
  q.oi = make_float3(__shfl_sync(RT_WARP, r.oi.x, src), __shfl_sync(RT_WARP, r.oi.y, src),
                     __shfl_sync(RT_WARP, r.oi.z, src));
  return q;
}

template <int BODY, int CH, int P>
__global__ void __launch_bounds__(RT_BLOCK) mb_tiled_kernel(MbTiledArgs p) {
  static_assert(P == 1 || P == 32, "packet of one ray or one warp");
  constexpr bool WARP_FORM = BODY == MBT_CHUNK || BODY == MBT_CHUNK_NOREDUCE ||
                             BODY == MBT_CONSTRUCT;
  static_assert(!WARP_FORM || P == 32, "the child-parallel forms are warp forms");
  static_assert(BODY != MBT_CHUNK || CH == 4 || CH == 8 || CH == 16 || CH == 32,
                "CH children a chunk, 32 / CH lanes each");
  const int i = blockIdx.x * RT_BLOCK + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float3 o, d;
  rt_load(p.rays, i % p.n_src, o, d);
  const RtRay r = rt_ray(o, d);
  int e = 0;
  float acc = 0.f;
#pragma unroll 1
  for (int it = 0; it < p.iters; ++it) {
    float s = 0.f;
    if constexpr (BODY == MBT_CURRENT || BODY == MBT_CURRENT_NOREDUCE) {
      float v[MBT_NCH];
#pragma unroll
      for (int n = 0; n < MBT_NPOP; ++n) {
        const uint4* row = reinterpret_cast<const uint4*>(p.cbox) + (size_t)mbt_row(e, n) * 8;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float3 lo[2], hi[2];
          rt_box_pair<RT_F32>(row, m, lo, hi);
          v[4 * n + 2 * m] = rt_slab(lo[0], hi[0], r, RT_TMAX);
          v[4 * n + 2 * m + 1] = rt_slab(lo[1], hi[1], r, RT_TMAX);
        }
      }
      if constexpr (BODY == MBT_CURRENT) {
#pragma unroll
        for (int c = 0; c < MBT_NCH; ++c) s = __fadd_rn(s, mbt_pmin<P>(v[c]));
      } else {
        float m = v[0];
#pragma unroll
        for (int c = 1; c < MBT_NCH; ++c) m = fminf(m, v[c]);
        s = mbt_pmin<P>(m);
      }
    } else if constexpr (BODY == MBT_CHUNK || BODY == MBT_CHUNK_NOREDUCE) {
      const int g = lane / CH;     // this lane's rays: g CH .. g CH + CH - 1
      float best = RT_TMAX;
#pragma unroll
      for (int q = 0; q < MBT_NCH / CH; ++q) {
        float3 lo, hi;
        mbt_child(p.cbox, e, q * CH + lane % CH, lo, hi);
        float m = RT_TMAX;
#pragma unroll
        for (int j = 0; j < CH; ++j)
          m = fminf(m, rt_slab(lo, hi, mbt_ray_of(r, g * CH + j), RT_TMAX));
        if constexpr (BODY == MBT_CHUNK) {
#pragma unroll
          for (int off = CH; off < 32; off <<= 1) m = fminf(m, __shfl_xor_sync(RT_WARP, m, off));
#pragma unroll
          for (int j = 0; j < CH; ++j) s = __fadd_rn(s, __shfl_sync(RT_WARP, m, j));
        } else {
          best = fminf(best, m);
        }
      }
      if constexpr (BODY == MBT_CHUNK_NOREDUCE) s = mbt_pmin<32>(best);
    } else if constexpr (BODY == MBT_CONSTRUCT) {
      float3 lo, hi;
      mbt_child(p.cbox, e, lane, lo, hi);
      const float pl[6] = {lo.x, lo.y, lo.z, hi.x, hi.y, hi.z};
#pragma unroll
      for (int k = 0; k < 6; ++k)
        s = __fadd_rn(__fadd_rn(s, __shfl_sync(RT_WARP, pl[k], 0)),
                      __shfl_sync(RT_WARP, pl[k], MBT_NCH - 1));
    } else {  // MBT_LOADS
      if constexpr (P == 1) {
#pragma unroll
        for (int n = 0; n < MBT_NPOP; ++n) {
          const float4* row = reinterpret_cast<const float4*>(p.cbox) + (size_t)mbt_row(e, n) * 8;
          const float4 a = __ldg(row), b = __ldg(row + 1);
          s = __fadd_rn(__fadd_rn(s, a.x), b.y);
        }
      } else {
        float a0 = 0.f, a5 = 0.f;
        if (lane < MBT_NPOP) {
          const float* row = p.cbox + (size_t)mbt_row(e, lane) * 32;
          a0 = __ldg(row);
          a5 = __ldg(row + 5);
        }
#pragma unroll
        for (int n = 0; n < MBT_NPOP; ++n)
          s = __fadd_rn(__fadd_rn(s, __shfl_sync(RT_WARP, a0, n)), __shfl_sync(RT_WARP, a5, n));
      }
    }
    e = abs(e + 1 + (s < 0.f ? 1 : 0)) % MBT_NODES;
    acc = __fadd_rn(acc, s);
  }
  p.e_out[i] = e;
  p.acc_out[i] = acc;
}

namespace {

constexpr int mbt_inst(int body, int ch, int packet) { return (body * 64 + ch) * 64 + packet; }

template <int BODY, int CH, int P>
int mbt_launch(const MbTiledArgs& p, int n, cudaStream_t st) {
  mb_tiled_kernel<BODY, CH, P><<<n / RT_BLOCK, RT_BLOCK, 0, st>>>(p);
  return (int)cudaGetLastError();
}

#define MBT_CASE(BODY, CH, P) \
  case mbt_inst(BODY, CH, P): return mbt_launch<BODY, CH, P>(p, n, st);

int mbt_dispatch(const MbTiledArgs& p, int key, int n, cudaStream_t st) {
  switch (key) {
    MBT_CASE(MBT_CURRENT, 0, 1)
    MBT_CASE(MBT_CURRENT, 0, 32)
    MBT_CASE(MBT_CHUNK, 32, 32)
    MBT_CASE(MBT_CHUNK, 4, 32)
    MBT_CASE(MBT_CHUNK, 8, 32)
    MBT_CASE(MBT_CHUNK, 16, 32)
    MBT_CASE(MBT_CURRENT_NOREDUCE, 0, 1)
    MBT_CASE(MBT_CURRENT_NOREDUCE, 0, 32)
    MBT_CASE(MBT_CHUNK_NOREDUCE, 32, 32)
    MBT_CASE(MBT_CONSTRUCT, 32, 32)
    MBT_CASE(MBT_LOADS, 0, 1)
    MBT_CASE(MBT_LOADS, 0, 32)
  }
  return (int)cudaErrorInvalidValue;
}

#undef MBT_CASE

}  // namespace

extern "C" {

// One launch of a row-15k instance on `stream` (no synchronisation, no
// allocation): n threads (a multiple of RT_BLOCK), thread i on ray i % n_src.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// an instance not built (body, ch, packet).
int mb_tiled(const float* ox, const float* oy, const float* oz, const float* dx,
             const float* dy, const float* dz, int n_src, const float* cbox, int body, int ch,
             int packet, int iters, int n, int* e_out, float* acc_out, void* stream) {
  const MbTiledArgs p{RtRays{ox, oy, oz, dx, dy, dz}, n_src, cbox, iters, e_out, acc_out};
  return mbt_dispatch(p, mbt_inst(body, ch, packet), n, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

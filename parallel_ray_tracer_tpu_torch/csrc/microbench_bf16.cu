// Rows 15e-15h of the microbench probes (microbench/bf16.py): does the card
// issue packed bf16x2 at the rate of f32, so that one instruction covers
// twice the elements?
//
// It replaces scripts/microbench_bf16.py, which asked the TPU whether its
// VPU issues a (16, 128) bf16 tile at the rate of an (8, 128) f32 tile (the
// same vector registers). On Hopper the same question is whether a packed
// __nv_bfloat162 instruction (HMUL2 / HADD2 / HMNMX2 .BF16) costs what one
// f32 instruction costs: the reference CUDA renderer's half-precision payoff
// is two-lane compute, the half2 slab tests of gpu/src/bvh.cu:50-78.
//
// mb_chain_kernel<T, OP, W, ILP> replaces `_chain_bench` (:85, pallas_call
// :101; ILP = 1) and `_chain_bench_ilp` (:116, pallas_call :140; ILP = 4):
// K iterations of 40 dependent elementwise ops a = op(a, b) on one tile,
//   MB_FMS  a * b - b           (the slab's multiply-subtract form)
//   MB_MNX  min(max(a, b), b + a)  (the slab's reduction form)
// with ILP independent chains started at a + k (k < ILP) and summed in order
// at the end, as the script sums them. A block of MB_CHAIN_THREADS threads
// holds one R x 128 tile, W 32-bit words per thread (thread t holds words
// t + MB_CHAIN_THREADS * w): T = float holds one element a word, T =
// __nv_bfloat162 two, so an f32 (8, 128) tile and a bf16 (16, 128) tile
// take the same registers per thread (W = 2), the TPU's "same vregs"
// premise. Every block works the same tile and writes its result, so no
// chain is dead; the grid fills the card.
//
// Rounding: every op rounds on its own, as the plain version's torch ops
// round. f32 uses __fmul_rn / __fsub_rn / __fadd_rn (never contracted into
// an FMA; the unit builds with -fmad=false too); bf16 uses __hmul2_rn (not
// contracted), __hsub2, __hadd2, __hmin2, __hmax2, each rounding its bf16x2
// result once to nearest even, which for bf16 operands equals torch's
// bf16 ops on the CPU (computed in f32, then rounded: a product of two bf16
// values is exact in f32, and a sum is exact unless the operands' exponents
// differ by more than 16, where the smaller is far below half a bf16 ulp).
// min/max drop a NaN operand (fminf, __hmin2) where jnp.minimum keeps it;
// the min-max chain never makes a NaN on the script's data (its values stay
// bounded); the mul-sub chain overflows to +-inf, never to NaN (b is finite
// and nonzero).
//
// mb_slab_kernel<BF16> replaces `_slab_pair_f32` (:155, pallas_call :185)
// and `_slab_pair_bf16` (:200, pallas_call :255): per iteration the node
// row e of a (4096, 16) f32 table (two children's [min, max] at [0, 6) and
// [6, 12)), both children's slab tests for every ray of the packet, the
// packet minimum of each child's entry distance, and e = (e + 1 + (ml <
// mr)) % 4096, a chain through every iteration's results. The packet is
// the warp (thread i traces ray i % n_src; e is the same for a warp's
// lanes); each warp writes its e. f32: two rt_slab tests (the production
// slab of csrc/trace.cuh, pallas_trace._slab_masked) with t_cut = T_MAX.
// bf16: one packed test, child L in .x and R in .y of each __nv_bfloat162:
// the planes rounded to bf16 in the kernel, inv = bf16(1 / f32(bf16(d))),
// oi = o * inv in bf16, t = lo * inv - oi, min and max in bf16, then the
// compares in f32 (tmax >= tmin and tmax > 0, no t_cut, as the script).
// The packet minima are warp reductions (__reduce_min_sync on an
// order-preserving integer key of each f32 distance), compared as floats.
//
// What bounds it: operations. A chain op is one (mnx: three, fms: two)
// FP32 or bf16x2 instruction per word; H100 SXM peaks are 67 TFLOP/s FP32
// outside the tensor cores (an FMA counting two) and, on paper, 134 for
// packed bf16. The tables are a few KB (rows: 256 KB), read from L1 / L2.

#include <cuda_bf16.h>

#include "trace.cuh"

#define MB_CHAIN_THREADS 512
#define MB_CHAIN_OPS 40      // n_ops of the script
#define MB_SLAB_NODES 4096   // N_NODES of the script

enum MbChainOp { MB_FMS = 0, MB_MNX = 1 };

template <int OP>
__device__ __forceinline__ float mb_op(float a, float b) {
  if (OP == MB_FMS) return __fsub_rn(__fmul_rn(a, b), b);
  return fminf(fmaxf(a, b), __fadd_rn(b, a));
}

template <int OP>
__device__ __forceinline__ __nv_bfloat162 mb_op(__nv_bfloat162 a, __nv_bfloat162 b) {
  if (OP == MB_FMS) return __hsub2(__hmul2_rn(a, b), b);
  return __hmin2(__hmax2(a, b), __hadd2(b, a));
}

__device__ __forceinline__ float mb_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ __nv_bfloat162 mb_add(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hadd2(a, b);
}
__device__ __forceinline__ float mb_const(float, int k) { return (float)k; }
__device__ __forceinline__ __nv_bfloat162 mb_const(__nv_bfloat162, int k) {
  return __float2bfloat162_rn((float)k);
}

template <typename T, int OP, int W, int ILP>
__global__ void __launch_bounds__(MB_CHAIN_THREADS)
mb_chain_kernel(const T* __restrict__ a_in, const T* __restrict__ b_in, int iters,
                T* __restrict__ out) {
  const int t = threadIdx.x;
  T b[W], c[ILP][W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const T a0 = a_in[t + MB_CHAIN_THREADS * w];
    b[w] = b_in[t + MB_CHAIN_THREADS * w];
#pragma unroll
    for (int k = 0; k < ILP; ++k) c[k][w] = k == 0 ? a0 : mb_add(a0, mb_const(a0, k));
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < MB_CHAIN_OPS; ++j) {
#pragma unroll
      for (int k = 0; k < ILP; ++k) {
#pragma unroll
        for (int w = 0; w < W; ++w) c[k][w] = mb_op<OP>(c[k][w], b[w]);
      }
    }
  }
  T* o = out + (size_t)blockIdx.x * (W * MB_CHAIN_THREADS);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    T acc = c[0][w];
#pragma unroll
    for (int k = 1; k < ILP; ++k) acc = mb_add(acc, c[k][w]);
    o[t + MB_CHAIN_THREADS * w] = acc;
  }
}

// An f32 distance as an int whose signed order is the float order (the
// two zeros aside, which the caller compares as floats).
__device__ __forceinline__ int mb_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float mb_unkey(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}
__device__ __forceinline__ float mb_warp_min(float x) {
  return mb_unkey(__reduce_min_sync(RT_WARP, mb_key(x)));
}

template <bool BF16>
__global__ void __launch_bounds__(RT_BLOCK)
mb_slab_kernel(const float4* __restrict__ rows, RtRays rays, int n_src, int iters,
               int* __restrict__ e_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // the grid is whole warps
  float3 o, d;
  rt_load(rays, i % n_src, o, d);
  const RtRay r = rt_ray(o, d);
  __nv_bfloat162 o2[3], inv2[3], oi2[3];
  if (BF16) {
    const float oc[3] = {o.x, o.y, o.z}, dc[3] = {d.x, d.y, d.z};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o2[a] = __float2bfloat162_rn(oc[a]);
      inv2[a] = __float2bfloat162_rn(1.0f / __bfloat162float(__float2bfloat16_rn(dc[a])));
      oi2[a] = __hmul2_rn(o2[a], inv2[a]);
    }
  }
  int e = 0;
  for (int it = 0; it < iters; ++it) {
    const float4 x0 = __ldg(rows + 4 * e), x1 = __ldg(rows + 4 * e + 1),
                 x2 = __ldg(rows + 4 * e + 2);
    float vl, vr;
    if (!BF16) {
      vl = rt_slab(make_float3(x0.x, x0.y, x0.z), make_float3(x0.w, x1.x, x1.y), r, RT_TMAX);
      vr = rt_slab(make_float3(x1.z, x1.w, x2.x), make_float3(x2.y, x2.z, x2.w), r, RT_TMAX);
    } else {
      const float lo[2][3] = {{x0.x, x0.y, x0.z}, {x1.z, x1.w, x2.x}};
      const float hi[2][3] = {{x0.w, x1.x, x1.y}, {x2.y, x2.z, x2.w}};
      __nv_bfloat162 tmin, tmax;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const __nv_bfloat162 l2 = __floats2bfloat162_rn(lo[0][a], lo[1][a]);
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(hi[0][a], hi[1][a]);
        const __nv_bfloat162 t1 = __hsub2(__hmul2_rn(l2, inv2[a]), oi2[a]);
        const __nv_bfloat162 t2 = __hsub2(__hmul2_rn(h2, inv2[a]), oi2[a]);
        const __nv_bfloat162 lo_t = __hmin2(t1, t2), hi_t = __hmax2(t1, t2);
        tmin = a == 0 ? lo_t : __hmax2(tmin, lo_t);
        tmax = a == 0 ? hi_t : __hmin2(tmax, hi_t);
      }
      const float2 tn = __bfloat1622float2(tmin), tx = __bfloat1622float2(tmax);
      vl = (tx.x >= tn.x && tx.x > 0.f) ? tn.x : RT_TMAX;
      vr = (tx.y >= tn.y && tx.y > 0.f) ? tn.y : RT_TMAX;
    }
    const float ml = mb_warp_min(vl), mr = mb_warp_min(vr);
    e = (e + 1 + (ml < mr ? 1 : 0)) % MB_SLAB_NODES;
  }
  if ((threadIdx.x & 31) == 0) e_out[i >> 5] = e;
}

namespace {

template <typename T, int OP, int W, int ILP>
int mb_chain_launch(const void* a, const void* b, int iters, int blocks, void* out,
                    cudaStream_t st) {
  mb_chain_kernel<T, OP, W, ILP><<<blocks, MB_CHAIN_THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), iters, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One chain instance on `stream`: a and b are one tile of words * 512
// 32-bit words (f32, or bf16 pairs when bf16 != 0); out holds `blocks`
// tiles. The instances are the script's (op, shape, dtype) cases and ILP 4
// at bf16 (16, 128); any other returns cudaErrorInvalidValue.
int mb_chain(const void* a, const void* b, int bf16, int op, int words, int ilp, int iters,
             int blocks, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = (bf16 << 12) | (op << 8) | (words << 4) | ilp;
#define MB_CASE(BF, OP, W, ILP, T) \
  case ((BF) << 12) | ((OP) << 8) | ((W) << 4) | (ILP): \
    return mb_chain_launch<T, OP, W, ILP>(a, b, iters, blocks, out, st);
  switch (key) {
    MB_CASE(0, MB_FMS, 2, 1, float)
    MB_CASE(0, MB_FMS, 4, 1, float)
    MB_CASE(0, MB_MNX, 2, 1, float)
    MB_CASE(0, MB_FMS, 2, 4, float)
    MB_CASE(0, MB_FMS, 4, 4, float)
    MB_CASE(0, MB_FMS, 8, 4, float)
    MB_CASE(0, MB_MNX, 2, 4, float)
    MB_CASE(0, MB_MNX, 4, 4, float)
    MB_CASE(1, MB_FMS, 1, 1, __nv_bfloat162)
    MB_CASE(1, MB_FMS, 2, 1, __nv_bfloat162)
    MB_CASE(1, MB_FMS, 4, 1, __nv_bfloat162)
    MB_CASE(1, MB_MNX, 2, 1, __nv_bfloat162)
    MB_CASE(1, MB_FMS, 2, 4, __nv_bfloat162)
    MB_CASE(1, MB_MNX, 2, 4, __nv_bfloat162)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MB_CASE
}

// The slab-pair probe on `stream`: n threads (a multiple of RT_BLOCK), thread
// i on ray i % n_src; e_out receives each warp's e after `iters` iterations.
int mb_slab(const void* rows, const float* ox, const float* oy, const float* oz,
            const float* dx, const float* dy, const float* dz, int n_src, int bf16,
            int iters, int n, int* e_out, void* stream) {
  const RtRays rays{ox, oy, oz, dx, dy, dz};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* r = static_cast<const float4*>(rows);
  if (bf16)
    mb_slab_kernel<true><<<n / RT_BLOCK, RT_BLOCK, 0, st>>>(r, rays, n_src, iters, e_out);
  else
    mb_slab_kernel<false><<<n / RT_BLOCK, RT_BLOCK, 0, st>>>(r, rays, n_src, iters, e_out);
  return (int)cudaGetLastError();
}

}  // extern "C"

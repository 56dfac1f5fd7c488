// Row 15l of the microbench probes (microbench/cond.py): what does a
// data-dependent branch cost per loop iteration on the card?
//
// It replaces `_bench` of scripts/microbench_cond.py (:42, pallas_call :54)
// with the step shapes of its `main` (:88): each iteration runs `_body` (:80:
// 8 x a = min(a * 1.0001 + 0.1, max(a, 0.5)) on an (8, 128) tile, then e = e
// + 1 + (a[0, 0] < 0)) under
//   MB_STRAIGHT  no branch (s0);
//   MB_COND1     if (e % 2 == 0) body else body (s1);
//   MB_COND2     if (e % 2 == 0) { if (e % 3 == 0) body else body } else
//                { if (e % 3 == 0) body else body } (s2);
//   MB_SWITCH4   switch ((e % 2) * 2 + (e % 3 == 0)) over four bodies (sw);
// then e = |e| % 1024. A warp holds the tile, lane l its elements [32 l,
// 32 l + 32). Two cases of the branch (UNIFORM):
//   false  per thread: each thread's e follows its own a[32 l] (divergent);
//   true   warp-uniform: e follows the tile's a[0, 0], lane 0's first
//          element, as the script's packet-wide e.
// Each thread writes its e and the maximum of its 32 elements (the script's
// out[0, 0] is the tile's maximum + e).
//
// Trap 2, merged branches: the arms compute the same values, and a compiler
// would fold identical arms into straight-line code. Each arm reads its own
// constants (mul, add, lo of arm j, from the kernel's argument; the host
// passes equal values) and is fenced at both ends by an asm statement of
// its own, so no arm can be hoisted, sunk or merged into another; the SASS
// branch counts (microbench/sass.py) show the branches survive.
//
// Rounding: each multiply and add rounds on its own (__fmul_rn, __fadd_rn;
// -fmad=false), as the plain version's torch ops.
//
// What bounds it: 8 x 3 FP32 operations on 32 elements a thread per arm,
// 768 a thread and iteration; a divergent branch runs both arms.

#include "trace.cuh"

#define MB_COND_N 1024     // |e| % 1024 of the script
#define MB_COND_W 32       // elements a thread holds

enum MbCondShape { MB_STRAIGHT = 0, MB_COND1 = 1, MB_COND2 = 2, MB_SWITCH4 = 3 };

struct MbCondConsts {
  float mul[4], add[4], lo[4];   // arm j: a * mul + add, max(a, lo)
};

template <int J>
RT_FN void mbc_fence() {
  if constexpr (J == 0) asm volatile("// mb_cond arm 0");
  if constexpr (J == 1) asm volatile("// mb_cond arm 1");
  if constexpr (J == 2) asm volatile("// mb_cond arm 2");
  if constexpr (J == 3) asm volatile("// mb_cond arm 3");
}

// `_body` with arm J's constants: 8 rounds over the thread's elements, then
// e + 1 + (a00 < 0), a00 the thread's first element or lane 0's.
template <int J, bool UNIFORM>
RT_FN int mbc_body(float (&a)[MB_COND_W], int e, const MbCondConsts& c) {
  mbc_fence<J>();
  const float mul = c.mul[J], add = c.add[J], lo = c.lo[J];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int w = 0; w < MB_COND_W; ++w)
      a[w] = fminf(__fadd_rn(__fmul_rn(a[w], mul), add), fmaxf(a[w], lo));
  }
  const float a00 = UNIFORM ? __shfl_sync(RT_WARP, a[0], 0) : a[0];
  e = e + 1 + (a00 < 0.f ? 1 : 0);
  mbc_fence<J>();
  return e;
}

template <int SHAPE, bool UNIFORM>
__global__ void __launch_bounds__(RT_BLOCK)
mb_cond_kernel(const float* __restrict__ a0, MbCondConsts c, int iters, int* __restrict__ e_out,
               float* __restrict__ max_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float a[MB_COND_W];
#pragma unroll
  for (int w = 0; w < MB_COND_W; ++w) a[w] = a0[lane * MB_COND_W + w];
  int e = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if constexpr (SHAPE == MB_STRAIGHT) {
      e = mbc_body<0, UNIFORM>(a, e, c);
    } else if constexpr (SHAPE == MB_COND1) {
      if (e % 2 == 0) {
        e = mbc_body<0, UNIFORM>(a, e, c);
      } else {
        e = mbc_body<1, UNIFORM>(a, e, c);
      }
    } else if constexpr (SHAPE == MB_COND2) {
      if (e % 2 == 0) {
        if (e % 3 == 0) {
          e = mbc_body<0, UNIFORM>(a, e, c);
        } else {
          e = mbc_body<1, UNIFORM>(a, e, c);
        }
      } else {
        if (e % 3 == 0) {
          e = mbc_body<2, UNIFORM>(a, e, c);
        } else {
          e = mbc_body<3, UNIFORM>(a, e, c);
        }
      }
    } else {
      switch ((e % 2) * 2 + (e % 3 == 0 ? 1 : 0)) {
        case 0: e = mbc_body<0, UNIFORM>(a, e, c); break;
        case 1: e = mbc_body<1, UNIFORM>(a, e, c); break;
        case 2: e = mbc_body<2, UNIFORM>(a, e, c); break;
        default: e = mbc_body<3, UNIFORM>(a, e, c); break;
      }
    }
    e = abs(e) % MB_COND_N;
  }
  float m = a[0];
#pragma unroll
  for (int w = 1; w < MB_COND_W; ++w) m = fmaxf(m, a[w]);
  e_out[i] = e;
  max_out[i] = m;
}

namespace {

template <int SHAPE, bool UNIFORM>
int mb_cond_launch(const float* a0, const MbCondConsts& c, int iters, int n, int* e_out,
                   float* max_out, cudaStream_t st) {
  mb_cond_kernel<SHAPE, UNIFORM><<<n / RT_BLOCK, RT_BLOCK, 0, st>>>(a0, c, iters, e_out,
                                                                     max_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on `stream`: n threads (a multiple of RT_BLOCK), each warp on
// the (8, 128) tile a0 (device memory); consts, in host memory, holds the
// arms' (mul, add, lo), 3 x 4 floats, copied into the kernel's argument.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape past MB_SWITCH4.
int mb_cond(const float* a0, const float* consts, int shape, int uniform, int iters, int n,
            int* e_out, float* max_out, void* stream) {
  MbCondConsts c;
  for (int j = 0; j < 4; ++j) {
    c.mul[j] = consts[j];
    c.add[j] = consts[4 + j];
    c.lo[j] = consts[8 + j];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (shape * 2 + (uniform ? 1 : 0)) {
    case 0: return mb_cond_launch<MB_STRAIGHT, false>(a0, c, iters, n, e_out, max_out, st);
    case 1: return mb_cond_launch<MB_STRAIGHT, true>(a0, c, iters, n, e_out, max_out, st);
    case 2: return mb_cond_launch<MB_COND1, false>(a0, c, iters, n, e_out, max_out, st);
    case 3: return mb_cond_launch<MB_COND1, true>(a0, c, iters, n, e_out, max_out, st);
    case 4: return mb_cond_launch<MB_COND2, false>(a0, c, iters, n, e_out, max_out, st);
    case 5: return mb_cond_launch<MB_COND2, true>(a0, c, iters, n, e_out, max_out, st);
    case 6: return mb_cond_launch<MB_SWITCH4, false>(a0, c, iters, n, e_out, max_out, st);
    case 7: return mb_cond_launch<MB_SWITCH4, true>(a0, c, iters, n, e_out, max_out, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Definitions of the host launchers declared at the end of trace.cuh. Only
// the per-arity, per-format units (trace_a{2,4,8}.cu, trace_a{4,8}p.cu,
// trace_a2h.cu, the streamed trace_a{4,8}s.cu, trace_a{4,8}ps.cu, the MXU
// trace_a{4,8}m.cu, trace_a{4,8}pm.cu, and the DEEP tier's units of the
// same names with a `d` suffix) include this file, each instantiating the
// launchers, and with them the kernels, of its own arity, box format, leaf
// mode and stack tier, at the leaf size RT_UNIT_LEAF: _build.py compiles
// each unit once as it is (8) and once each with -DRT_UNIT_LEAF=4, 2 and 1,
// the MXU units with -DRT_UNIT_LEAF=4 only.

#pragma once

#include "trace.cuh"

#ifndef RT_UNIT_LEAF
#define RT_UNIT_LEAF RT_LEAF
#endif

namespace rt_detail {
inline int blocks_for(int n) { return (n + RT_BLOCK - 1) / RT_BLOCK; }
}  // namespace rt_detail

template <int A, RtBox F, bool S, bool D, bool M, int L>
int RtLaunch<A, F, S, D, M, L>::closest(const RtRays& rays, const RtScene& s, int n,
                                  const RtDeep& g, float* t, int* idx, int* nd,
                                  float* attr_out, unsigned long long* counts,
                                  cudaStream_t st) {
  const int b = rt_detail::blocks_for(n);
  if (attr_out != nullptr) {
    if (counts != nullptr) {
      closest_kernel<A, F, true, true, S, D, M, L><<<b, RT_BLOCK, 0, st>>>(
          rays, s, n, g, t, idx, nd, attr_out, counts);
    } else {
      closest_kernel<A, F, true, false, S, D, M, L><<<b, RT_BLOCK, 0, st>>>(
          rays, s, n, g, t, idx, nd, attr_out, counts);
    }
  } else if (counts != nullptr) {
    closest_kernel<A, F, false, true, S, D, M, L><<<b, RT_BLOCK, 0, st>>>(
        rays, s, n, g, t, idx, nd, attr_out, counts);
  } else {
    closest_kernel<A, F, false, false, S, D, M, L><<<b, RT_BLOCK, 0, st>>>(
        rays, s, n, g, t, idx, nd, attr_out, counts);
  }
  return (int)cudaGetLastError();
}

template <int A, RtBox F, bool S, bool D, bool M, int L>
int RtLaunch<A, F, S, D, M, L>::occluded(const RtRays& rays, const float* max_dist2,
                                   const RtScene& s, int n, const RtDeep& g,
                                   int* blocked, unsigned long long* counts,
                                   cudaStream_t st) {
  const int b = rt_detail::blocks_for(n);
  if (counts != nullptr) {
    occluded_kernel<A, F, true, S, D, M, L><<<b, RT_BLOCK, 0, st>>>(
        rays, max_dist2, s, n, g, blocked, counts);
  } else {
    occluded_kernel<A, F, false, S, D, M, L><<<b, RT_BLOCK, 0, st>>>(
        rays, max_dist2, s, n, g, blocked, counts);
  }
  return (int)cudaGetLastError();
}

namespace rt_detail {
// The frame kernel's dynamic shared memory: the light table and, with
// spheres, the sphere table.
inline size_t frame_smem(int nl, int ns) {
  return sizeof(float) * (8 * (size_t)(nl + 1) + 16 * (size_t)ns);
}

// One frame instance: above the default 48 KB of dynamic shared memory (a
// table of more than about 700 spheres) the kernel is allowed the bytes it
// asks for first; past the card's limit the launch is refused and the
// error is returned.
template <int A, RtBox F, bool C, bool SPH, bool D, bool M, int L, bool FWD>
int frame_launch(const RtRays& rays, const RtScene& s, const float* lamb,
                 int nl, const float* sph, int ns, int n, int bounces,
                 const RtDeep& g, float* col, unsigned long long* counts,
                 cudaStream_t st) {
  const size_t smem = frame_smem(nl, SPH ? ns : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(frame_kernel<A, F, C, SPH, D, M, L, FWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  frame_kernel<A, F, C, SPH, D, M, L, FWD><<<blocks_for(n), RT_BLOCK, smem, st>>>(
      rays, s, lamb, nl, sph, ns, n, bounces, g, col, counts);
  return (int)cudaGetLastError();
}

// One frame instance's resources: out[0] blocks per SM at its dynamic
// shared memory for nl lights and ns spheres
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers, out[2]
// local bytes per thread (the stack frame), out[3] dynamic shared bytes per
// block, out[4] static shared bytes.
template <int A, RtBox F, bool C, bool SPH, bool D, bool M, int L, bool FWD>
int frame_info(int nl, int ns, int* out) {
  auto k = frame_kernel<A, F, C, SPH, D, M, L, FWD>;
  const size_t smem = frame_smem(nl, SPH ? ns : 0);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes at;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, k);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, RT_BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  out[3] = (int)smem;
  out[4] = (int)at.sharedSizeBytes;
  return 0;
}

// The counting or timed instance, with spheres or without.
template <int A, RtBox F, bool D, bool M, int L, bool FWD>
int frame_pick(const RtRays& rays, const RtScene& s, const float* lamb, int nl,
               const float* sph, int ns, int n, int bounces, const RtDeep& g,
               float* col, unsigned long long* counts, cudaStream_t st) {
  if (ns > 0) {
    return counts != nullptr
        ? frame_launch<A, F, true, true, D, M, L, FWD>(rays, s, lamb, nl, sph, ns, n,
                                                      bounces, g, col, counts, st)
        : frame_launch<A, F, false, true, D, M, L, FWD>(rays, s, lamb, nl, sph, ns, n,
                                                       bounces, g, col, counts, st);
  }
  return counts != nullptr
      ? frame_launch<A, F, true, false, D, M, L, FWD>(rays, s, lamb, nl, sph, 0, n,
                                                     bounces, g, col, counts, st)
      : frame_launch<A, F, false, false, D, M, L, FWD>(rays, s, lamb, nl, sph, 0, n,
                                                      bounces, g, col, counts, st);
}
}  // namespace rt_detail

template <int A, RtBox F, bool D, bool M, int L>
int RtFrameLaunch<A, F, D, M, L>::info(int nl, int ns, int fwd, int* out) {
  using namespace rt_detail;
  if (ns > 0)
    return fwd != 0 ? frame_info<A, F, false, true, D, M, L, true>(nl, ns, out)
                    : frame_info<A, F, false, true, D, M, L, false>(nl, ns, out);
  return fwd != 0 ? frame_info<A, F, false, false, D, M, L, true>(nl, ns, out)
                  : frame_info<A, F, false, false, D, M, L, false>(nl, ns, out);
}

template <int A, RtBox F, bool D, bool M, int L>
int RtFrameLaunch<A, F, D, M, L>::frame(const RtRays& rays, const RtScene& s,
                                     const float* lamb, int num_lights,
                                     const float* sph, int ns, int n, int bounces,
                                     int fwd, const RtDeep& g, float* col,
                                     unsigned long long* counts, cudaStream_t st) {
  using namespace rt_detail;
  return fwd != 0
      ? frame_pick<A, F, D, M, L, true>(rays, s, lamb, num_lights, sph, ns, n, bounces,
                                        g, col, counts, st)
      : frame_pick<A, F, D, M, L, false>(rays, s, lamb, num_lights, sph, ns, n, bounces,
                                         g, col, counts, st);
}

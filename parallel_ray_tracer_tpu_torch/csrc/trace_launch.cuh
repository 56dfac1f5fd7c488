// Definitions of the host launchers declared at the end of trace.cuh. Only
// the per-arity, per-format units (trace_a{2,4,8}.cu, trace_a{4,8}p.cu,
// trace_a2h.cu, and the streamed trace_a{4,8}s.cu, trace_a{4,8}ps.cu)
// include this file, each instantiating the launchers, and with them the
// kernels, of its own arity, box format and leaf-row mode.

#pragma once

#include "trace.cuh"

namespace rt_detail {
inline int blocks_for(int n) { return (n + RT_BLOCK - 1) / RT_BLOCK; }
}  // namespace rt_detail

template <int A, RtBox F, bool S>
int RtLaunch<A, F, S>::closest(const RtRays& rays, const RtScene& s, int n,
                               float* t, int* idx, int* nd, float* attr_out,
                               unsigned long long* counts, cudaStream_t st) {
  const int g = rt_detail::blocks_for(n);
  if (attr_out != nullptr) {
    if (counts != nullptr) {
      closest_kernel<A, F, true, true, S><<<g, RT_BLOCK, 0, st>>>(
          rays, s, n, t, idx, nd, attr_out, counts);
    } else {
      closest_kernel<A, F, true, false, S><<<g, RT_BLOCK, 0, st>>>(
          rays, s, n, t, idx, nd, attr_out, counts);
    }
  } else if (counts != nullptr) {
    closest_kernel<A, F, false, true, S><<<g, RT_BLOCK, 0, st>>>(
        rays, s, n, t, idx, nd, attr_out, counts);
  } else {
    closest_kernel<A, F, false, false, S><<<g, RT_BLOCK, 0, st>>>(
        rays, s, n, t, idx, nd, attr_out, counts);
  }
  return (int)cudaGetLastError();
}

template <int A, RtBox F, bool S>
int RtLaunch<A, F, S>::occluded(const RtRays& rays, const float* max_dist2,
                                const RtScene& s, int n, int* blocked,
                                unsigned long long* counts, cudaStream_t st) {
  const int g = rt_detail::blocks_for(n);
  if (counts != nullptr) {
    occluded_kernel<A, F, true, S><<<g, RT_BLOCK, 0, st>>>(
        rays, max_dist2, s, n, blocked, counts);
  } else {
    occluded_kernel<A, F, false, S><<<g, RT_BLOCK, 0, st>>>(
        rays, max_dist2, s, n, blocked, counts);
  }
  return (int)cudaGetLastError();
}

template <int A, RtBox F>
int RtFrameLaunch<A, F>::frame(const RtRays& rays, const RtScene& s,
                               const float* lamb, int num_lights, int n,
                               int bounces, float* col,
                               unsigned long long* counts, cudaStream_t st) {
  const int g = rt_detail::blocks_for(n);
  const size_t smem = sizeof(float) * 8 * (size_t)(num_lights + 1);
  if (counts != nullptr) {
    frame_kernel<A, F, true><<<g, RT_BLOCK, smem, st>>>(
        rays, s, lamb, num_lights, n, bounces, col, counts);
  } else {
    frame_kernel<A, F, false><<<g, RT_BLOCK, smem, st>>>(
        rays, s, lamb, num_lights, n, bounces, col, counts);
  }
  return (int)cudaGetLastError();
}

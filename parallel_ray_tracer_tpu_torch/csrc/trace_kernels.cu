// Plain C entry points of the traversal kernels (csrc/trace.cuh), loaded by
// parallel_ray_tracer_tpu_torch/_build.py with ctypes.
//
// Each function launches one kernel on the given stream, does not
// synchronise and allocates nothing: the Python wrapper allocates the
// outputs. It returns cudaGetLastError() after the launch (0 on success).
// Ray planes are n floats each; attr_out / col_out hold 12 / 3 planes of n.
// With counts non-null the counting instance runs and adds RT_NCOUNTS
// sums (trace.cuh) into counts; with counts null the timed instance runs.

#include "trace.cuh"

namespace {

RtRays make_rays(const float* ox, const float* oy, const float* oz,
                 const float* dx, const float* dy, const float* dz) {
  RtRays r = {ox, oy, oz, dx, dy, dz};
  return r;
}

RtScene make_scene(const float* cbox, const int* cmeta, const float* tri,
                   const float* attr) {
  RtScene s = {reinterpret_cast<const float4*>(cbox),
               reinterpret_cast<const int4*>(cmeta),
               reinterpret_cast<const float4*>(tri), attr};
  return s;
}

int blocks_for(int n) { return (n + RT_BLOCK - 1) / RT_BLOCK; }

template <bool FULL>
void launch_closest(RtRays rays, RtScene s, int n, float* t, int* idx, int* nd,
                    float* attr_out, unsigned long long* counts,
                    cudaStream_t st) {
  if (counts != nullptr) {
    closest_kernel<FULL, true><<<blocks_for(n), RT_BLOCK, 0, st>>>(
        rays, s, n, t, idx, nd, attr_out, counts);
  } else {
    closest_kernel<FULL, false><<<blocks_for(n), RT_BLOCK, 0, st>>>(
        rays, s, n, t, idx, nd, attr_out, counts);
  }
}

}  // namespace

extern "C" {

int rt_closest(const float* ox, const float* oy, const float* oz,
               const float* dx, const float* dy, const float* dz,
               const float* cbox, const int* cmeta, const float* tri,
               const float* attr, int n, float* t, int* idx, int* nd,
               float* attr_out, unsigned long long* counts, void* stream) {
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (attr_out != nullptr) {
    launch_closest<true>(rays, s, n, t, idx, nd, attr_out, counts, st);
  } else {
    launch_closest<false>(rays, s, n, t, idx, nd, attr_out, counts, st);
  }
  return (int)cudaGetLastError();
}

int rt_occluded(const float* ox, const float* oy, const float* oz,
                const float* dx, const float* dy, const float* dz,
                const float* max_dist2, const float* cbox, const int* cmeta,
                const float* tri, int n, int* blocked,
                unsigned long long* counts, void* stream) {
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (counts != nullptr) {
    occluded_kernel<true><<<blocks_for(n), RT_BLOCK, 0, st>>>(
        rays, max_dist2, s, n, blocked, counts);
  } else {
    occluded_kernel<false><<<blocks_for(n), RT_BLOCK, 0, st>>>(
        rays, max_dist2, s, n, blocked, counts);
  }
  return (int)cudaGetLastError();
}

int rt_frame(const float* ox, const float* oy, const float* oz,
             const float* dx, const float* dy, const float* dz,
             const float* cbox, const int* cmeta, const float* tri,
             const float* attr, const float* lamb, int num_lights, int n,
             int bounces, float* col, unsigned long long* counts,
             void* stream) {
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem = sizeof(float) * 8 * (size_t)(num_lights + 1);
  if (counts != nullptr) {
    frame_kernel<true><<<blocks_for(n), RT_BLOCK, smem, st>>>(
        rays, s, lamb, num_lights, n, bounces, col, counts);
  } else {
    frame_kernel<false><<<blocks_for(n), RT_BLOCK, smem, st>>>(
        rays, s, lamb, num_lights, n, bounces, col, counts);
  }
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

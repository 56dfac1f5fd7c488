// Plain C entry points of the traversal kernels (csrc/trace.cuh), loaded by
// parallel_ray_tracer_tpu_torch/_build.py with ctypes.
//
// Each function launches one kernel on the given stream, does not
// synchronise and allocates nothing: the Python wrapper allocates the
// outputs. `arity` (2, 4 or 8; 4 or 8 for the frame) picks the instance for
// the node table's layout. It returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for an arity without instances.
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

const int kNoInstance = (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

int rt_closest(const float* ox, const float* oy, const float* oz,
               const float* dx, const float* dy, const float* dz,
               const float* cbox, const int* cmeta, const float* tri,
               const float* attr, int arity, int n, float* t, int* idx,
               int* nd, float* attr_out, unsigned long long* counts,
               void* stream) {
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (arity) {
    case 2: return RtLaunch<2>::closest(rays, s, n, t, idx, nd, attr_out, counts, st);
    case 4: return RtLaunch<4>::closest(rays, s, n, t, idx, nd, attr_out, counts, st);
    case 8: return RtLaunch<8>::closest(rays, s, n, t, idx, nd, attr_out, counts, st);
  }
  return kNoInstance;
}

int rt_occluded(const float* ox, const float* oy, const float* oz,
                const float* dx, const float* dy, const float* dz,
                const float* max_dist2, const float* cbox, const int* cmeta,
                const float* tri, int arity, int n, int* blocked,
                unsigned long long* counts, void* stream) {
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (arity) {
    case 2: return RtLaunch<2>::occluded(rays, max_dist2, s, n, blocked, counts, st);
    case 4: return RtLaunch<4>::occluded(rays, max_dist2, s, n, blocked, counts, st);
    case 8: return RtLaunch<8>::occluded(rays, max_dist2, s, n, blocked, counts, st);
  }
  return kNoInstance;
}

int rt_frame(const float* ox, const float* oy, const float* oz,
             const float* dx, const float* dy, const float* dz,
             const float* cbox, const int* cmeta, const float* tri,
             const float* attr, const float* lamb, int num_lights, int arity,
             int n, int bounces, float* col, unsigned long long* counts,
             void* stream) {
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (arity) {
    case 4:
      return RtFrameLaunch<4>::frame(rays, s, lamb, num_lights, n, bounces, col, counts, st);
    case 8:
      return RtFrameLaunch<8>::frame(rays, s, lamb, num_lights, n, bounces, col, counts, st);
  }
  return kNoInstance;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

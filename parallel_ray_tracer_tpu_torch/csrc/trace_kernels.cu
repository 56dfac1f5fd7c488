// Plain C entry points of the traversal kernels (csrc/trace.cuh), loaded by
// parallel_ray_tracer_tpu_torch/_build.py with ctypes.
//
// Each function launches one kernel on the given stream, does not
// synchronise and allocates nothing: the Python wrapper allocates the
// outputs. `arity` (2, 4 or 8; 4 or 8 for the frame) and `box` (RtBox:
// 0 f32, 1 bf16 pairs at arity 4 and 8, 2 raw bf16 at arity 2) pick the
// instance for the node table's layout, and `stream` (closest and any hit;
// arity 4 and 8, f32 or pairs) the instance with streamed leaf rows, whose
// tri and attr hold whole blocks of RT_STREAM_BLK rows. It returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an arity, format and mode without instances.
// Ray planes are n floats each; attr_out / col_out hold 12 / 3 planes of n.
// With counts non-null the counting instance runs and adds its sums into
// counts (RT_NCOUNTS with stream, the first RT_C_FILLS without; trace.cuh);
// with counts null the timed instance runs.

#include "trace.cuh"

namespace {

RtRays make_rays(const float* ox, const float* oy, const float* oz,
                 const float* dx, const float* dy, const float* dz) {
  RtRays r = {ox, oy, oz, dx, dy, dz};
  return r;
}

RtScene make_scene(const void* cbox, const int* cmeta, const float* tri,
                   const float* attr) {
  RtScene s = {reinterpret_cast<const uint4*>(cbox),
               reinterpret_cast<const int4*>(cmeta),
               reinterpret_cast<const float4*>(tri), attr};
  return s;
}

const int kNoInstance = (int)cudaErrorInvalidValue;

// The instance key of (arity, box format, leaf-row mode).
constexpr int key(int arity, int box, int stream = 0) {
  return 64 * stream + 16 * box + arity;
}

}  // namespace

extern "C" {

int rt_closest(const float* ox, const float* oy, const float* oz,
               const float* dx, const float* dy, const float* dz,
               const void* cbox, const int* cmeta, const float* tri,
               const float* attr, int arity, int box, int stream, int n,
               float* t, int* idx, int* nd, float* attr_out,
               unsigned long long* counts, void* cuda_stream) {
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, attr);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
#define RT_CLOSEST(A, F, S) \
  RtLaunch<A, F, S>::closest(rays, s, n, t, idx, nd, attr_out, counts, st)
  switch (key(arity, box, stream != 0)) {
    case key(2, RT_F32): return RT_CLOSEST(2, RT_F32, false);
    case key(4, RT_F32): return RT_CLOSEST(4, RT_F32, false);
    case key(8, RT_F32): return RT_CLOSEST(8, RT_F32, false);
    case key(4, RT_PAIRS): return RT_CLOSEST(4, RT_PAIRS, false);
    case key(8, RT_PAIRS): return RT_CLOSEST(8, RT_PAIRS, false);
    case key(2, RT_BF16): return RT_CLOSEST(2, RT_BF16, false);
    case key(4, RT_F32, 1): return RT_CLOSEST(4, RT_F32, true);
    case key(8, RT_F32, 1): return RT_CLOSEST(8, RT_F32, true);
    case key(4, RT_PAIRS, 1): return RT_CLOSEST(4, RT_PAIRS, true);
    case key(8, RT_PAIRS, 1): return RT_CLOSEST(8, RT_PAIRS, true);
  }
#undef RT_CLOSEST
  return kNoInstance;
}

int rt_occluded(const float* ox, const float* oy, const float* oz,
                const float* dx, const float* dy, const float* dz,
                const float* max_dist2, const void* cbox, const int* cmeta,
                const float* tri, int arity, int box, int stream, int n,
                int* blocked, unsigned long long* counts, void* cuda_stream) {
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
#define RT_OCCLUDED(A, F, S) \
  RtLaunch<A, F, S>::occluded(rays, max_dist2, s, n, blocked, counts, st)
  switch (key(arity, box, stream != 0)) {
    case key(2, RT_F32): return RT_OCCLUDED(2, RT_F32, false);
    case key(4, RT_F32): return RT_OCCLUDED(4, RT_F32, false);
    case key(8, RT_F32): return RT_OCCLUDED(8, RT_F32, false);
    case key(4, RT_PAIRS): return RT_OCCLUDED(4, RT_PAIRS, false);
    case key(8, RT_PAIRS): return RT_OCCLUDED(8, RT_PAIRS, false);
    case key(2, RT_BF16): return RT_OCCLUDED(2, RT_BF16, false);
    case key(4, RT_F32, 1): return RT_OCCLUDED(4, RT_F32, true);
    case key(8, RT_F32, 1): return RT_OCCLUDED(8, RT_F32, true);
    case key(4, RT_PAIRS, 1): return RT_OCCLUDED(4, RT_PAIRS, true);
    case key(8, RT_PAIRS, 1): return RT_OCCLUDED(8, RT_PAIRS, true);
  }
#undef RT_OCCLUDED
  return kNoInstance;
}

int rt_frame(const float* ox, const float* oy, const float* oz,
             const float* dx, const float* dy, const float* dz,
             const void* cbox, const int* cmeta, const float* tri,
             const float* attr, const float* lamb, int num_lights, int arity,
             int box, int n, int bounces, float* col,
             unsigned long long* counts, void* stream) {
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_FRAME(A, F) \
  RtFrameLaunch<A, F>::frame(rays, s, lamb, num_lights, n, bounces, col, counts, st)
  switch (key(arity, box)) {
    case key(4, RT_F32): return RT_FRAME(4, RT_F32);
    case key(8, RT_F32): return RT_FRAME(8, RT_F32);
    case key(4, RT_PAIRS): return RT_FRAME(4, RT_PAIRS);
    case key(8, RT_PAIRS): return RT_FRAME(8, RT_PAIRS);
  }
#undef RT_FRAME
  return kNoInstance;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

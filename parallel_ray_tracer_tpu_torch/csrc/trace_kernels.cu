// Plain C entry points of the traversal kernels (csrc/trace.cuh), loaded by
// parallel_ray_tracer_tpu_torch/_build.py with ctypes.
//
// Each function launches one kernel on the given stream, does not
// synchronise and allocates nothing: the Python wrapper allocates the
// outputs and the DEEP tier's stack. `arity` (2, 4 or 8; 4 or 8 for the
// frame) and `box` (RtBox: 0 f32, 1 bf16 pairs at arity 4 and 8, 2 raw bf16
// at arity 2) pick the instance for the node table's layout, and `stream`
// (closest and any hit; arity 4 and 8, f32 or pairs) the instance with
// streamed leaf rows, whose tri and attr hold whole blocks of
// RT_STREAM_BLK rows. A non-null cmat picks the MXU instance (arity 4 and
// 8, f32 or pairs, not streamed): the C-matrix table as bf16 values, rows
// of cmat_pitch values (32: [hi | lo] of one group's row; 128: four
// groups' rows, pack_cmi4). A non-null stk_ent picks the DEEP stack tier: stk_ent
// and stk_dst then hold need * n entries each (entry k of ray i at
// k * n + i), need >= the tree's ops/pack.stack_need. `leaf` (8, 4, 2 or 1;
// the MXU instances 8 or 4) picks the instances of that many triangles per
// leaf group. The frame takes the
// sphere instance when ns > 0 (sph: ns rows of 16 floats), and traces
// shadow rays from the hit point to the light when fwd != 0 (else from the
// light). It returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an arity, format, mode and leaf size without
// instances.
// rt_frame_info writes the occupancy and resources of the timed frame
// instance of (arity, box, leaf, deep, mxu, fwd, ns > 0), at the dynamic
// shared memory of num_lights lights and ns
// spheres: blocks per SM, registers, local bytes per thread, dynamic and
// static shared bytes per block (RtFrameLaunch::info).
// Ray planes are n floats each; attr_out / col_out hold 12 / 3 planes of n.
// With counts non-null the counting instance runs and adds its sums into
// counts (RT_NCOUNTS with stream or cmat, the first RT_C_FILLS without;
// trace.cuh);
// with counts null the timed instance runs.
// Each launch goes to the card that holds the rays (use_device_of): this
// library's CUDA runtime keeps its own current device, 0 until set, so a
// launch for another card of a mesh must make that card current first.

#include "trace.cuh"

namespace {

RtRays make_rays(const float* ox, const float* oy, const float* oz,
                 const float* dx, const float* dy, const float* dz) {
  RtRays r = {ox, oy, oz, dx, dy, dz};
  return r;
}

RtScene make_scene(const void* cbox, const int* cmeta, const float* tri,
                   const float* attr, const void* cmat, int cmat_pitch) {
  RtScene s = {reinterpret_cast<const uint4*>(cbox),
               reinterpret_cast<const int4*>(cmeta),
               reinterpret_cast<const float4*>(tri), attr,
               reinterpret_cast<const unsigned*>(cmat), cmat_pitch};
  return s;
}

RtDeep make_deep(int* ent, float* dst, int n) {
  RtDeep g = {ent, dst, (unsigned)n};
  return g;
}

const int kNoInstance = (int)cudaErrorInvalidValue;

// Make the card that holds the device pointer p current for this thread.
cudaError_t use_device_of(const void* p) {
  cudaPointerAttributes a;
  cudaError_t e = cudaPointerGetAttributes(&a, p);
  if (e != cudaSuccess) return e;
  int cur = -1;
  e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return a.device == cur ? cudaSuccess : cudaSetDevice(a.device);
}

// The instance key of (arity, box format, leaf-row mode, stack tier, leaf
// test), at one leaf size.
constexpr int key(int arity, int box, int stream = 0, int deep = 0, int mxu = 0) {
  return 256 * mxu + 128 * deep + 64 * stream + 16 * box + arity;
}

}  // namespace

// The cases of one launcher over the FP32 leaf's instances of both stack
// tiers, at leaf size L (every size of _build.LEAF_SIZES).
#define RT_CASES_FP32(X, L)                                                      \
  case key(2, RT_F32): return X(2, RT_F32, false, false, false, L);              \
  case key(4, RT_F32): return X(4, RT_F32, false, false, false, L);              \
  case key(8, RT_F32): return X(8, RT_F32, false, false, false, L);              \
  case key(4, RT_PAIRS): return X(4, RT_PAIRS, false, false, false, L);          \
  case key(8, RT_PAIRS): return X(8, RT_PAIRS, false, false, false, L);          \
  case key(2, RT_BF16): return X(2, RT_BF16, false, false, false, L);            \
  case key(4, RT_F32, 1): return X(4, RT_F32, true, false, false, L);            \
  case key(8, RT_F32, 1): return X(8, RT_F32, true, false, false, L);            \
  case key(4, RT_PAIRS, 1): return X(4, RT_PAIRS, true, false, false, L);        \
  case key(8, RT_PAIRS, 1): return X(8, RT_PAIRS, true, false, false, L);        \
  case key(2, RT_F32, 0, 1): return X(2, RT_F32, false, true, false, L);         \
  case key(4, RT_F32, 0, 1): return X(4, RT_F32, false, true, false, L);         \
  case key(8, RT_F32, 0, 1): return X(8, RT_F32, false, true, false, L);         \
  case key(4, RT_PAIRS, 0, 1): return X(4, RT_PAIRS, false, true, false, L);     \
  case key(8, RT_PAIRS, 0, 1): return X(8, RT_PAIRS, false, true, false, L);     \
  case key(2, RT_BF16, 0, 1): return X(2, RT_BF16, false, true, false, L);       \
  case key(4, RT_F32, 1, 1): return X(4, RT_F32, true, true, false, L);          \
  case key(8, RT_F32, 1, 1): return X(8, RT_F32, true, true, false, L);          \
  case key(4, RT_PAIRS, 1, 1): return X(4, RT_PAIRS, true, true, false, L);      \
  case key(8, RT_PAIRS, 1, 1): return X(8, RT_PAIRS, true, true, false, L);

// The MXU leaf's instances of both stack tiers, at leaf size L = 8 or 4
// only (_build.MXU_LEAF_SIZES): at L = 1 and 2 no MXU symbol is referenced.
#define RT_CASES_MXU(X, L)                                                       \
  case key(4, RT_F32, 0, 0, 1): return X(4, RT_F32, false, false, true, L);      \
  case key(4, RT_PAIRS, 0, 0, 1): return X(4, RT_PAIRS, false, false, true, L);  \
  case key(8, RT_F32, 0, 0, 1): return X(8, RT_F32, false, false, true, L);      \
  case key(8, RT_PAIRS, 0, 0, 1): return X(8, RT_PAIRS, false, false, true, L);  \
  case key(4, RT_F32, 0, 1, 1): return X(4, RT_F32, false, true, true, L);       \
  case key(4, RT_PAIRS, 0, 1, 1): return X(4, RT_PAIRS, false, true, true, L);   \
  case key(8, RT_F32, 0, 1, 1): return X(8, RT_F32, false, true, true, L);       \
  case key(8, RT_PAIRS, 0, 1, 1): return X(8, RT_PAIRS, false, true, true, L);

// One launcher's switch over the leaf sizes: every instance at L = 8 and 4,
// the FP32 ones at L = 2 and 1.
#define RT_DISPATCH(X, FP32, MXU)                      \
  switch (leaf) {                                      \
    case 8: switch (k) { FP32(X, 8) MXU(X, 8) } break; \
    case 4: switch (k) { FP32(X, 4) MXU(X, 4) } break; \
    case 2: switch (k) { FP32(X, 2) } break;           \
    case 1: switch (k) { FP32(X, 1) } break;           \
  }

// The frame kernel's instances of both stack tiers, FP32 and MXU leaf.
#define RT_FRAME_FP32(X, L)                                                      \
  case key(4, RT_F32): return X(4, RT_F32, false, false, L);                     \
  case key(8, RT_F32): return X(8, RT_F32, false, false, L);                     \
  case key(4, RT_PAIRS): return X(4, RT_PAIRS, false, false, L);                 \
  case key(8, RT_PAIRS): return X(8, RT_PAIRS, false, false, L);                 \
  case key(4, RT_F32, 0, 1): return X(4, RT_F32, true, false, L);                \
  case key(8, RT_F32, 0, 1): return X(8, RT_F32, true, false, L);                \
  case key(4, RT_PAIRS, 0, 1): return X(4, RT_PAIRS, true, false, L);            \
  case key(8, RT_PAIRS, 0, 1): return X(8, RT_PAIRS, true, false, L);
#define RT_FRAME_MXU(X, L)                                                       \
  case key(4, RT_F32, 0, 0, 1): return X(4, RT_F32, false, true, L);             \
  case key(8, RT_F32, 0, 0, 1): return X(8, RT_F32, false, true, L);             \
  case key(4, RT_PAIRS, 0, 0, 1): return X(4, RT_PAIRS, false, true, L);         \
  case key(8, RT_PAIRS, 0, 0, 1): return X(8, RT_PAIRS, false, true, L);         \
  case key(4, RT_F32, 0, 1, 1): return X(4, RT_F32, true, true, L);              \
  case key(8, RT_F32, 0, 1, 1): return X(8, RT_F32, true, true, L);              \
  case key(4, RT_PAIRS, 0, 1, 1): return X(4, RT_PAIRS, true, true, L);          \
  case key(8, RT_PAIRS, 0, 1, 1): return X(8, RT_PAIRS, true, true, L);

extern "C" {

int rt_closest(const float* ox, const float* oy, const float* oz,
               const float* dx, const float* dy, const float* dz,
               const void* cbox, const int* cmeta, const float* tri,
               const float* attr, const void* cmat, int arity, int box,
               int stream, int cmat_pitch, int leaf, int n, int* stk_ent,
               float* stk_dst, float* t, int* idx, int* nd, float* attr_out,
               unsigned long long* counts, void* cuda_stream) {
  if (cudaError_t e = use_device_of(ox)) return (int)e;
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, attr, cmat, cmat_pitch);
  RtDeep g = make_deep(stk_ent, stk_dst, n);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
#define RT_CLOSEST(A, F, S, D, M, L) \
  RtLaunch<A, F, S, D, M, L>::closest(rays, s, n, g, t, idx, nd, attr_out, counts, st)
  const int k = key(arity, box, stream != 0, stk_ent != nullptr, cmat != nullptr);
  RT_DISPATCH(RT_CLOSEST, RT_CASES_FP32, RT_CASES_MXU)
#undef RT_CLOSEST
  return kNoInstance;
}

int rt_occluded(const float* ox, const float* oy, const float* oz,
                const float* dx, const float* dy, const float* dz,
                const float* max_dist2, const void* cbox, const int* cmeta,
                const float* tri, const void* cmat, int arity, int box,
                int stream, int cmat_pitch, int leaf, int n, int* stk_ent,
                float* stk_dst, int* blocked, unsigned long long* counts,
                void* cuda_stream) {
  if (cudaError_t e = use_device_of(ox)) return (int)e;
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, nullptr, cmat, cmat_pitch);
  RtDeep g = make_deep(stk_ent, stk_dst, n);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
#define RT_OCCLUDED(A, F, S, D, M, L) \
  RtLaunch<A, F, S, D, M, L>::occluded(rays, max_dist2, s, n, g, blocked, counts, st)
  const int k = key(arity, box, stream != 0, stk_ent != nullptr, cmat != nullptr);
  RT_DISPATCH(RT_OCCLUDED, RT_CASES_FP32, RT_CASES_MXU)
#undef RT_OCCLUDED
  return kNoInstance;
}

int rt_frame(const float* ox, const float* oy, const float* oz,
             const float* dx, const float* dy, const float* dz,
             const void* cbox, const int* cmeta, const float* tri,
             const float* attr, const void* cmat, const float* lamb,
             int num_lights, const float* sph, int ns, int arity, int box,
             int cmat_pitch, int leaf, int n, int bounces, int fwd, int* stk_ent,
             float* stk_dst, float* col, unsigned long long* counts, void* stream) {
  if (cudaError_t e = use_device_of(ox)) return (int)e;
  RtRays rays = make_rays(ox, oy, oz, dx, dy, dz);
  RtScene s = make_scene(cbox, cmeta, tri, attr, cmat, cmat_pitch);
  RtDeep g = make_deep(stk_ent, stk_dst, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_FRAME(A, F, D, M, L)                                                    \
  RtFrameLaunch<A, F, D, M, L>::frame(rays, s, lamb, num_lights, sph, ns, n,       \
                                      bounces, fwd, g, col, counts, st)
  const int k = key(arity, box, 0, stk_ent != nullptr, cmat != nullptr);
  RT_DISPATCH(RT_FRAME, RT_FRAME_FP32, RT_FRAME_MXU)
#undef RT_FRAME
  return kNoInstance;
}

int rt_frame_info(int arity, int box, int leaf, int deep, int mxu, int num_lights, int ns,
                  int fwd, int* out) {
#define RT_INFO(A, F, D, M, L) RtFrameLaunch<A, F, D, M, L>::info(num_lights, ns, fwd, out)
  const int k = key(arity, box, 0, deep != 0, mxu != 0);
  RT_DISPATCH(RT_INFO, RT_FRAME_FP32, RT_FRAME_MXU)
#undef RT_INFO
  return kNoInstance;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

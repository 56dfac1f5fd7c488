// Row 15i: the instances of mb_inner_kernel (csrc/microbench_inner.cuh) for
// the bodies of scripts/microbench_inner.py, and their C entry points.
//
// Each body at P = 1 and P = 32 in blocks of 128 threads with a local stack
// and __ldg meta (Lf2, Lf4: P = 32 only); G also with its stack in shared
// memory; E and I with their meta_flat table in shared memory in blocks of
// 1,024, each beside its global-memory twin at the same block size.

#include "microbench_inner.cuh"

namespace {

int mbi_inner_dispatch(const MbInnerArgs& p, int key, int n, int smem, cudaStream_t st,
                       int* occ) {
  switch (key) {
#define MBI_BOTH(BODY, NPOP)                              \
  MBI_CASE(BODY, NPOP, 1, MB_LOCAL, MB_GLOBAL, 128)       \
  MBI_CASE(BODY, NPOP, 32, MB_LOCAL, MB_GLOBAL, 128)
    MBI_BOTH(MB_A, 1)
    MBI_BOTH(MB_B, 1)
    MBI_BOTH(MB_C, 1)
    MBI_BOTH(MB_D, 1)
    MBI_BOTH(MB_F, 1)
    MBI_BOTH(MB_G, 1)
    MBI_BOTH(MB_H, 1)
    MBI_BOTH(MB_J, 1)
    MBI_BOTH(MB_K, 1)
    MBI_BOTH(MB_N, 1)
    MBI_BOTH(MB_M, 1)
    MBI_BOTH(MB_M2, 1)
    MBI_BOTH(MB_MQ, 4)
    MBI_BOTH(MB_MQ, 8)
#undef MBI_BOTH
    MBI_CASE(MB_G, 1, 1, MB_SHARED, MB_GLOBAL, 128)
    MBI_CASE(MB_G, 1, 32, MB_SHARED, MB_GLOBAL, 128)
    MBI_CASE(MB_E, 1, 1, MB_LOCAL, MB_SHARED, 1024)
    MBI_CASE(MB_E, 1, 32, MB_LOCAL, MB_SHARED, 1024)
    MBI_CASE(MB_E, 1, 1, MB_LOCAL, MB_GLOBAL, 1024)
    MBI_CASE(MB_E, 1, 32, MB_LOCAL, MB_GLOBAL, 1024)
    MBI_CASE(MB_I, 1, 1, MB_LOCAL, MB_SHARED, 1024)
    MBI_CASE(MB_I, 1, 32, MB_LOCAL, MB_SHARED, 1024)
    MBI_CASE(MB_I, 1, 1, MB_LOCAL, MB_GLOBAL, 1024)
    MBI_CASE(MB_I, 1, 32, MB_LOCAL, MB_GLOBAL, 1024)
    MBI_CASE(MB_LF, 2, 32, MB_LOCAL, MB_GLOBAL, 128)
    MBI_CASE(MB_LF, 4, 32, MB_LOCAL, MB_GLOBAL, 128)
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch of a row-15i instance on `stream` (no synchronisation, no
// allocation): n threads (a multiple of `block`) over the n_src rays, `smem`
// bytes of dynamic shared memory (the meta table, the stack columns, and
// any bytes that only match a twin's occupancy). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an instance not built.
int mb_inner(const float* ox, const float* oy, const float* oz, const float* dx,
             const float* dy, const float* dz, int n_src, const void* cbox, const void* cmeta,
             const int* mtab, int mtab_ints, const void* cmi, const float* rmat, int body,
             int npop, int packet, int sp, int ms, int block, int smem, int iters, int n,
             int* e_out, float* acc_out, int* top_out, void* stream) {
  const MbInnerArgs p{RtRays{ox, oy, oz, dx, dy, dz}, n_src,
                      static_cast<const uint4*>(cbox), static_cast<const int4*>(cmeta),
                      mtab, mtab_ints, static_cast<const unsigned*>(cmi), rmat, iters,
                      e_out, acc_out, top_out};
  return mbi_inner_dispatch(p, mbi_inst(body, npop, packet, sp, ms, block), n, smem,
                            static_cast<cudaStream_t>(stream), nullptr);
}

// Resident blocks per SM of an instance at `smem` bytes of dynamic shared
// memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks.
int mb_inner_occupancy(int body, int npop, int packet, int sp, int ms, int block, int smem,
                       int* blocks) {
  const MbInnerArgs p{};
  return mbi_inner_dispatch(p, mbi_inst(body, npop, packet, sp, ms, block), 0, smem, nullptr,
                            blocks);
}

}  // extern "C"

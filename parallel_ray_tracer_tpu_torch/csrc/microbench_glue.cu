// Row 15j: the instances of mb_inner_kernel (csrc/microbench_inner.cuh) for
// the bodies of scripts/microbench_glue.py, and their C entry points.
//
// Each of the 14 bodies at npop 4 and 8, P = 1 and P = 32, in blocks of 128
// threads with local stacks and __ldg meta; full_xs and xb read their meta_s
// table from shared memory in blocks of 1,024, each beside its global-memory
// twin at the same block size; full also with its two stacks in shared
// memory. A unit of its own, so that nvcc builds it beside row 15i's.

#include "microbench_inner.cuh"

namespace {

int mbi_glue_dispatch(const MbInnerArgs& p, int key, int n, int smem, cudaStream_t st,
                      int* occ) {
  switch (key) {
#define MBI_GLUE(BODY, NPOP)                              \
  MBI_CASE(BODY, NPOP, 1, MB_LOCAL, MB_GLOBAL, 128)       \
  MBI_CASE(BODY, NPOP, 32, MB_LOCAL, MB_GLOBAL, 128)
#define MBI_GLUE_SMEM(BODY, NPOP)                         \
  MBI_CASE(BODY, NPOP, 1, MB_LOCAL, MB_SHARED, 1024)      \
  MBI_CASE(BODY, NPOP, 32, MB_LOCAL, MB_SHARED, 1024)     \
  MBI_CASE(BODY, NPOP, 1, MB_LOCAL, MB_GLOBAL, 1024)      \
  MBI_CASE(BODY, NPOP, 32, MB_LOCAL, MB_GLOBAL, 1024)
#define MBI_GLUE_NPOP(NPOP)                               \
  MBI_GLUE(MB_GL_FULL, NPOP)                              \
  MBI_GLUE(MB_GL_NOSORT, NPOP)                            \
  MBI_GLUE(MB_GL_NOPUSH, NPOP)                            \
  MBI_GLUE(MB_GL_NOPUSH1, NPOP)                           \
  MBI_GLUE(MB_GL_NOEXTRACT, NPOP)                         \
  MBI_GLUE(MB_GL_VEC, NPOP)                               \
  MBI_GLUE(MB_GL_SEL1, NPOP)                              \
  MBI_GLUE(MB_GL_RANKSEL, NPOP)                           \
  MBI_GLUE(MB_GL_RANKDUAL, NPOP)                          \
  MBI_GLUE(MB_GL_FULL_X2, NPOP)                           \
  MBI_GLUE(MB_GL_X2_ONLY, NPOP)                           \
  MBI_GLUE(MB_GL_FULL_X4, NPOP)                           \
  MBI_GLUE_SMEM(MB_GL_FULL_XS, NPOP)                      \
  MBI_GLUE_SMEM(MB_GL_XB, NPOP)                           \
  MBI_CASE(MB_GL_FULL, NPOP, 1, MB_SHARED, MB_GLOBAL, 128) \
  MBI_CASE(MB_GL_FULL, NPOP, 32, MB_SHARED, MB_GLOBAL, 128)
    MBI_GLUE_NPOP(4)
    MBI_GLUE_NPOP(8)
#undef MBI_GLUE_NPOP
#undef MBI_GLUE_SMEM
#undef MBI_GLUE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch of a row-15j instance: the arguments of mb_inner
// (microbench_inner.cu).
int mb_glue(const float* ox, const float* oy, const float* oz, const float* dx,
            const float* dy, const float* dz, int n_src, const void* cbox, const void* cmeta,
            const int* mtab, int mtab_ints, const void* cmi, const float* rmat, int body,
            int npop, int packet, int sp, int ms, int block, int smem, int iters, int n,
            int* e_out, float* acc_out, int* top_out, void* stream) {
  const MbInnerArgs p{RtRays{ox, oy, oz, dx, dy, dz}, n_src,
                      static_cast<const uint4*>(cbox), static_cast<const int4*>(cmeta),
                      mtab, mtab_ints, static_cast<const unsigned*>(cmi), rmat, iters,
                      e_out, acc_out, top_out};
  return mbi_glue_dispatch(p, mbi_inst(body, npop, packet, sp, ms, block), n, smem,
                           static_cast<cudaStream_t>(stream), nullptr);
}

int mb_glue_occupancy(int body, int npop, int packet, int sp, int ms, int block, int smem,
                      int* blocks) {
  const MbInnerArgs p{};
  return mbi_glue_dispatch(p, mbi_inst(body, npop, packet, sp, ms, block), 0, smem, nullptr,
                           blocks);
}

}  // extern "C"

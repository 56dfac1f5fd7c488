// Kernels B and C of the microbench probes (microbench/probes.py): where a
// leaf group's rows can live on the card.
//
// B, mb_stage_kernel, replaces `probe_pad` (scripts/microbench_mxu_leaf.py
// :513, pallas_call :523), which asked whether a (92160, 16) f32 VMEM input
// compiles under a given limit, that is, whether Mosaic pads its 16 lanes to
// 128. Shared memory is the card's counterpart of a block's VMEM. The
// kernel stages a table of `bytes` (C rows of leaf groups: (N, 16) f32 or
// (N, 32) bf16, 2 KB a group either way, no padding) in dynamic shared
// memory and reads every staged word back out. Above the default 48 KB a
// block must be allowed the bytes first (cudaFuncSetAttribute); past the
// card's opt-in limit (sharedMemPerBlockOptin) both that call and the
// launch are refused, and the entry point returns each one's cudaError so
// the probe records where the limit lies. What bounds it: one block copies
// the bytes in and out at the rate one SM reaches, far below the card's.
//
// C, mb_gather_kernel, replaces `probe_ceiling` (:544, pallas_call :554),
// which asked how large a resident (N, 128) f32 input may grow. On the card
// the question is where a table stops being served by the 50 MB L2: each
// warp chases a chain of 2 KB blocks (the streamed leaf block of
// csrc/trace.cuh, RT_STREAM_BLK groups of tri rows) through a table of
// random words, reading each block whole (four 16-byte loads a lane,
// coalesced) and taking the next block's index from the block's word 0, so
// every load waits for the one before it. It sums every word it reads
// (wrapping 32-bit sums) so nothing is dead, and writes each warp's last
// block and sum. What bounds it: the L2 (table within it) or device memory
// (beyond it), each 2 KB block a dependent access; many warps in flight
// hide the latency, so the time per block falls toward bytes over the rate.

#include "trace.cuh"

#define MB_BLOCK_WORDS 512  // 32-bit words per 2 KB block

__global__ void mb_stage_kernel(const uint4* src, int n16, uint4* out) {
  extern __shared__ uint4 mb_staged[];
  for (int k = threadIdx.x; k < n16; k += blockDim.x) mb_staged[k] = src[k];
  __syncthreads();
  for (int k = threadIdx.x; k < n16; k += blockDim.x) out[k] = mb_staged[k];
}

__global__ void __launch_bounds__(RT_BLOCK)
mb_gather_kernel(const uint4* table, int steps, int n_warps, const int* start,
                 int* last_out, unsigned* sum_out) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_warps) return;  // whole warps: the grid holds n_warps * 32 threads
  int b = start[w];
  unsigned s = 0u;
  for (int k = 0; k < steps; ++k) {
    const uint4* blk = table + (size_t)b * (MB_BLOCK_WORDS / 4);
    const uint4 x0 = __ldg(blk + lane);
    const uint4 x1 = __ldg(blk + 32 + lane);
    const uint4 x2 = __ldg(blk + 64 + lane);
    const uint4 x3 = __ldg(blk + 96 + lane);
    s += x0.x + x0.y + x0.z + x0.w + x1.x + x1.y + x1.z + x1.w;
    s += x2.x + x2.y + x2.z + x2.w + x3.x + x3.y + x3.z + x3.w;
    b = __shfl_sync(RT_WARP, (int)x0.x, 0);  // word 0 of the block: the next
  }
  s = __reduce_add_sync(RT_WARP, s);
  if (lane == 0) {
    last_out[w] = b;
    sum_out[w] = s;
  }
}

extern "C" {

// Stages `bytes` (a multiple of 16) of src in one block's dynamic shared
// memory and copies them to out, on `stream`. *attr_rc receives the
// cudaError of cudaFuncSetAttribute(MaxDynamicSharedMemorySize, bytes); the
// launch is attempted either way, and its cudaGetLastError() is returned
// (0: it launched). Both errors are non-sticky.
int mb_stage(const void* src, int bytes, void* out, int* attr_rc, void* stream) {
  *attr_rc = (int)cudaFuncSetAttribute(mb_stage_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaGetLastError();
  mb_stage_kernel<<<1, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), bytes / 16, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// The card's opt-in limit of dynamic shared memory per block, in bytes.
int mb_smem_optin(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// n_warps chains of `steps` dependent 2 KB blocks through `table` (blocks
// of MB_BLOCK_WORDS words, word 0 the next block's index), warp w from block
// start[w]; writes each warp's last block and wrapping word sum.
int mb_gather(const void* table, int steps, int n_warps, const int* start,
              int* last_out, unsigned* sum_out, void* stream) {
  const int blocks = (n_warps * 32 + RT_BLOCK - 1) / RT_BLOCK;
  mb_gather_kernel<<<blocks, RT_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), steps, n_warps, start, last_out, sum_out);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Arity-4 instances of the traversal kernels (csrc/trace.cuh),
// the DEEP stack tier (a global stack sized to the tree), bf16 pair rows.

#include "trace_launch.cuh"

template struct RtLaunch<4, RT_PAIRS, false, true, false, RT_UNIT_LEAF>;
template struct RtFrameLaunch<4, RT_PAIRS, true, false, RT_UNIT_LEAF>;

// Arity-2 instances of the traversal kernels (csrc/trace.cuh),
// the DEEP stack tier (a global stack sized to the tree), f32 boxes.

#include "trace_launch.cuh"

template struct RtLaunch<2, RT_F32, false, true, false, RT_UNIT_LEAF>;

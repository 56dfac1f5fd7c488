// Arity-4 instances of the traversal kernels (csrc/trace.cuh) with streamed
// leaf rows, the DEEP stack tier (a global stack sized to the tree),
// f32 boxes.

#include "trace_launch.cuh"

template struct RtLaunch<4, RT_F32, true, true, false, RT_UNIT_LEAF>;

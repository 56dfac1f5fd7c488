// Arity-4 instances of the traversal kernels (csrc/trace.cuh) with the MXU
// leaf, f32 boxes.

#include "trace_launch.cuh"

template struct RtLaunch<4, RT_F32, false, false, true, RT_UNIT_LEAF>;
template struct RtFrameLaunch<4, RT_F32, false, true, RT_UNIT_LEAF>;

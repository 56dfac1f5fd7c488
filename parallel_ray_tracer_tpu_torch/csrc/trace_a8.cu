// Arity-8 instances of the traversal kernels (csrc/trace.cuh), f32 boxes.

#include "trace_launch.cuh"

template struct RtLaunch<8, RT_F32, false, false>;
template struct RtFrameLaunch<8, RT_F32, false>;

// Arity-4 instances of the traversal kernels (csrc/trace.cuh).

#include "trace_launch.cuh"

template struct RtLaunch<4>;
template struct RtFrameLaunch<4>;

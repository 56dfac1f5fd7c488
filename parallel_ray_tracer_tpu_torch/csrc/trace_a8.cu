// Arity-8 instances of the traversal kernels (csrc/trace.cuh).

#include "trace_launch.cuh"

template struct RtLaunch<8>;
template struct RtFrameLaunch<8>;

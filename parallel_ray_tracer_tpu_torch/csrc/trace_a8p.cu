// Arity-8 instances of the traversal kernels (csrc/trace.cuh), bf16 pair rows.

#include "trace_launch.cuh"

template struct RtLaunch<8, RT_PAIRS, false, false, false, RT_UNIT_LEAF>;
template struct RtFrameLaunch<8, RT_PAIRS, false, false, RT_UNIT_LEAF>;

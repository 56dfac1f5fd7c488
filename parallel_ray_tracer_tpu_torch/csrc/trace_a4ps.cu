// Arity-4 instances of the traversal kernels (csrc/trace.cuh) with streamed
// leaf rows, bf16 pair rows.

#include "trace_launch.cuh"

template struct RtLaunch<4, RT_PAIRS, true, false, false, RT_UNIT_LEAF>;

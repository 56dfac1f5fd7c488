// Arity-2 instances of the traversal kernels (csrc/trace.cuh), raw bf16 rows.

#include "trace_launch.cuh"

template struct RtLaunch<2, RT_BF16, false, false, false, RT_UNIT_LEAF>;

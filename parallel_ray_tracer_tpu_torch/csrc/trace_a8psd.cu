// Arity-8 instances of the traversal kernels (csrc/trace.cuh) with streamed
// leaf rows, the DEEP stack tier (a global stack sized to the tree),
// bf16 pair rows.

#include "trace_launch.cuh"

template struct RtLaunch<8, RT_PAIRS, true, true, false, RT_UNIT_LEAF>;

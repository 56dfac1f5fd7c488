// Arity-2 instances of the traversal kernels (csrc/trace.cuh),
// the DEEP stack tier (a global stack sized to the tree), raw bf16 rows.

#include "trace_launch.cuh"

template struct RtLaunch<2, RT_BF16, false, true, false, RT_UNIT_LEAF>;

// Arity-2 instances of the traversal kernels (csrc/trace.cuh). There is no
// fused frame at arity 2: the JAX package has none either.

#include "trace_launch.cuh"

template struct RtLaunch<2>;

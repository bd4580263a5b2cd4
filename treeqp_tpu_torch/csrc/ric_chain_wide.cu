// ric_chain.cu's kernels at their 32-lane instantiation (16 < nz <= 32) and
// its _wide entry points, in a translation unit of their own: the build
// runs one nvcc a source, all at once, so this one compiles beside
// ric_chain.cu's 15 narrow instantiations instead of after them.
#define TQ_RIC_WIDE
#include "ric_chain.cu"

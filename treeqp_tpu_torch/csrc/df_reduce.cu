// Fixed-order f64 sum of a vector, in one launch of one thread block.
//
// Replaces the Pallas kernel df_reduce_flat of treeqp_tpu/ops/df_reduce.py,
// an ordered two-sum tree over (hi, lo) f32 pairs: the dual values and the
// directional derivative of the high-precision phase's Armijo test, which
// compares values of O(1e3) that differ by ~1e-10. What carries over is the
// fixed order: the sum is the same on every run (no atomics, no order that
// depends on scheduling), and equals the plain twin's bit for bit.
//
// The order: x zero-padded to m = the next power of two, then halving folds
// x[i] <- x[i] + x[i + h] for i < h, h = m/2, m/4, ..., 1. The first fold
// reads x (zeros past n); folds wider than kShared run in a global scratch
// buffer [m/2], the rest in shared memory, with a barrier after each.
//
// What bounds it on the card: one SM's bandwidth for the first folds
// (2 x 8 bytes per add) and log2(m) barriers; ~1e5 elements at the
// headline's directional derivative.

#include "tq_eval.cuh"

namespace {

constexpr long kShared = 2048;

__global__ void __launch_bounds__(1024) df_reduce_kernel(const double* __restrict__ x,
                                                         long n, long m, double* buf,
                                                         double* out) {
  __shared__ double sh[kShared];
  const int tid = threadIdx.x, nt = blockDim.x;
  if (m == 1) {
    if (tid == 0) out[0] = n > 0 ? x[0] : 0.0;
    return;
  }
  long h = m / 2;
  double* dst = h <= kShared ? sh : buf;
  for (long i = tid; i < h; i += nt)
    dst[i] = tq::add(i < n ? x[i] : 0.0, i + h < n ? x[i + h] : 0.0);
  __syncthreads();
  while (h > kShared) {
    h /= 2;
    double* to = h <= kShared ? sh : buf;
    for (long i = tid; i < h; i += nt) to[i] = tq::add(buf[i], buf[i + h]);
    __syncthreads();
  }
  while (h > 1) {
    h /= 2;
    for (long i = tid; i < h; i += nt) sh[i] = tq::add(sh[i], sh[i + h]);
    __syncthreads();
  }
  if (tid == 0) out[0] = sh[0];
}

}  // namespace

// x [n] f64; buf a scratch of max(m / 2, 1) f64 (m = the next power of two
// >= n, m = 1 for n <= 1); out one f64.
extern "C" int tq_df_reduce(const double* x, long n, long m, double* buf, double* out,
                            void* stream) {
  df_reduce_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(x, n, m, buf, out);
  return (int)cudaGetLastError();
}

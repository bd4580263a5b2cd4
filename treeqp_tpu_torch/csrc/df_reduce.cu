// Fixed-order f64 sum of a vector, in one launch over many SMs.
//
// Replaces the Pallas kernel df_reduce_flat of treeqp_tpu/ops/df_reduce.py,
// an ordered two-sum tree over (hi, lo) f32 pairs: the dual values and the
// directional derivative of the high-precision phase's Armijo test, which
// compares values of O(1e3) that differ by ~1e-10. What carries over is the
// fixed order: the sum is the same on every run (no atomics in the sum, no
// order that depends on scheduling), and equals the plain twin's bit for
// bit. The H100 has native FP64, so the values are doubles.
//
// The order: x zero-padded to m = the next power of two, then halving folds
// x[i] <- x[i] + x[i + h] for i < h, h = m/2, m/4, ..., 1. For any power of
// two G <= m the partial at the fold that leaves G values is
//   P_G[r] = the halving fold of the column x[r], x[r + G], x[r + 2G], ...
// (c = m / G values), and the sum is the halving fold of P_G; the folds of
// P_G down to B values pair r with r + h for h a multiple of B. Design:
// - m <= kG (4096): one block folds x itself.
// - m > kG: one cluster of kCluster (8) blocks of kThreads threads, G =
//   2048 columns of c = m / G values (c = 16 at the bench path's
//   directional derivative, 26,624 values). Thread t of block b forms
//   P_G[r] for r = b kKeep + t % kKeep + B (t / kKeep), B = kCluster kKeep:
//   kKeep neighbouring threads read a 32-byte run, and the block owns
//   whole residues mod B, so its folds of its partials down to kKeep
//   values (shared memory, then warp shuffles) give P_B at its residues
//   with no other block's values. A column of c <= kCol values is folded
//   by halving in registers; a longer one as the pairwise sum of its values
//   in bit-reversed order, which is the same tree: chunks of kCol
//   consecutive bit-reversed positions (a halving fold of kCol values at
//   stride c / kCol) combined in order by a binary-counter stack in
//   registers. The blocks hand their values of P_B to block 0's shared
//   memory, and it folds them after the cluster's barrier: no workspace,
//   fence or counter, and launches on any streams may overlap.
// The last fold was also measured as a second launch and as the last block
// to finish over 16 blocks (a fence and a counter); in a CUDA graph the
// cluster was the fastest of the three (PERF.md), so only it is kept.
//
// What bounds it on the card: latency. 26,624 doubles (213 KB) at the bench
// path's directional derivative are 0.06 us of HBM; a launch is one round
// of loads per thread, the blocks' folds, the cluster's barrier and block
// 0's fold.
// Above ~2^16 values the 8 SMs stream the vector at a fraction of the HBM
// rate (torch.sum is faster there; no path sums that many). No tensor
// cores: a sum of a vector has no matrix product.

#include <cooperative_groups.h>

#include "tq_eval.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCol = 16;                    // values a thread folds in registers
constexpr long kG = (long)kThreads * kCol;  // the most values one block folds
constexpr int kKeep = 4;                    // residues a block owns: 32-byte runs
constexpr int kCluster = 8;                 // blocks of the cluster form
constexpr int kDepth = 28;                  // binary-counter stack: c / kCol < 2^28

// The halving fold of v[0], v[stride], ..., v[(len-1) stride] (zeros at and
// past n), len a power of two <= kCol.
__device__ __forceinline__ double fold_regs(const double* v, long n, long base, long stride,
                                            int len) {
  double q[kCol];
#pragma unroll
  for (int k = 0; k < kCol; ++k) {
    const long i = base + k * stride;
    q[k] = k < len && i < n ? v[i] : 0.0;
  }
#pragma unroll
  for (int h = kCol / 2; h >= 1; h /= 2) {
    if (h < len) {
#pragma unroll
      for (int k = 0; k < h; ++k) q[k] = tq::add(q[k], q[k + h]);
    }
  }
  return q[0];
}

// P_G[r]: the halving fold of the column x[r + k G], k < 2^lc.
__device__ double column(const double* __restrict__ x, long n, long r, long G, int lc) {
  if (lc <= 4) return fold_regs(x, n, r, G, 1 << lc);
  // the pairwise sum over bit-reversed k: chunk q holds the positions
  // kCol q .. kCol q + kCol - 1, i.e. the values at k = brev(q) + t c / kCol
  const int lq = lc - 4;  // log2 of the chunk count
  const long stride = G << lq;
  double stk[kDepth], res = 0.0;
  for (unsigned q = 0; q < (1u << lq); ++q) {
    double s = fold_regs(x, n, r + G * (long)(__brev(q) >> (32 - lq)), stride, kCol);
#pragma unroll
    for (int l = 0; l < kDepth; ++l) {
      if ((q >> l) & 1u) {
        s = tq::add(stk[l], s);
      } else {
        stk[l] = res = s;
        break;
      }
    }
  }
  return res;
}

// The halving folds of the block's values (thread t's s) from blockDim.x =
// W values down to ``keep`` (1 or kKeep); thread t < keep returns the
// value left at t.
__device__ double fold_shared(double s, int W, int keep) {
  __shared__ double sh[kThreads];
  const int t = threadIdx.x;
  if (W > 32) {
    sh[t] = s;
    __syncthreads();
    for (int h = W / 2; h >= 32; h /= 2) {
      if (t < h) sh[t] = tq::add(sh[t], sh[t + h]);
      __syncthreads();
    }
    s = t < 32 ? sh[t] : 0.0;
  }
  if (t < 32) {
    for (int h = (W < 32 ? W : 32) / 2; h >= keep; h /= 2)
      s = tq::add(s, __shfl_down_sync(0xffffffffu, s, h));
  }
  return s;
}

// The halving fold of v[0 .. G) (zeros at and past n) by one block, into
// *out; G a power of two <= kG.
__device__ void fold_block(const double* v, long n, long G, double* out) {
  const int t = threadIdx.x;
  const int W = G < kThreads ? (int)G : kThreads;
  const double s = fold_shared(t < W ? fold_regs(v, n, t, W, (int)(G / W)) : 0.0, W, 1);
  if (t == 0) out[0] = s;
}

// m <= kG: one block folds x.
__global__ void __launch_bounds__(kThreads)
    df_reduce_block_kernel(const double* __restrict__ x, long n, long m, double* out) {
  fold_block(x, n, m, out);
}

// m > kG: the two-level form on one cluster of kCluster blocks (G =
// kCluster kThreads columns of 2^lc values); each block writes its kKeep
// values of P_B into block 0's shared memory, and after the cluster's
// barrier block 0 folds them.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    df_reduce_cluster_kernel(const double* __restrict__ x, long n, int lc, double* out) {
  constexpr long B = (long)kCluster * kKeep;
  __shared__ double pb[B];  // block 0's: P_B
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int b = (int)cluster.block_rank();
  const long r = (long)b * kKeep + t % kKeep + B * (t / kKeep);
  const double s = fold_shared(column(x, n, r, (long)kCluster * kThreads, lc), kThreads, kKeep);
  if (t < kKeep) *cluster.map_shared_rank(&pb[b * kKeep + t], 0) = s;
  cluster.sync();
  if (b == 0) fold_block(pb, B, B, out);
}

}  // namespace

// x [n] f64; m = the next power of two >= n (1 for n <= 1); out one f64.
extern "C" int tq_df_reduce(const double* x, long n, long m, double* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (m <= kG) {
    df_reduce_block_kernel<<<1, kThreads, 0, st>>>(x, n, m, out);
  } else {
    int lc = 0;
    while (((long)kCluster * kThreads << lc) < m) ++lc;
    df_reduce_cluster_kernel<<<kCluster, kThreads, 0, st>>>(x, n, lc, out);
  }
  return (int)cudaGetLastError();
}

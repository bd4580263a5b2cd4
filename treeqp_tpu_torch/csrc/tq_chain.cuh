// Per-chain banded block routines, one thread per chain: the two solve
// sweeps of a chain of L nodes (system_solve.cu, through tq_system.cuh).
// tq_lanes.cuh's sweep_bwd / sweep_fwd (chain_sweeps.cu, newton_iter.cu)
// run the same sums in the same order with a lane group per chain, bit for
// bit these bodies.
//
// The pointers address chain s's slice: Ls, CUs [L, n, n], vectors [L, n],
// row-major, j = 0 the node next to the crown. Same operation order as the
// Pallas kernels of treeqp_tpu/ops/chain_kernels.py and the plain twins.
#pragma once

#include "tq_dense.cuh"

namespace tq {

// Right-hand-side backward sweep: for j = L-1 .. 0
//   y_j = Ls_j^-1 (r_j - radd),  radd = CUs_j y_j
// with radd = 0 before the deepest node; radd [n] ends as the update of
// the crown parent's right-hand side.
__device__ inline void chain_solve_bwd_one(const float* __restrict__ Ls,
                                           const float* __restrict__ CUs,
                                           const float* __restrict__ r,
                                           float* __restrict__ y,
                                           float* __restrict__ radd, int L, int n) {
  const int nn = n * n;
  for (int i = 0; i < n; ++i) radd[i] = 0.f;
  for (int j = L - 1; j >= 0; --j) {
    const float* CU = CUs + (size_t)j * nn;
    float* yj = y + (size_t)j * n;
    for (int i = 0; i < n; ++i) yj[i] = r[(size_t)j * n + i] - radd[i];
    ltrsv_inplace(Ls + (size_t)j * nn, yj, n);
    for (int i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc += CU[i * n + k] * yj[k];
      radd[i] = acc;
    }
  }
}

// Forward substitution, in place of y: from dp = the crown parent's
// direction, for j = 0 .. L-1
//   dl_j = Ls_j^-T (y_j - CUs_j' dp),  dp = dl_j.
// dp [n] is overwritten.
__device__ inline void chain_forward_one(const float* __restrict__ Ls,
                                         const float* __restrict__ CUs,
                                         float* __restrict__ y,
                                         float* __restrict__ dp, int L, int n) {
  const int nn = n * n;
  for (int j = 0; j < L; ++j) {
    const float* CU = CUs + (size_t)j * nn;
    float* yj = y + (size_t)j * n;
    for (int i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc += CU[k * n + i] * dp[k];
      yj[i] = yj[i] - acc;
    }
    uttrsv_inplace(Ls + (size_t)j * nn, yj, n);
    for (int i = 0; i < n; ++i) dp[i] = yj[i];
  }
}

}  // namespace tq

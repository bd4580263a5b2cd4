// Body of the whole crown + chains Newton-system solve with stored factors,
// for one thread block: system_solve.cu's. newton_iter.cu runs the same
// phases on a thread-block cluster (lane-group sweeps, a warp per crown
// group), bit for bit this body.
//
// The caller fills rv [NpG, G] with the crown right-hand side (group
// layout, equilibrated), zeroes dg [NpG, G], and synchronizes the block.
// Then, separated by __syncthreads():
//   1. per chain (threads stride over scenarios): backward sweep
//        y_j = Ls_j^-1 (rch_j - radd),  radd = CUs_j y_j   (j = L-1 .. 0)
//      with y_j parked in dch, then rv[g_of[s], slot[s]] -= radd
//   2. crown backward, deepest level first (threads over the level's
//      groups): y_g = CholW_g^-1 rv_g, rv[parent][slot] -= CholUt_g y_g
//   3. root: dg_0 = CholW_0^-T CholW_0^-1 rv_0
//   4. crown forward, top level first: dg_g = CholW_g^-T (y_g - CholUt_g' dg[parent][slot])
//   5. per chain: forward sweep from dp = dg[g_of[s]][slot[s]]:
//        dch_j = Ls_j^-T (y_j - CUs_j' dp),  dp = dch_j   (j = 0 .. L-1)
// and a final barrier, so dg and dch are complete on return. Phases 1 and 5
// are tq_chain.cuh's chain sweeps (chain_sweeps.cu runs them on their own),
// phases 2-4 tq_crown.cuh's crown_solve_core (crown_solve.cu's body).
// Every (group, slot) has exactly one writer in phases 1 and 2 (one chain
// root, or one child group), so no atomics are needed. The TPU kernels did
// the scenario <-> group moves as one-hot matmuls; here they are indexed
// reads and writes.
#pragma once

#include "tq_chain.cuh"
#include "tq_crown.cuh"

namespace tq {

__device__ inline void system_solve_core(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ CholW, const float* __restrict__ CholUt,
    const float* __restrict__ rch,
    const int* __restrict__ lev_ptr, const int* __restrict__ lev_child,
    const int* __restrict__ lev_parent, const int* __restrict__ lev_slot,
    const int* __restrict__ g_of, const int* __restrict__ slot,
    float* __restrict__ rv, float* __restrict__ ycr,
    float* __restrict__ dg, float* __restrict__ dch,
    int S, int L, int n, int K, int n_lev) {
  const int G = K * n;
  const size_t chain = (size_t)L * n * n;

  // 1. chain backward sweeps + injection into the crown groups
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float radd[kMaxN];
    chain_solve_bwd_one(Ls + s * chain, CUs + s * chain, rch + (size_t)s * L * n,
                        dch + (size_t)s * L * n, radd, L, n);
    float* r = rv + (size_t)g_of[s] * G + slot[s] * n;
    for (int i = 0; i < n; ++i) r[i] -= radd[i];
  }
  __syncthreads();

  // 2.-4. crown backward sweep, root, crown forward substitution
  crown_solve_core(CholW, CholUt, lev_ptr, lev_child, lev_parent, lev_slot,
                   rv, ycr, dg, n, K, n_lev);

  // 5. chain forward sweeps
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float dp[kMaxN];
    const float* src = dg + (size_t)g_of[s] * G + slot[s] * n;
    for (int i = 0; i < n; ++i) dp[i] = src[i];
    chain_forward_one(Ls + s * chain, CUs + s * chain, dch + (size_t)s * L * n, dp,
                      L, n);
  }
  __syncthreads();
}

}  // namespace tq

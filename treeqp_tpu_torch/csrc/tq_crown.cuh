// Level-synchronous tree block Cholesky of the crown and its solve, for one
// thread block: shared by crown_blocks_factor.cu and crown_factor.cu (the
// factorization), and by crown_solve.cu and tq_system.cuh (the solve).
//
// The level schedule lists, deepest parent stage first, each level's
// entries e in [lev_ptr[lv], lev_ptr[lv+1]): the group lev_child[e] that
// level factorizes, its parent group lev_parent[e] and its kid slot
// lev_slot[e] there. Threads stride over a level's entries; a
// __syncthreads() separates the levels. Every (parent, slot) has exactly
// one child, so the child-to-parent updates need no atomics. The TPU
// kernels moved them with one-hot [K, NPg, NPg] lane matmuls; here they
// are indexed reads and writes. Groups are G x G with G = K n.
#pragma once

#include "tq_dense.cuh"

namespace tq {

// Factorization, in place. On entry CholW [NpG, G, G] holds the blocks W
// (equilibrated) of every group and CholUt [NpG, n, G] the parent couplings
// Ut of every group but the root. Per level entry (group g):
//   CholW_g = chol(W_g + reg I) (pivot floor 1e-8, clamped diagonal),
//   CholUt_g = Ut_g CholW_g^-T,
//   W[parent][slot, slot] -= CholUt_g CholUt_g',
// then the root group 0: CholW_0 = chol(W_0 + reg I).
// No barrier after the root: a caller that reads CholW_0 synchronizes.
__device__ inline void crown_factor_levels(
    float* __restrict__ CholW, float* __restrict__ CholUt,
    const int* __restrict__ lev_ptr, const int* __restrict__ lev_child,
    const int* __restrict__ lev_parent, const int* __restrict__ lev_slot,
    int n_lev, int K, int n, float reg) {
  const int G = K * n;
  const size_t GG = (size_t)G * G;
  for (int lv = 0; lv < n_lev; ++lv) {
    for (int e = lev_ptr[lv] + threadIdx.x; e < lev_ptr[lv + 1]; e += blockDim.x) {
      const int g = lev_child[e];
      float* W = CholW + g * GG;
      float* U = CholUt + (size_t)g * n * G;
      chol_inplace<true>(W, G, reg);
      rtrsm_t_inplace(W, U, n, G);
      float* Wd = CholW + lev_parent[e] * GG;
      const int off = lev_slot[e] * n;
      for (int a = 0; a < n; ++a) {
        for (int c = 0; c < n; ++c) {
          float acc = 0.f;
          for (int k = 0; k < G; ++k) acc += U[a * G + k] * U[c * G + k];
          Wd[(off + a) * G + off + c] -= acc;
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) chol_inplace<true>(CholW, G, reg);
}

// Solve with the stored factors. The caller fills rv [NpG, G] with the
// right-hand side, zeroes dg [NpG, G] and synchronizes the block. Then:
//   backward, deepest level first: y_g = CholW_g^-1 rv_g (kept in ycr),
//     rv[parent][slot] -= CholUt_g y_g;
//   root: dg_0 = CholW_0^-T CholW_0^-1 rv_0;
//   forward, top level first: dg_g = CholW_g^-T (y_g - CholUt_g' dg[parent][slot]);
// with a barrier after each level and after the root, so dg is complete on
// return.
__device__ inline void crown_solve_core(
    const float* __restrict__ CholW, const float* __restrict__ CholUt,
    const int* __restrict__ lev_ptr, const int* __restrict__ lev_child,
    const int* __restrict__ lev_parent, const int* __restrict__ lev_slot,
    float* __restrict__ rv, float* __restrict__ ycr, float* __restrict__ dg,
    int n, int K, int n_lev) {
  const int G = K * n;
  const size_t GG = (size_t)G * G;

  // backward sweep
  for (int lv = 0; lv < n_lev; ++lv) {
    for (int e = lev_ptr[lv] + threadIdx.x; e < lev_ptr[lv + 1]; e += blockDim.x) {
      const int g = lev_child[e];
      float* y = ycr + (size_t)g * G;
      for (int i = 0; i < G; ++i) y[i] = rv[(size_t)g * G + i];
      ltrsv_inplace(CholW + g * GG, y, G);
      const float* U = CholUt + (size_t)g * n * G;
      float* rd = rv + (size_t)lev_parent[e] * G + lev_slot[e] * n;
      for (int a = 0; a < n; ++a) {
        float acc = 0.f;
        for (int k = 0; k < G; ++k) acc += U[a * G + k] * y[k];
        rd[a] -= acc;
      }
    }
    __syncthreads();
  }

  // root
  if (threadIdx.x == 0) {
    for (int i = 0; i < G; ++i) ycr[i] = rv[i];
    ltrsv_inplace(CholW, ycr, G);
    for (int i = 0; i < G; ++i) dg[i] = ycr[i];
    uttrsv_inplace(CholW, dg, G);
  }
  __syncthreads();

  // forward substitution
  for (int lv = n_lev - 1; lv >= 0; --lv) {
    for (int e = lev_ptr[lv] + threadIdx.x; e < lev_ptr[lv + 1]; e += blockDim.x) {
      const int g = lev_child[e];
      const float* dp = dg + (size_t)lev_parent[e] * G + lev_slot[e] * n;
      const float* U = CholUt + (size_t)g * n * G;
      const float* y = ycr + (size_t)g * G;
      float* dl = dg + (size_t)g * G;
      for (int j = 0; j < G; ++j) {
        float acc = 0.f;
        for (int i = 0; i < n; ++i) acc += U[i * G + j] * dp[i];
        dl[j] = y[j] - acc;
      }
      uttrsv_inplace(CholW + g * GG, dl, G);
    }
    __syncthreads();
  }
}

}  // namespace tq

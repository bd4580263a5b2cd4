// Body of the whole crown + chains Newton-system solve with stored factors,
// for one thread block: shared by system_solve.cu and newton_iter.cu.
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
// and a final barrier, so dg and dch are complete on return.
// Every (group, slot) has exactly one writer in phases 1 and 2 (one chain
// root, or one child group), so no atomics are needed. The TPU kernels did
// the scenario <-> group moves as one-hot matmuls; here they are indexed
// reads and writes.
#pragma once

#include "tq_dense.cuh"

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
  const size_t GG = (size_t)G * G;
  const int nn = n * n;

  // 1. chain backward sweeps + injection into the crown groups
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float radd[kMaxN];
    for (int i = 0; i < n; ++i) radd[i] = 0.f;
    for (int j = L - 1; j >= 0; --j) {
      const size_t sj = (size_t)s * L + j;
      const float* CU = CUs + sj * nn;
      float* y = dch + sj * n;
      for (int i = 0; i < n; ++i) y[i] = rch[sj * n + i] - radd[i];
      ltrsv_inplace(Ls + sj * nn, y, n);
      for (int i = 0; i < n; ++i) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k) acc += CU[i * n + k] * y[k];
        radd[i] = acc;
      }
    }
    float* r = rv + (size_t)g_of[s] * G + slot[s] * n;
    for (int i = 0; i < n; ++i) r[i] -= radd[i];
  }
  __syncthreads();

  // 2. crown backward sweep
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

  // 3. root
  if (threadIdx.x == 0) {
    for (int i = 0; i < G; ++i) ycr[i] = rv[i];
    ltrsv_inplace(CholW, ycr, G);
    for (int i = 0; i < G; ++i) dg[i] = ycr[i];
    uttrsv_inplace(CholW, dg, G);
  }
  __syncthreads();

  // 4. crown forward substitution
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

  // 5. chain forward sweeps
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float dp[kMaxN];
    const float* src = dg + (size_t)g_of[s] * G + slot[s] * n;
    for (int i = 0; i < n; ++i) dp[i] = src[i];
    for (int j = 0; j < L; ++j) {
      const size_t sj = (size_t)s * L + j;
      const float* CU = CUs + sj * nn;
      float* y = dch + sj * n;
      for (int i = 0; i < n; ++i) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k) acc += CU[k * n + i] * dp[k];
        y[i] = y[i] - acc;
      }
      uttrsv_inplace(Ls + sj * nn, y, n);
      for (int i = 0; i < n; ++i) dp[i] = y[i];
    }
  }
  __syncthreads();
}

}  // namespace tq

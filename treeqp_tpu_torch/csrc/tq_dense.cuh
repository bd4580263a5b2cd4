// Per-thread dense block routines shared by the port's kernels.
//
// Every routine works in place on one small row-major block, sequentially,
// in the order the Pallas kernels of treeqp_tpu/ops/ use (same pivot rule,
// same summation order per element), so that the f32 results agree with
// them and with the plain PyTorch twins up to rounding and FMA contraction.
// The pointers may address global or local memory.
#pragma once

#include <cuda_runtime.h>

namespace tq {

constexpr float kPivotFloor = 1e-8f;
constexpr int kMaxN = 16;  // largest chain / crown state dim the kernels take

// Lower Cholesky factor of the n x n block W, in place (upper part zeroed).
// Column k: a = W[:, k] (+ reg on the diagonal) - sum_{m<k} L[:, m] L[k, m];
// pivot d = max(a_kk, 1e-8); column = a * rsqrt(d) below the diagonal.
// The diagonal is d * rsqrt(d) when kClampDiag (crown_kernels._chol) and
// a_kk * rsqrt(d) otherwise (chain_kernels._chol).
template <bool kClampDiag>
__device__ inline void chol_inplace(float* W, int n, float reg) {
  for (int k = 0; k < n; ++k) {
    float akk = W[k * n + k] + reg;
    for (int m = 0; m < k; ++m) akk -= W[k * n + m] * W[k * n + m];
    const float d = fmaxf(akk, kPivotFloor);
    const float dinv = rsqrtf(d);
    for (int i = k + 1; i < n; ++i) {
      float a = W[i * n + k];
      for (int m = 0; m < k; ++m) a -= W[i * n + m] * W[k * n + m];
      W[i * n + k] = a * dinv;
    }
    W[k * n + k] = (kClampDiag ? d : akk) * dinv;
    for (int j = k + 1; j < n; ++j) W[k * n + j] = 0.f;
  }
}

// L y = r, in place of r (length n).
__device__ inline void ltrsv_inplace(const float* L, float* r, int n) {
  for (int i = 0; i < n; ++i) {
    float acc = r[i];
    for (int m = 0; m < i; ++m) acc -= L[i * n + m] * r[m];
    r[i] = acc / L[i * n + i];
  }
}

// L' z = d, in place of d (length n).
__device__ inline void uttrsv_inplace(const float* L, float* d, int n) {
  for (int i = n - 1; i >= 0; --i) {
    float acc = d[i];
    for (int m = i + 1; m < n; ++m) acc -= L[m * n + i] * d[m];
    d[i] = acc / L[i * n + i];
  }
}

}  // namespace tq

// Crown factorize of the multistage dual Hessian: block build, Jacobi
// scaling, the chain Schur term, and the level-synchronous tree block
// Cholesky, in one launch of one thread block.
//
// Replaces the Pallas kernel crown_blocks_factor of
// treeqp_tpu/ops/crown_kernels.py (with its _factor_levels loop). The TPU
// kernel put the lambda-groups on the 128 vector lanes, factorized every
// lane at every level and moved each child's Schur block to its parent with
// one-hot matmuls. Here each thread owns one group; a level's groups are
// factorized in parallel, and each child subtracts its Schur block CU CU'
// directly from its (parent, slot) diagonal block. Every (parent, slot)
// has exactly one child, so the writes need no atomics; __syncthreads()
// orders the levels.
//
// Per group g (G = K nxm, kid slots k1, k2 over the K kids):
//   W[k1 a, k2 b] = sum_n ABk[k1, a, n] ztp[n] ABk[k2, b, n]  (+ dvals on the diagonal)
//   W  <- diag(sW) W diag(sW) + Wadd         (Wadd: the negated chain Schur blocks)
//   Ut[i, k c] = -ztp[i] ABk[k, c, i],  Ut <- diag(sUt) Ut diag(sW)
// then, deepest level first: CholW = chol(W + reg I) with pivot floor 1e-8,
// CholUt = Ut CholW^-T, W[parent][slot, slot] -= CholUt CholUt'; the root
// group (0) last.
//
// What bounds it on the card: latency. Each level is one serial G x G
// Cholesky per thread (G = 24 at the quadcopter crown: ~4.6k dependent
// flops plus the block build) and the crown has 4-5 levels; the block
// holds one thread per group of the widest level (64 at the headline
// crown, 256 at the 1024-scenario one). The G x G blocks stay in the
// output buffer in global memory (L1/L2 resident at these sizes), so no
// per-thread local array limits G. A warp per group is the next step.

#include "tq_crown.cuh"

namespace {

__global__ void __launch_bounds__(1024) crown_blocks_factor_kernel(
    const float* __restrict__ ABk, const float* __restrict__ ztp,
    const float* __restrict__ dvals, const float* __restrict__ sW,
    const float* __restrict__ sUt, const float* __restrict__ Wadd,
    const int* __restrict__ lev_ptr, const int* __restrict__ lev_child,
    const int* __restrict__ lev_parent, const int* __restrict__ lev_slot,
    float* __restrict__ CholW, float* __restrict__ CholUt,
    int NpG, int K, int nxm, int nz, int n_lev, float reg) {
  const int G = K * nxm;
  const size_t GG = (size_t)G * G;

  // phase 1: every group's scaled blocks
  for (int g = threadIdx.x; g < NpG; g += blockDim.x) {
    float* W = CholW + g * GG;
    float* U = CholUt + (size_t)g * nxm * G;
    if (g == 0) {
      for (int i = 0; i < nxm * G; ++i) U[i] = 0.f;
    }
    const float* AB = ABk + (size_t)g * K * nxm * nz;  // [K][nxm][nz]
    const float* zt = ztp + (size_t)g * nz;
    const float* dv = dvals + (size_t)g * G;
    const float* sw = sW + (size_t)g * G;
    const float* wa = Wadd + g * GG;
    for (int r = 0; r < G; ++r) {
      for (int c = 0; c < G; ++c) {
        float w = 0.f;
        for (int n = 0; n < nz; ++n) w += (AB[r * nz + n] * zt[n]) * AB[c * nz + n];
        if (r == c) w += dv[r];
        W[r * G + c] = w * sw[r] * sw[c] + wa[r * G + c];
      }
    }
    if (g != 0) {
      const float* su = sUt + (size_t)g * nxm;
      for (int i = 0; i < nxm; ++i)
        for (int col = 0; col < G; ++col)
          U[i * G + col] = -(zt[i] * AB[col * nz + i]) * su[i] * sw[col];
    }
  }
  __syncthreads();

  // phase 2: levels, deepest first; children update their parents; then
  // the root group (tq_crown.cuh, shared with crown_factor.cu)
  tq::crown_factor_levels(CholW, CholUt, lev_ptr, lev_child, lev_parent, lev_slot,
                          n_lev, K, nxm, reg);
}

}  // namespace

extern "C" int tq_crown_blocks_factor(
    const float* ABk, const float* ztp, const float* dvals, const float* sW,
    const float* sUt, const float* Wadd, const int* lev_ptr,
    const int* lev_child, const int* lev_parent, const int* lev_slot,
    float* CholW, float* CholUt,
    int NpG, int K, int nxm, int nz, int n_lev, float reg, int threads,
    void* stream) {
  crown_blocks_factor_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      ABk, ztp, dvals, sW, sUt, Wadd, lev_ptr, lev_child, lev_parent,
      lev_slot, CholW, CholUt, NpG, K, nxm, nz, n_lev, reg);
  return (int)cudaGetLastError();
}

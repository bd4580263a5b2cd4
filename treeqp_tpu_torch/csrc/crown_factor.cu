// Level-synchronous tree block Cholesky of given equilibrated blocks, in
// one launch of one thread block: the factorization of the generic tree
// solver (the whole tree, or the crown levels of its split path).
//
// Replaces the Pallas kernel crown_factor of treeqp_tpu/ops/crown_kernels.py
// (reached through tdunes._tree_chol_factor). Input: W [NpG, G, G] (Jacobi
// equilibrated; on the split path only the crown's groups, with the chain
// Schur blocks already subtracted) and the parent couplings Ut
// [NpG, nxm, G]. Phase 1 copies them into CholW / CholUt (the root group
// has no parent: CholUt_0 = 0); phase 2 is tq::crown_factor_levels
// (tq_crown.cuh), the level loop crown_blocks_factor.cu runs after its
// block build: per level entry CholW_g = chol(W_g + reg I) (pivot floor
// 1e-8, clamped diagonal), CholUt_g = Ut_g CholW_g^-T, and the Schur block
// CholUt_g CholUt_g' subtracted from its (parent, slot) diagonal block by
// index, one writer per (parent, slot), where the TPU kernel moved it with
// one-hot [K, NPg, NPg] matmuls; then the root group.
//
// What bounds it on the card: latency. Each level is one serial G x G
// Cholesky and trsm per thread (G = 24 at the quadcopter: ~4.6k + 3.5k
// dependent flops), the levels are separated by barriers, and the whole
// factorization is one block on one SM. The blocks are factorized in place
// in the output buffer (L1/L2 resident), so no per-thread array limits G.
// A warp per group is the next step.

#include "tq_crown.cuh"

namespace {

__global__ void __launch_bounds__(1024) crown_factor_kernel(
    const float* __restrict__ W, const float* __restrict__ Ut,
    const int* __restrict__ lev_ptr, const int* __restrict__ lev_child,
    const int* __restrict__ lev_parent, const int* __restrict__ lev_slot,
    float* __restrict__ CholW, float* __restrict__ CholUt,
    int NpG, int K, int nxm, int n_lev, float reg) {
  const int G = K * nxm;
  const size_t GG = (size_t)G * G;
  const size_t UG = (size_t)nxm * G;

  // phase 1: the blocks into the factor buffers
  for (int g = threadIdx.x; g < NpG; g += blockDim.x) {
    float* Wg = CholW + g * GG;
    float* Ug = CholUt + g * UG;
    for (size_t i = 0; i < GG; ++i) Wg[i] = W[g * GG + i];
    for (size_t i = 0; i < UG; ++i) Ug[i] = g != 0 ? Ut[g * UG + i] : 0.f;
  }
  __syncthreads();

  // phase 2: levels, deepest first, then the root group
  tq::crown_factor_levels(CholW, CholUt, lev_ptr, lev_child, lev_parent, lev_slot,
                          n_lev, K, nxm, reg);
}

}  // namespace

// W, Ut, lev_ptr, lev_child, lev_parent, lev_slot, CholW, CholUt, NpG, K,
// nxm, n_lev, reg, threads, stream
extern "C" int tq_crown_factor(
    const float* W, const float* Ut, const int* lev_ptr, const int* lev_child,
    const int* lev_parent, const int* lev_slot, float* CholW, float* CholUt,
    int NpG, int K, int nxm, int n_lev, float reg, int threads, void* stream) {
  crown_factor_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      W, Ut, lev_ptr, lev_child, lev_parent, lev_slot, CholW, CholUt,
      NpG, K, nxm, n_lev, reg);
  return (int)cudaGetLastError();
}

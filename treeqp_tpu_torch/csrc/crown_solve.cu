// Solve with crown_factor's tree block-Cholesky factors, in one launch of
// one thread block.
//
// Replaces the Pallas kernel crown_solve of treeqp_tpu/ops/crown_kernels.py
// (reached through tdunes._tree_chol_solve; reference
// calculate_delta_lambda, dual_Newton_tree.c:745-775). Phase 0 copies the
// right-hand side rg [NpG, G] into the working vector rv and zeroes dg;
// then tq::crown_solve_core (tq_crown.cuh), phases 2-4 of system_solve.cu:
//   backward, deepest level first: y_g = CholW_g^-1 rv_g,
//     rv[parent][slot] -= CholUt_g y_g;
//   root: dg_0 = CholW_0^-T CholW_0^-1 rv_0;
//   forward, top level first: dg_g = CholW_g^-T (y_g - CholUt_g' dg[parent][slot]).
// The TPU kernel moved the child <-> parent slices with one-hot lane
// matmuls; here they are indexed reads and writes, one writer per
// (parent, slot).
//
// What bounds it on the card: latency. Each level is a serial G x G
// triangular solve and an nxm x G product per thread, twice (backward and
// forward), with a barrier between levels; the root solve runs on one
// thread. The factors are read once (CholW is 2.3 KB a group at G = 24).

#include "tq_crown.cuh"

namespace {

__global__ void __launch_bounds__(1024) crown_solve_kernel(
    const float* __restrict__ CholW, const float* __restrict__ CholUt,
    const float* __restrict__ rg, const int* __restrict__ lev_ptr,
    const int* __restrict__ lev_child, const int* __restrict__ lev_parent,
    const int* __restrict__ lev_slot, float* __restrict__ rv,
    float* __restrict__ ycr, float* __restrict__ dg,
    int NpG, int K, int nxm, int n_lev) {
  const int G = K * nxm;
  for (int e = threadIdx.x; e < NpG * G; e += blockDim.x) {
    rv[e] = rg[e];
    dg[e] = 0.f;
  }
  __syncthreads();
  tq::crown_solve_core(CholW, CholUt, lev_ptr, lev_child, lev_parent, lev_slot,
                       rv, ycr, dg, nxm, K, n_lev);
}

}  // namespace

// CholW, CholUt, rg, lev_ptr, lev_child, lev_parent, lev_slot, rv, ycr,
// dg, NpG, K, nxm, n_lev, threads, stream
extern "C" int tq_crown_solve(
    const float* CholW, const float* CholUt, const float* rg, const int* lev_ptr,
    const int* lev_child, const int* lev_parent, const int* lev_slot, float* rv,
    float* ycr, float* dg, int NpG, int K, int nxm, int n_lev, int threads,
    void* stream) {
  crown_solve_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      CholW, CholUt, rg, lev_ptr, lev_child, lev_parent, lev_slot, rv, ycr, dg,
      NpG, K, nxm, n_lev);
  return (int)cudaGetLastError();
}

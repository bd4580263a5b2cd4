// Whole crown + chains Newton-system solve with stored factors, in one
// launch of one thread block.
//
// Replaces the Pallas kernel system_solve of treeqp_tpu/ops/system_kernels.py
// (reference calculate_delta_lambda, dual_Newton_tree.c:641-775). Phase 0
// copies the crown right-hand side rg into the working vector rv and zeroes
// dg; the five solve phases are tq::system_solve_core (tq_system.cuh), which
// newton_iter.cu runs too.
//
// What bounds it on the card: latency. Each phase is a serial chain of
// small triangular solves per thread (L * n^2 for a chain, G^2 per crown
// level), the crown phases use one thread per group of a level, and the
// whole solve is one block on one SM. It runs 3x per Newton iteration of
// the f64 phase (one solve + two refinement solves), so its latency adds
// directly to the iteration time.

#include "tq_system.cuh"

namespace {

__global__ void __launch_bounds__(1024) system_solve_kernel(
    const float* __restrict__ Ls, const float* __restrict__ CUs,
    const float* __restrict__ CholW, const float* __restrict__ CholUt,
    const float* __restrict__ rg, const float* __restrict__ rch,
    const int* __restrict__ lev_ptr, const int* __restrict__ lev_child,
    const int* __restrict__ lev_parent, const int* __restrict__ lev_slot,
    const int* __restrict__ g_of, const int* __restrict__ slot,
    float* __restrict__ rv, float* __restrict__ ycr,
    float* __restrict__ dg, float* __restrict__ dch,
    int S, int L, int n, int NpG, int K, int n_lev) {
  const int G = K * n;
  // 0. crown right-hand side
  for (int e = threadIdx.x; e < NpG * G; e += blockDim.x) {
    rv[e] = rg[e];
    dg[e] = 0.f;
  }
  __syncthreads();
  tq::system_solve_core(Ls, CUs, CholW, CholUt, rch, lev_ptr, lev_child,
                        lev_parent, lev_slot, g_of, slot, rv, ycr, dg, dch,
                        S, L, n, K, n_lev);
}

}  // namespace

extern "C" int tq_system_solve(
    const float* Ls, const float* CUs, const float* CholW, const float* CholUt,
    const float* rg, const float* rch, const int* lev_ptr,
    const int* lev_child, const int* lev_parent, const int* lev_slot,
    const int* g_of, const int* slot, float* rv, float* ycr, float* dg,
    float* dch, int S, int L, int n, int NpG, int K, int n_lev, int threads,
    void* stream) {
  system_solve_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      Ls, CUs, CholW, CholUt, rg, rch, lev_ptr, lev_child, lev_parent,
      lev_slot, g_of, slot, rv, ycr, dg, dch, S, L, n, NpG, K, n_lev);
  return (int)cudaGetLastError();
}

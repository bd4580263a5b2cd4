// Whole crown + chains Newton-system solve with stored factors, in one
// launch of one thread-block cluster.
//
// Replaces the Pallas kernel system_solve of treeqp_tpu/ops/system_kernels.py
// (reference calculate_delta_lambda, dual_Newton_tree.c:641-775). Phase 0
// copies the crown right-hand side rg into the working vector rv and zeroes
// dg; then tq_system.cuh's three phases, the body that newton_iter.cu runs
// as its step 2: the chains' backward sweeps (y_j parked in dch), each
// chain's CUs_0 y_0 taken from its crown slot of rv; the crown's levels,
// backward, root and forward; the chains' forward sweeps from their crown
// slot of dg, writing dch in place of y (each lane overwrites y_j only after
// its own copy of y_j has landed in the ring).
//
// What bounds it on the card: latency. A launch moves ~0.9 MB at the
// quadcopter headline (S = 256 chains of L = 16, n = 6; 85 crown groups of
// G = 24): ~0.3 us at the card's memory rate. The work is a chain of
// dependent phases: L steps of an n x n triangular solve per chain, twice,
// and the crown's levels, each a G x G triangular solve per group, twice.
// The one-block kernel this replaces ran it on one SM, a thread a chain
// walking its blocks through local memory and a thread a crown group
// (0.83-0.87 ms at the headline). Design:
// - One cluster of tq::kSysCluster = 8 blocks (the portable maximum) of
//   tq::kSysThreads threads on 8 SMs; the cluster's barrier (release /
//   acquire at cluster scope) between phases and between the crown's
//   levels; the vectors that cross blocks (rv, ycr, dg, dch) go through
//   global memory, which stays in L2.
// - The chain sweeps run 8 or 16 lanes a chain (lane i owning row i), the
//   blocks streamed through each group's cp.async ring in shared memory;
//   as many groups a block as its rings fit (tq::ring_shape), striding over
//   the chains: at the headline 64 groups a block, 512 over the cluster,
//   so each of the 256 chains has its own group.
// - The crown's levels run a warp a group (G <= 32), the cluster's 128
//   warps over a level's groups; G > 32 runs the per-thread
//   crown_solve_core in block 0.
// Every sum keeps the one-block kernel's order and FMAs: bit for bit.
// No tensor cores: every step is a dependent triangular solve of n <= 16
// or G <= 32 rows, below wgmma's 64-row tiles.

#include <cooperative_groups.h>

#include <cstdint>

#include "tq_system.cuh"

namespace cg = cooperative_groups;

namespace {

template <int GL>
__global__ void __cluster_dims__(tq::kSysCluster, 1, 1) __launch_bounds__(tq::kSysThreads)
    system_solve_kernel(const tq::SystemArgs a, const float* __restrict__ rg,
                        const float* __restrict__ rch, float* dch, int NpG) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const int n = a.n, L = a.L, G = a.K * n;
  // the cluster's threads interleaved over the blocks
  const int ix = threadIdx.x * tq::kSysCluster + b, gn = tq::kSysCluster * blockDim.x;
  // 0. crown right-hand side
  for (int e = ix; e < NpG * G; e += gn) {
    a.rv[e] = rg[e];
    a.dg[e] = 0.f;
  }
  cluster.sync();
  // 1. chain backward sweeps, y_j into dch, CUs_0 y_0 out of the crown slot
  tq::chain_bwd<GL>(a, smem, b, rch, [&](int s, bool live, int i, int j, float y) {
    if (live && i < n) dch[((size_t)s * L + j) * n + i] = y;
  });
  cluster.sync();
  // 2. the crown
  tq::crown(a, [](int) {});
  // 3. chain forward sweeps, dch_j over y_j
  tq::chain_fwd<GL>(
      a, smem, b, dch, [](int, bool, int, int) {},
      [&](int s, bool live, int i, int j, float d) {
        if (live && i < n) dch[((size_t)s * L + j) * n + i] = d;
      });
}

template <int GL>
int launch(tq::SystemArgs& a, const float* rg, const float* rch, float* dch, int NpG,
           cudaStream_t st) {
  size_t bytes;
  tq::ring_shape(a.n, GL, &a.groups, &bytes);
  static size_t opted = 0;  // the dynamic shared memory this kernel may take
  if (bytes > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        system_solve_kernel<GL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted = bytes;
  }
  system_solve_kernel<GL><<<tq::kSysCluster, tq::kSysThreads, bytes, st>>>(a, rg, rch, dch,
                                                                            NpG);
  return (int)cudaGetLastError();
}

}  // namespace

// Ls, CUs, CholW, CholUt, rg, rch, lev_ptr, lev_child, lev_parent,
// lev_slot, g_of, slot, rv, ycr, dg (scratch rv, ycr), dch, S, L, n, NpG,
// K, n_lev, stream
extern "C" int tq_system_solve(
    const float* Ls, const float* CUs, const float* CholW, const float* CholUt,
    const float* rg, const float* rch, const int* lev_ptr,
    const int* lev_child, const int* lev_parent, const int* lev_slot,
    const int* g_of, const int* slot, float* rv, float* ycr, float* dg,
    float* dch, int S, int L, int n, int NpG, int K, int n_lev, void* stream) {
  tq::SystemArgs a;
  a.Ls = Ls; a.CUs = CUs; a.CholW = CholW; a.CholUt = CholUt;
  a.lev_ptr = lev_ptr; a.lev_child = lev_child; a.lev_parent = lev_parent;
  a.lev_slot = lev_slot; a.g_of = g_of; a.slot = slot;
  a.rv = rv; a.ycr = ycr; a.dg = dg;
  a.S = S; a.L = L; a.n = n; a.K = K; a.n_lev = n_lev;
  a.vec16 = n % 2 == 0 && (((uintptr_t)Ls | (uintptr_t)CUs) & 15) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return n <= 8 ? launch<8>(a, rg, rch, dch, NpG, st) : launch<16>(a, rg, rch, dch, NpG, st);
}

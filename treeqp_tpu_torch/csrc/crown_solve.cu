// Solve with crown_factor's tree block-Cholesky factors, in one launch of
// one thread-block cluster or one block.
//
// Replaces the Pallas kernel crown_solve of treeqp_tpu/ops/crown_kernels.py
// (reached through tdunes._tree_chol_solve; reference
// calculate_delta_lambda, dual_Newton_tree.c:745-775). Phase 0 copies the
// right-hand side rg [NpG, G] into the working vector rv and zeroes dg;
// then tq_crown.cuh's crown solve, the one system_solve.cu and
// newton_iter.cu run as their crown phase:
//   backward, deepest level first: y_g = CholW_g^-1 rv_g,
//     rv[parent][slot] -= CholUt_g y_g;
//   root: dg_0 = CholW_0^-T CholW_0^-1 rv_0;
//   forward, top level first: dg_g = CholW_g^-T (y_g - CholUt_g' dg[parent][slot]).
// The TPU kernel moved the child <-> parent slices with one-hot lane
// matmuls; here they are indexed reads and writes, one writer per
// (parent, slot).
//
// What bounds it on the card: latency. The factors are read once (CholW is
// 2.3 KB a group at G = 24; ~0.2 MB at the pruned tree's 81 groups, ~0.06
// us at the card's memory rate); the work is a chain of dependent levels,
// each a G x G triangular solve per group, twice, with a barrier between
// levels. The one-block kernel this replaces ran a thread a group, its
// triangular solves serial in local memory (0.19 ms at the pruned crown).
// Design:
// - A warp a group, lane i owning row i (G <= 32): each triangular solve is
//   G rounds of a division and a shuffle (tq::crown_solve_warps). Every
//   sum keeps crown_solve_core's order, each product one FMA as nvcc
//   contracted it there and the divisions true divisions: bit for bit the
//   one-block kernel.
// - The blocks are sized to the widest level (crown_kernels._solve_launch):
//   one cluster of tq::kCrownCluster = 8 blocks whose warps a level's
//   groups take interleaved over the blocks, the cluster's barrier between
//   levels; or, where the levels are narrow, one block and __syncthreads.
//   A warp loads its next group's factor rows between the barrier's two
//   halves.
// - G > 32: tq_crown.cuh's per-thread crown_solve_core in one block, a
//   thread a group, as before.
// No tensor cores: every step is a dependent triangular solve of G <= 32
// rows (64 in the per-thread form), below wgmma's 64-row tiles.

#include <cooperative_groups.h>

#include "tq_crown.cuh"

namespace {

constexpr int kMaxThreads = 512;  // 128 registers a thread

// Phase 0 over the team's threads (interleaved over its blocks), its
// barrier, the solve.
template <typename Team>
__device__ __forceinline__ void solve(const Team& team, const tq::CrownArgs& a,
                                      const float* __restrict__ rg, int NpG) {
  const int G = a.K * a.n;
  const int gn = Team::kBlocks * blockDim.x;
  for (int e = threadIdx.x * Team::kBlocks + team.rank; e < NpG * G; e += gn) {
    a.rv[e] = rg[e];
    a.dg[e] = 0.f;
  }
  team.sync();
  tq::crown(team, a, [](int) {});
}

__global__ void __cluster_dims__(tq::kCrownCluster, 1, 1) __launch_bounds__(kMaxThreads)
    crown_solve_cluster(const tq::CrownArgs a, const float* __restrict__ rg, int NpG) {
  solve(tq::ClusterTeam(), a, rg, NpG);
}

__global__ void __launch_bounds__(kMaxThreads)
    crown_solve_block(const tq::CrownArgs a, const float* __restrict__ rg, int NpG) {
  solve(tq::BlockTeam(), a, rg, NpG);
}

}  // namespace

// CholW, CholUt, rg, lev_ptr, lev_child, lev_parent, lev_slot, rv, ycr,
// dg, NpG, K, nxm, n_lev, blocks (kCrownCluster: one cluster; 1: one
// block), warps a block, stream
extern "C" int tq_crown_solve(
    const float* CholW, const float* CholUt, const float* rg, const int* lev_ptr,
    const int* lev_child, const int* lev_parent, const int* lev_slot, float* rv,
    float* ycr, float* dg, int NpG, int K, int nxm, int n_lev, int blocks, int warps,
    void* stream) {
  if (warps < 1 || 32 * warps > kMaxThreads || (blocks != 1 && blocks != tq::kCrownCluster))
    return (int)cudaErrorInvalidValue;
  tq::CrownArgs a;
  a.CholW = CholW; a.CholUt = CholUt;
  a.lev_ptr = lev_ptr; a.lev_child = lev_child; a.lev_parent = lev_parent;
  a.lev_slot = lev_slot;
  a.rv = rv; a.ycr = ycr; a.dg = dg;
  a.n = nxm; a.K = K; a.n_lev = n_lev;
  const cudaStream_t st = (cudaStream_t)stream;
  if (blocks == 1)
    crown_solve_block<<<1, 32 * warps, 0, st>>>(a, rg, NpG);
  else
    crown_solve_cluster<<<blocks, 32 * warps, 0, st>>>(a, rg, NpG);
  return (int)cudaGetLastError();
}

// The whole crown + chains Newton-system solve with stored factors on one
// thread-block cluster: the body that system_solve.cu runs alone and
// newton_iter.cu runs as its step 2.
//
// The caller fills rv [NpG, G] with the crown right-hand side (group
// layout, equilibrated), zeroes dg [NpG, G] and passes the cluster's
// barrier. Then, each phase behind the cluster's barrier:
//   1. chain_bwd: per chain, the backward sweep
//        y_j = Ls_j^-1 (rch_j - radd),  radd = CUs_j y_j   (j = L-1 .. 0)
//      with each y_j handed to the caller, then rv[g_of[s], slot[s]] -= radd
//   2. crown: deepest level first y_g = CholW_g^-1 rv_g (kept in ycr),
//      rv[parent][slot] -= CholUt_g y_g; the root dg_0 = CholW_0^-T
//      CholW_0^-1 rv_0; top level first dg_g = CholW_g^-T (y_g - CholUt_g'
//      dg[parent][slot]); dg is complete when it returns
//   3. chain_fwd: per chain, the forward sweep from dp = dg[g_of[s]][slot[s]]
//        dch_j = Ls_j^-T (y_j - CUs_j' dp),  dp = dch_j   (j = 0 .. L-1)
// Every (group, slot) has one writer in phases 1 and 2 (one chain root, or
// one child group), so no atomics are needed. The TPU kernels did the
// scenario <-> group moves as one-hot matmuls; here they are indexed reads
// and writes.
//
// The chain sweeps are tq_lanes.cuh's sweep_bwd / sweep_fwd (the steps of
// chain_sweeps.cu): 8 or 16 lanes a chain, lane i owning row i, the blocks
// Ls_j, CUs_j streamed through a cp.async ring; a block gives as many lane
// groups to the sweeps as its shared memory holds rings (kSysRingBytes,
// ring_shape), and the groups stride over the chains. The crown's levels
// are tq_crown.cuh's crown solve, the one crown_solve.cu runs: a warp a
// group (lane i row i, G <= 32 rows) on the cluster's warps; wider groups
// run the per-thread crown_solve_core in block 0. Every sum keeps the
// order of the per-thread bodies this replaced (tq_dense.cuh's
// ltrsv_inplace / uttrsv_inplace and crown_solve_core), each product one
// FMA as nvcc contracted them there and the divisions true divisions: bit
// for bit the one-block kernel.
#pragma once

#include <cooperative_groups.h>

#include "tq_crown.cuh"
#include "tq_lanes.cuh"

namespace tq {

constexpr int kSysCluster = 8;   // blocks a cluster (the portable maximum)
constexpr int kSysThreads = 512; // threads a block
// shared memory a block gives to the sweeps' rings
constexpr int kSysRingBytes = 96 * 1024;

struct SystemArgs {
  const float *Ls, *CUs, *CholW, *CholUt;
  const int *lev_ptr, *lev_child, *lev_parent, *lev_slot, *g_of, *slot;
  float *rv, *ycr, *dg;
  int S, L, n, K, n_lev;
  int groups;  // sweep lane groups a block (ring_shape)
  int vec16;   // 16-byte ring copies (even n, factors 16-byte aligned)
};

// The lane groups of this block that take part in the sweeps (a.groups a
// block, whole warps) stride over the chains: in round r, group q of block
// b takes chain (r kSysCluster + b) groups + q. The same group takes the
// same chain in both sweeps.
template <int GL, typename Body>
__device__ __forceinline__ void for_each_chain(const SystemArgs& a, float* smem, int b,
                                               Body body) {
  const int q = threadIdx.x / GL;
  if (q >= a.groups) return;  // whole warps
  const int total = kSysCluster * a.groups;
  float* ring = smem + (size_t)q * kSweepStages * sweep_stage_floats(a.n);
  for (int r = 0; r * total < a.S; ++r)
    body(ring, threadIdx.x % GL, r * total + b * a.groups + q);
}

// Phase 1 on the right-hand side rch [S, L, n]: emit(s, live, i, j, y)
// takes lane i's row of y_j of chain s (live: s < S).
template <int GL, typename Emit>
__device__ __forceinline__ void chain_bwd(const SystemArgs& a, float* smem, int b,
                                          const float* rch, Emit emit) {
  for_each_chain<GL>(a, smem, b, [&](float* ring, int i, int s) {
    const SweepGroup<GL> g(ring, i, s, a.Ls, a.CUs, rch, a.S, a.L, a.n);
    const float radd = sweep_bwd(g, a.L, a.n, a.vec16,
                                 [&](int j, float y) { emit(s, g.live, i, j, y); });
    if (g.live && i < a.n) a.rv[(size_t)a.g_of[s] * a.K * a.n + a.slot[s] * a.n + i] -= radd;
  });
}

// Phase 3 from phase 1's ys [S, L, n]: pre(s, live, i, j) as step j starts,
// emit(s, live, i, j, d) with lane i's row of dch_j.
template <int GL, typename Pre, typename Emit>
__device__ __forceinline__ void chain_fwd(const SystemArgs& a, float* smem, int b,
                                          const float* ys, Pre pre, Emit emit) {
  for_each_chain<GL>(a, smem, b, [&](float* ring, int i, int s) {
    const SweepGroup<GL> g(ring, i, s, a.Ls, a.CUs, ys, a.S, a.L, a.n);
    const int sl = g.live ? s : a.S - 1;
    const float* droot = a.dg + (size_t)a.g_of[sl] * a.K * a.n + a.slot[sl] * a.n;
    sweep_fwd(
        g, droot, a.L, a.n, a.vec16, [&](int j) { pre(s, g.live, i, j); },
        [&](int j, float d) { emit(s, g.live, i, j, d); });
  });
}

// Phase 2's operands: the crown's part of a.
__device__ __forceinline__ CrownArgs crown_args(const SystemArgs& a) {
  CrownArgs c;
  c.CholW = a.CholW; c.CholUt = a.CholUt;
  c.lev_ptr = a.lev_ptr; c.lev_child = a.lev_child; c.lev_parent = a.lev_parent;
  c.lev_slot = a.lev_slot;
  c.rv = a.rv; c.ycr = a.ycr; c.dg = a.dg;
  c.n = a.n; c.K = a.K; c.n_lev = a.n_lev;
  return c;
}

// Phase 2: tq_crown.cuh's crown solve on the cluster (its warps, or block
// 0's threads where a group is wider than a warp); ends behind the
// cluster's barrier. stamp(k): crown_solve_warps'.
template <typename Stamp>
__device__ __forceinline__ void crown(const SystemArgs& a, Stamp stamp) {
  static_assert(kSysCluster == ClusterTeam::kBlocks, "the crown runs on the whole cluster");
  crown(ClusterTeam(), crown_args(a), stamp);
}

// The sweep groups a block can hold rings for, in whole warps, and the
// shared memory they take (GL lanes a group, blocks of kSysThreads).
inline void ring_shape(int n, int GL, int* groups, size_t* bytes) {
  const size_t per = (size_t)kSweepStages * sweep_stage_floats(n) * sizeof(float);
  const int warp_groups = 32 / GL;
  int q = (int)(kSysRingBytes / per) / warp_groups * warp_groups;
  if (q > kSysThreads / GL) q = kSysThreads / GL;
  if (q < warp_groups) q = warp_groups;
  *groups = q;
  *bytes = q * per;
}

}  // namespace tq

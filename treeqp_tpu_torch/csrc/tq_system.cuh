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
// run a warp a group (lane i row i, G <= 32 rows) on the cluster's warps;
// wider groups run tq_crown.cuh's per-thread crown_solve_core in block 0.
// Every sum keeps the order of the per-thread bodies this replaced
// (tq_dense.cuh's ltrsv_inplace / uttrsv_inplace and crown_solve_core),
// each product one FMA as nvcc contracted them there and the divisions
// true divisions: bit for bit the one-block kernel.
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

// The crown's solve with one warp per group, lane i owning row i of the
// group's G <= 32 rows (crown_solve_core's sums in its order): the triangular
// solves as in the chain sweeps, G rounds of a division and a shuffle.
constexpr int kSysW = 32;

// y = Lg^-1 r for the G x G lower factor Lg, lane i holding r_i in acc;
// every lane calls onk(k, y_k) as y_k is broadcast. Returns y_i.
template <typename OnK>
__device__ __forceinline__ float warp_ltrsv(const float* Lg, float acc, int G, int i,
                                            OnK onk) {
  float Lrow[kSysW];
  float diag = 1.f;
#pragma unroll
  for (int m = 0; m < kSysW; ++m) {
    Lrow[m] = m < G && i < G && m <= i ? Lg[i * G + m] : 0.f;
    if (m == i && i < G) diag = Lrow[m];
  }
  float y = 0.f;
#pragma unroll
  for (int k = 0; k < kSysW; ++k) {
    if (k < G) {
      const float yk = __shfl_sync(kFull, quotient(acc, diag, i == k), k);
      if (i > k) acc = __fmaf_rn(-Lrow[k], yk, acc);
      if (i == k) y = yk;
      onk(k, yk);
    }
  }
  return y;
}

// z = Lg^-T v, lane i holding v_i in acc; returns z_i.
__device__ __forceinline__ float warp_uttrsv(const float* Lg, float acc, int G, int i) {
  float Lcol[kSysW], z[kSysW];
  float diag = 1.f;
#pragma unroll
  for (int m = 0; m < kSysW; ++m) {
    Lcol[m] = m < G && i < G && m >= i ? Lg[m * G + i] : 0.f;
    if (m == i && i < G) diag = Lcol[m];
    z[m] = 0.f;
  }
  float out = 0.f;
#pragma unroll
  for (int k = kSysW - 1; k >= 0; --k) {
    if (k < G) {
      float v = acc;
#pragma unroll
      for (int m = k + 1; m < kSysW; ++m)
        if (m < G) v = __fmaf_rn(-Lcol[m], z[m], v);
      z[k] = __shfl_sync(kFull, quotient(v, diag, i == k), k);
      if (i == k) out = z[k];
    }
  }
  return out;
}

// crown_solve_core's three parts on the cluster's warps, a group a warp,
// the cluster's barrier between levels: backward, deepest level first; the
// root (block 0's warp 0); forward, top level first. Every sum in
// crown_solve_core's order, each product one FMA as nvcc contracts it
// there: bit for bit that body. stamp(k) is called after the backward
// levels (k = 15), the root (16) and the forward levels (17).
template <typename Stamp>
__device__ void crown_solve_warps(cg::cluster_group& cluster, const SystemArgs& a, int b,
                                  Stamp stamp) {
  const int n = a.n, G = a.K * a.n;
  const int i = threadIdx.x % kSysW, nwb = blockDim.x / kSysW;
  const int w = b * nwb + threadIdx.x / kSysW, nw = kSysCluster * nwb;  // the cluster's warps
  const size_t GG = (size_t)G * G;
  for (int lv = 0; lv < a.n_lev; ++lv) {
    for (int e = a.lev_ptr[lv] + w; e < a.lev_ptr[lv + 1]; e += nw) {
      const int g = a.lev_child[e];
      const float* U = a.CholUt + (size_t)g * n * G;
      float Urow[kSysW];  // row i of CholUt_g (i < n)
#pragma unroll
      for (int k = 0; k < kSysW; ++k) Urow[k] = i < n && k < G ? U[i * G + k] : 0.f;
      float racc = 0.f;
      const float y = warp_ltrsv(a.CholW + g * GG, i < G ? a.rv[(size_t)g * G + i] : 0.f, G,
                                 i, [&](int k, float yk) { racc = __fmaf_rn(Urow[k], yk, racc); });
      if (i < G) a.ycr[(size_t)g * G + i] = y;
      if (i < n) a.rv[(size_t)a.lev_parent[e] * G + a.lev_slot[e] * n + i] -= racc;
    }
    cluster.sync();
  }
  stamp(15);
  if (w == 0) {
    const float y = warp_ltrsv(a.CholW, i < G ? a.rv[i] : 0.f, G, i, [](int, float) {});
    if (i < G) a.ycr[i] = y;
    const float z = warp_uttrsv(a.CholW, y, G, i);
    if (i < G) a.dg[i] = z;
  }
  cluster.sync();
  stamp(16);
  for (int lv = a.n_lev - 1; lv >= 0; --lv) {
    for (int e = a.lev_ptr[lv] + w; e < a.lev_ptr[lv + 1]; e += nw) {
      const int g = a.lev_child[e];
      const float* dp = a.dg + (size_t)a.lev_parent[e] * G + a.lev_slot[e] * n;
      const float* U = a.CholUt + (size_t)g * n * G;
      float acc = 0.f;
      for (int q = 0; q < n; ++q) acc = __fmaf_rn(i < G ? U[q * G + i] : 0.f, dp[q], acc);
      const float v = i < G ? a.ycr[(size_t)g * G + i] - acc : 0.f;
      const float z = warp_uttrsv(a.CholW + g * GG, v, G, i);
      if (i < G) a.dg[(size_t)g * G + i] = z;
    }
    cluster.sync();
  }
  stamp(17);
}

// Phase 2: the crown on the cluster's warps, or in block 0 where a group
// is wider than a warp; ends behind the cluster's barrier.
template <typename Stamp>
__device__ __forceinline__ void crown(cg::cluster_group& cluster, const SystemArgs& a,
                                      int b, Stamp stamp) {
  if (a.K * a.n <= kSysW) {
    crown_solve_warps(cluster, a, b, stamp);
  } else {
    if (b == 0)
      crown_solve_core(a.CholW, a.CholUt, a.lev_ptr, a.lev_child, a.lev_parent, a.lev_slot,
                       a.rv, a.ycr, a.dg, a.n, a.K, a.n_lev);
    cluster.sync();
  }
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

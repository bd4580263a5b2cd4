// Level-synchronous tree block Cholesky of the crown and its solve: the
// factorization on the warps of one thread-block cluster, shared by
// crown_blocks_factor.cu and crown_factor.cu, and the solve on the warps of
// one cluster or one block (a thread a group past G = 32), shared by
// crown_solve.cu and tq_system.cuh (system_solve.cu, newton_iter.cu).
//
// The level schedule lists, deepest parent stage first, each level's
// entries e in [lev_ptr[lv], lev_ptr[lv+1]): the group lev_child[e] that
// level factorizes, its parent group lev_parent[e] and its kid slot
// lev_slot[e] there. Warps (the factorization) or threads (the solve)
// stride over a level's entries; a barrier separates the levels. Every
// (parent, slot) has exactly one child, so the child-to-parent updates
// need no atomics. The TPU kernels moved them with one-hot [K, NPg, NPg]
// lane matmuls; here they are indexed reads and writes. Groups are G x G
// with G = K n.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "tq_lanes.cuh"

namespace tq {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// The factorization: one cluster of kCrownCluster blocks, a warp a group.
// The warp holds the group's block W_g (rows 0 .. G-1) and its couplings
// Ut_g (rows G .. G+n-1) as one stack of G + n rows, lane i rows i + 32 s
// (s < R, R = ceil((G + n) / 32) <= 3), in registers indexed at compile time
// by loops unrolled to the 32 (s + 1) columns a slot can need (at most 64),
// in chunks of kChunk columns that a uniform branch skips where a step has
// no work; the loop over the steps runs to the runtime G, so the code stays
// small: unrolled whole, the factorization outgrew the instruction cache,
// and a branch or a condition on every entry multiplies the instructions a
// step issues, which a single warp issues at ~1 every 3 cycles (PERF.md).
// The coupling rows ride along the Cholesky's steps: CholUt = Ut CholW^-T
// takes column k's broadcast entries as the block's rows below k do, and
// divides where they multiply.

constexpr int kCrownCluster = 8;
constexpr int kChunk = 8;  // columns a uniform branch covers

// The most warps a block may have: 128 registers a thread (one row a
// lane), 255 (two or three rows).
__host__ __device__ constexpr int crown_max_warps(int R) { return R == 1 ? 16 : 8; }

// Rows a lane holds: the stack of the block's G rows and the n coupling
// rows over the warp.
__host__ __device__ constexpr int crown_rows(int G, int n) { return (G + n + 31) / 32; }

// Shared memory floats a warp needs to factor a group: the factor [G][G+1]
// and CholUt [n][G+1] on their way out (the odd stride puts the lanes' rows
// on distinct banks), rounded up to 4.
__host__ __device__ constexpr int crown_factor_floats(int G, int n) {
  return ((G + n) * (G + 1) + 3) & ~3;
}

// Write ``rows`` rows of G floats at sm (stride P) to out, coalesced, 8 rows at a time
// (their shared-memory reads before their stores); with ``lower`` the
// entries above the diagonal are 0.
__device__ __forceinline__ void rows_out(float* out, const float* sm, int rows, int G, int P,
                                         bool lower, int i) {
  for (int r0 = 0; r0 < rows; r0 += 8) {
    float v[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = r0 + j, c = i + 32 * s;
        v[j][s] = r < rows && c < G && (!lower || c <= r) ? sm[r * P + c] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = r0 + j, c = i + 32 * s;
        if (r < rows && c < G) out[(size_t)r * G + c] = v[j][s];
      }
  }
}

// The level schedule's ints in shared memory: lev_ptr [n_lev + 1], then
// lev_child, lev_parent, lev_slot [NpG - 1] each.
__host__ __device__ constexpr int crown_sched_ints(int NpG, int n_lev) {
  return n_lev + 1 + 3 * (NpG - 1);
}

// Copy the level schedule into shared memory (the block's threads; the
// caller synchronizes the block before reading it).
__device__ inline void crown_sched_load(int* ss, const int* lev_ptr, const int* lev_child,
                                        const int* lev_parent, const int* lev_slot, int NpG,
                                        int n_lev) {
  const int E = NpG - 1;
  for (int e = threadIdx.x; e <= n_lev; e += blockDim.x) ss[e] = lev_ptr[e];
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    ss[n_lev + 1 + e] = lev_child[e];
    ss[n_lev + 1 + E + e] = lev_parent[e];
    ss[n_lev + 1 + 2 * E + e] = lev_slot[e];
  }
}

// The two halves of the cluster's barrier (release / acquire at cluster
// scope): work between them overlaps the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The Schur block's entries (a, c), c <= a < n, a lane takes: p = i + 32 t.
constexpr int kSchurRounds = (kMaxN * (kMaxN + 1) / 2 + 31) / 32;

// The row of entry p of the lower triangle, row by row.
__device__ __forceinline__ int tri_row(int p) {
  int a = 0;
  while ((a + 1) * (a + 2) / 2 <= p) ++a;
  return a;
}

// Columns a lane's row slot s can need: a row of the block at most 32 (s + 1),
// a coupling row G <= 64.
__host__ __device__ constexpr int slot_cols(int s) {
  return 32 * (s + 1) < 64 ? 32 * (s + 1) : 64;
}

// The lane's rows of the stack [W; Ut] into registers: row r < G of the G x
// G block at W (lower part, reg added to the diagonal), row G + q of the
// n x G couplings at Ut (none when Ut is null), 0 past them. Rows are read
// whole, 16 bytes at a time where they are aligned.
template <int R>
__device__ __forceinline__ void load_rows(float (&a)[R][64], const float* W, const float* Ut,
                                          int G, int n, float reg, int i) {
  const int rows = G + (Ut != nullptr ? n : 0);
  const bool vec = G % 4 == 0 && (((uintptr_t)W | (uintptr_t)Ut) & 15) == 0;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    constexpr int kC = 64;
    const int r = i + 32 * s;
    const bool in = r < rows;
    const float* row = r < G ? W + (size_t)r * G : Ut + (size_t)(in ? r - G : 0) * G;
    if (!in) row = W;
    if (vec) {
#pragma unroll
      for (int c = 0; c < kC; c += 4) {
        if (c < slot_cols(s)) {
          const float4 v = c < G && in ? *reinterpret_cast<const float4*>(row + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
          a[s][c] = v.x;
          a[s][c + 1] = v.y;
          a[s][c + 2] = v.z;
          a[s][c + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (c < slot_cols(s)) a[s][c] = c < G && in ? row[c] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (c < slot_cols(s)) {
        const float v = r < G ? (c <= r ? a[s][c] : 0.f) : a[s][c];
        a[s][c] = c == r ? __fadd_rn(v, reg) : v;
      }
    }
  }
}

// One group's factorization on the calling warp (every lane calls), from
// the stack a (load_rows' form; couplings when Uout is given), in the order
// of the thread-per-group kernel this replaced (chol_inplace<true> of
// tq_dense.cuh; its triangular solve acc = Ut_qj, acc -= X_qc L_jc for c
// ascending, X_qj = acc / L_jj; the Schur product), each product folded in
// by one FMA as nvcc contracted those bodies: bit for bit that kernel.
//   Lout = CholW_g = chol(W_g + reg I)  (pivot floor 1e-8, clamped diagonal;
//     0 above the diagonal),
//   Uout = CholUt_g = Ut_g CholW_g^-T   (true divisions),
//   W[parent][off.., off..] -= CholUt_g CholUt_g'  (with Wpar; the lower
//     triangle, the only part the parent's factorization reads); unless
//     ``early``, after before_schur() (the caller's barrier for the
//     parent's block).
// Wpar: the parent's block, whose (off + a, off + c) entries no other warp
// writes. sm: the warp's crown_factor_floats(G, n) floats.
// Step k = 0 .. G-1, right-looking: row k's pivot d (broadcast, its rsqrt
// taken during the step before); the block's rows r >= k scale their
// column-k entry, L_rk = a_rk rsqrt(d) (the diagonal d rsqrt(d)), and the
// coupling rows divide theirs, x_qk = a_qk / L_kk; column k's entries L_ck
// are broadcast and every row folds a_rc -= L_rk L_ck (c <= r) or
// x_qc -= x_qk L_ck by one FMA: each element meets its products in
// ascending k, the order of the left-looking chol_inplace and of that
// solve. Then the Schur block, an entry a lane, summed over k ascending
// from 0.
template <int R, typename BeforeSchur>
__device__ __forceinline__ void warp_factor_regs(float (&a)[R][64], float* Lout, float* Uout,
                                                 float* Wpar, int off, int G, int n, float* sm,
                                                 int i, bool early, BeforeSchur before_schur) {
  const int P = G + 1;
  float* sU = sm + G * P;
  const int nq = Uout != nullptr ? n : 0;  // coupling rows
  // the parent's entries this lane updates (no other warp writes them):
  // read at once where the parent's block is complete (early), else after
  // before_schur()
  const int npairs = n * (n + 1) / 2;
  float wp[kSchurRounds];
  const auto load_wp = [&]() {
#pragma unroll
    for (int t = 0; t < kSchurRounds; ++t) {
      const int p = i + 32 * t;
      if (p < npairs) {
        const int ra = tri_row(p), c = p - ra * (ra + 1) / 2;
        wp[t] = Wpar[(size_t)(off + ra) * G + off + c];
      }
    }
  };
  if (Wpar != nullptr && early) load_wp();
  __syncwarp();  // the previous group's reads of sm are done

  // Each step updates every row's entries of the active chunks without a
  // per-entry condition: the entries it should leave (above a row's
  // diagonal, left of the step's column, past the coupling rows' G
  // columns, the idle rows) are never read again, so what lands there does
  // not matter.
  bool cq[R];   // the lane's rows that are coupling rows
  float nv[R];  // the entries of the step's column in the lane's rows
  float xq[R];  // the coupling rows' quotients for the step
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = i + 32 * s;
    cq[s] = r >= G && r < G + nq;
    nv[s] = a[s][0];
    xq[s] = 0.f;
  }
  float d = fmaxf(__shfl_sync(kFull, nv[0], 0), kPivotFloor);
  float dinv = rsqrtf(d);
  // the coupling rows' quotients of column k: a_qk / L_kk, true divisions
  // (the other lanes divide L_kk by itself), taken with the step's pivot
  const auto quotients = [&](float* out, float dk, float dinvk) {
    const float Lkk = __fmul_rn(dk, dinvk);
#pragma unroll
    for (int s = 0; s < R; ++s)
      if (G < 32 * (s + 1) && G + nq > 32 * s) out[s] = quotient(nv[s], Lkk, cq[s]);
  };
  quotients(xq, d, dinv);
  for (int k = 0; k < G; ++k) {
    float l[R], x[R];  // the row's column-k factor entry; what the row folds
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int r = i + 32 * s;
      l[s] = __fmul_rn(r == k ? d : nv[s], dinv);
      x[s] = cq[s] ? xq[s] : l[s];
      if (r >= k && r < G) sm[r * P + k] = l[s];
      if (cq[s]) sU[(r - G) * P + k] = xq[s];
    }
    float dn = 1.f, dinvn = 1.f;
#pragma unroll
    for (int c0 = 0; c0 < 64; c0 += kChunk) {
      if (c0 < slot_cols(R - 1) && c0 + kChunk > k + 1 && c0 < G) {
#pragma unroll
        for (int c = c0; c < c0 + kChunk; ++c) {
          const float lck = __shfl_sync(kFull, l[c / 32 < R ? c / 32 : R - 1], c & 31);
#pragma unroll
          for (int s = 0; s < R; ++s)
            if (c < slot_cols(s)) a[s][c] = __fmaf_rn(-x[s], lck, a[s][c]);
        }
        if (c0 <= k + 1 && k + 1 < G) {
          // the chunk of column k + 1: its entries (a select tree on the
          // column's place in the chunk), the next pivot and quotients
          const int t = k + 1 - c0;
#pragma unroll
          for (int s = 0; s < R; ++s) {
            float v[kChunk];
#pragma unroll
            for (int j = 0; j < kChunk; ++j) v[j] = c0 + j < slot_cols(s) ? a[s][c0 + j] : 0.f;
#pragma unroll
            for (int h = 1; h < kChunk; h *= 2)
#pragma unroll
              for (int j = 0; j < kChunk; j += 2 * h) v[j] = t & h ? v[j + h] : v[j];
            nv[s] = v[0];
          }
          const int k1 = k + 1;
          dn = fmaxf(__shfl_sync(kFull, R == 1 || k1 < 32 ? nv[0] : nv[R > 1 ? 1 : 0], k1 & 31),
                     kPivotFloor);
          dinvn = rsqrtf(dn);
          quotients(xq, dn, dinvn);
        }
      }
    }
    d = dn;
    dinv = dinvn;
  }
  __syncwarp();
  // the factors out, coalesced
  rows_out(Lout, sm, G, G, P, true, i);
  if (nq == 0) return;
  rows_out(Uout, sU, n, G, P, false, i);
  if (Wpar == nullptr) return;
  if (!early) {
    before_schur();
    load_wp();
  }
  // the Schur block, an entry (a, c) a lane, subtracted from the parent's
#pragma unroll
  for (int t = 0; t < kSchurRounds; ++t) {
    const int p = i + 32 * t;
    if (p < npairs) {
      const int ra = tri_row(p), c = p - ra * (ra + 1) / 2;
      const float* ua = sU + ra * P;
      const float* uc = sU + c * P;
      float acc = 0.f;
#pragma unroll 4
      for (int k = 0; k < G; ++k) acc = __fmaf_rn(ua[k], uc[k], acc);
      Wpar[(size_t)(off + ra) * G + off + c] = __fsub_rn(wp[t], acc);
    }
  }
}

// The levels, deepest first, and then the root group 0, on the cluster's
// warps. The caller has done its share of phase 1 (every group off the
// deepest level in CholW and, but the root, its couplings at Uin) and
// arrived at the cluster's barrier; the deepest level's groups come from
// fill0(g, a) (load_rows' form), and the barrier's wait
// comes before a lane's first Schur update of a parent's block, so that
// phase 1 overlaps the deepest level's factorizations. After each level
// the cluster's barrier (release / acquire at cluster scope) orders the
// parents' updated blocks, which other blocks of the cluster wrote, before
// the parents' own level. A level's entries go to the warps interleaved
// over the blocks (warp q of block b is warp q kCrownCluster + b), so that a
// narrow level spreads over all the cluster's SMs. ss: the schedule
// (crown_sched_load), its block synchronized. CholW and CholUt are read
// after other blocks wrote them: plain loads, no read-only path. No barrier
// after the root: the launch ends there.
template <int R, typename Fill0>
__device__ __forceinline__ void crown_factor_warps(cg::cluster_group& cluster, float* CholW,
                                                   float* CholUt, const float* Uin,
                                                   const int* ss, int NpG, int n_lev, int K,
                                                   int n, float reg, float* sm, Fill0 fill0) {
  const int G = K * n, E = NpG - 1;
  const size_t GG = (size_t)G * G, UG = (size_t)n * G;
  const int i = threadIdx.x % 32;
  // the warp's number, read from lane 0 so that the compiler knows it is
  // the same on every lane (without, every shuffle below checks for a
  // divided warp)
  const int w = __shfl_sync(kFull, (threadIdx.x / 32) * kCrownCluster + (int)cluster.block_rank(), 0);
  const int nw = kCrownCluster * (blockDim.x / 32);
  const int* child = ss + n_lev + 1;
  bool waiting = true;  // phase 1's barrier, arrived at, not yet waited for
  const auto wait_once = [&]() {
    if (waiting) cluster_wait();
    waiting = false;
  };
  for (int lv = 0; lv < n_lev; ++lv) {
    for (int e = ss[lv] + w; e < ss[lv + 1]; e += nw) {
      const int g = child[e];
      float a[R][64];
      if (lv == 0)
        fill0(g, a);
      else
        load_rows<R>(a, CholW + g * GG, Uin + g * UG, G, n, reg, i);
      warp_factor_regs<R>(a, CholW + g * GG, CholUt + g * UG, CholW + child[E + e] * GG,
                          child[2 * E + e] * n, G, n, sm, i, !waiting, wait_once);
    }
    wait_once();
    cluster.sync();
  }
  wait_once();
  if (w == 0) {
    float a[R][64];
    load_rows<R>(a, CholW, nullptr, G, n, reg, i);
    warp_factor_regs<R>(a, CholW, nullptr, nullptr, 0, G, n, sm, i, true, [] {});
  }
}

// Solve with the stored factors. The caller fills rv [NpG, G] with the
// right-hand side, zeroes dg [NpG, G] and synchronizes the block. Then:
//   backward, deepest level first: y_g = CholW_g^-1 rv_g (kept in ycr),
//     rv[parent][slot] -= CholUt_g y_g;
//   root: dg_0 = CholW_0^-T CholW_0^-1 rv_0;
//   forward, top level first: dg_g = CholW_g^-T (y_g - CholUt_g' dg[parent][slot]);
// with a barrier after each level and after the root, so dg is complete on
// return.
__device__ inline void crown_solve_core(
    const float* __restrict__ CholW, const float* __restrict__ CholUt,
    const int* __restrict__ lev_ptr, const int* __restrict__ lev_child,
    const int* __restrict__ lev_parent, const int* __restrict__ lev_slot,
    float* __restrict__ rv, float* __restrict__ ycr, float* __restrict__ dg,
    int n, int K, int n_lev) {
  const int G = K * n;
  const size_t GG = (size_t)G * G;

  // backward sweep
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

  // root
  if (threadIdx.x == 0) {
    for (int i = 0; i < G; ++i) ycr[i] = rv[i];
    ltrsv_inplace(CholW, ycr, G);
    for (int i = 0; i < G; ++i) dg[i] = ycr[i];
    uttrsv_inplace(CholW, dg, G);
  }
  __syncthreads();

  // forward substitution
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
}

// ---------------------------------------------------------------------------
// The solve on warps: a warp a group, lane i owning row i of the group's
// G <= kCrownW rows, every sum in crown_solve_core's order, each product
// one FMA as nvcc contracts it there and the divisions true divisions
// (quotient): bit for bit that body.

constexpr int kCrownW = 32;  // rows a warp's group may have

// The crown's operands of the solve: the factors, the level schedule
// (crown_factor's) and the vectors rv (the right-hand side, updated in
// place by the backward sweep), ycr (its y) and dg (the solution), each
// [NpG, G] with G = K n.
struct CrownArgs {
  const float *CholW, *CholUt;
  const int *lev_ptr, *lev_child, *lev_parent, *lev_slot;
  float *rv, *ycr, *dg;
  int n, K, n_lev;
};

// The blocks that share the solve's levels and the barrier between them:
// one cluster of kCrownCluster blocks (the cluster's barrier, release /
// acquire at cluster scope, in two halves so that loads which do not
// depend on the other blocks' writes overlap it), or one block
// (__syncthreads, whose wait is the whole barrier). rank: the block's place.
struct ClusterTeam {
  static constexpr int kBlocks = kCrownCluster;
  int rank;
  __device__ ClusterTeam() : rank((int)cg::this_cluster().block_rank()) {}
  __device__ void arrive() const { cluster_arrive(); }
  __device__ void wait() const { cluster_wait(); }
  __device__ void sync() const {
    arrive();
    wait();
  }
};
struct BlockTeam {
  static constexpr int kBlocks = 1;
  int rank = 0;
  __device__ void arrive() const {}
  __device__ void wait() const { __syncthreads(); }
  __device__ void sync() const { __syncthreads(); }
};
// One of the two, its size chosen at launch (launch_team), so that one
// kernel serves both: one cluster of ``blocks`` blocks, or one block.
struct SizedTeam {
  int blocks, rank;
  __device__ explicit SizedTeam(int blocks_)
      : blocks(blocks_), rank(blocks_ > 1 ? (int)cg::this_cluster().block_rank() : 0) {}
  __device__ void arrive() const {
    if (blocks > 1) cluster_arrive();
  }
  __device__ void wait() const {
    if (blocks > 1) cluster_wait();
    else __syncthreads();
  }
  __device__ void sync() const {
    arrive();
    wait();
  }
};

constexpr int kMaxTeamBlocks = 16;  // blocks a cluster can have (8 portably)
constexpr size_t kMaxBlockSmem = 227 * 1024;  // the shared memory a block can have

// What a kernel launched by launch_team has been allowed so far: clusters
// of more than 8 blocks (not portable) and its dynamic shared memory.
struct TeamLimits {
  bool wide = false;
  size_t smem = 0;
};

// Launch ``kernel`` on one cluster of ``blocks`` blocks (one block: no
// cluster) of ``threads`` threads with ``bytes`` of dynamic shared memory,
// first raising the kernel's limits where this launch needs more than
// ``lim`` records.
template <typename... Params, typename... Args>
inline int launch_team(void (*kernel)(Params...), int blocks, int threads, size_t bytes,
                       TeamLimits& lim, cudaStream_t st, Args... args) {
  if (blocks < 1 || blocks > kMaxTeamBlocks || bytes > kMaxBlockSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (!lim.wide) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    lim.wide = true;
  }
  if (bytes > lim.smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    lim.smem = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = blocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}

// Lane i's row of the G x G lower factor Lg: the entries m <= i in Lrow
// (0 past them), the diagonal in diag (1 on the lanes past row G-1).
__device__ __forceinline__ void load_lrow(const float* Lg, int G, int i,
                                          float (&Lrow)[kCrownW], float& diag) {
  diag = 1.f;
#pragma unroll
  for (int m = 0; m < kCrownW; ++m) {
    Lrow[m] = m < G && i < G && m <= i ? Lg[i * G + m] : 0.f;
    if (m == i && i < G) diag = Lrow[m];
  }
}

// Lane i's column of Lg: the entries m >= i in Lcol (0 past them) and the
// diagonal, as load_lrow.
__device__ __forceinline__ void load_lcol(const float* Lg, int G, int i,
                                          float (&Lcol)[kCrownW], float& diag) {
  diag = 1.f;
#pragma unroll
  for (int m = 0; m < kCrownW; ++m) {
    Lcol[m] = m < G && i < G && m >= i ? Lg[m * G + i] : 0.f;
    if (m == i && i < G) diag = Lcol[m];
  }
}

// y = Lg^-1 r, lane i holding r_i in acc and its row of Lg (load_lrow);
// every lane calls onk(k, y_k) as y_k is broadcast. G rounds of a division
// and a shuffle. Returns y_i.
template <typename OnK>
__device__ __forceinline__ float warp_ltrsv(const float (&Lrow)[kCrownW], float diag,
                                            float acc, int G, int i, OnK onk) {
  float y = 0.f;
#pragma unroll
  for (int k = 0; k < kCrownW; ++k) {
    if (k < G) {
      const float yk = __shfl_sync(kFull, quotient(acc, diag, i == k), k);
      if (i > k) acc = __fmaf_rn(-Lrow[k], yk, acc);
      if (i == k) y = yk;
      onk(k, yk);
    }
  }
  return y;
}

// z = Lg^-T v, lane i holding v_i in acc and its column of Lg (load_lcol);
// every lane keeps the z_m solved so far and lane k folds its sum over m
// = k+1 .. G-1 ascending (uttrsv_inplace's order) before it divides.
// Returns z_i.
__device__ __forceinline__ float warp_uttrsv(const float (&Lcol)[kCrownW], float diag,
                                             float acc, int G, int i) {
  float z[kCrownW];
#pragma unroll
  for (int m = 0; m < kCrownW; ++m) z[m] = 0.f;
  float out = 0.f;
#pragma unroll
  for (int k = kCrownW - 1; k >= 0; --k) {
    if (k < G) {
      float v = acc;
#pragma unroll
      for (int m = k + 1; m < kCrownW; ++m)
        if (m < G) v = __fmaf_rn(-Lcol[m], z[m], v);
      z[k] = __shfl_sync(kFull, quotient(v, diag, i == k), k);
      if (i == k) out = z[k];
    }
  }
  return out;
}

// crown_solve_core's three parts on the team's warps, a group a warp:
// backward, deepest level first; the root (the team's warp 0); forward,
// top level first; the team's barrier after each level and after the root,
// so dg is complete on return. A level's entries go to the warps
// interleaved over the blocks (warp q of block b is warp q kBlocks + b),
// so a narrow level spreads over the blocks' SMs. The factors are not
// written during the solve: a warp loads its first group's rows of the
// next level (or the root's) between the barrier's two halves. rv, ycr
// and dg cross blocks: plain loads after the barrier, never the read-only
// path. The caller has written rv and dg and passed the team's barrier.
// stamp(k) is called after the backward levels (k = 15), the root (16)
// and the forward levels (17).
template <typename Team, typename Stamp>
__device__ void crown_solve_warps(const Team& team, const CrownArgs& a, Stamp stamp) {
  const int n = a.n, G = a.K * a.n, L = a.n_lev;
  const int i = threadIdx.x % kCrownW;
  // the warp's number, read from lane 0 so that the compiler knows it is
  // the same on every lane
  const int w = __shfl_sync(kFull, (threadIdx.x / kCrownW) * Team::kBlocks + team.rank, 0);
  const int nw = Team::kBlocks * (blockDim.x / kCrownW);
  const size_t GG = (size_t)G * G;
  // the warp's next group: backward, row i of CholW_g (F) and of CholUt_g
  // (U); the root, row (F) and column (U) i of CholW_0; forward, column i
  // of CholW_g (F) and of CholUt_g (U, n entries)
  float F[kCrownW], U[kCrownW], diag;
  const auto fetch_bwd = [&](int e) {
    const int g = a.lev_child[e];
    load_lrow(a.CholW + g * GG, G, i, F, diag);
    const float* Ug = a.CholUt + (size_t)g * n * G;
#pragma unroll
    for (int k = 0; k < kCrownW; ++k) U[k] = i < n && k < G ? Ug[i * G + k] : 0.f;
  };
  const auto fetch_root = [&]() {
    load_lrow(a.CholW, G, i, F, diag);
    load_lcol(a.CholW, G, i, U, diag);
  };
  const auto fetch_fwd = [&](int e) {
    const int g = a.lev_child[e];
    load_lcol(a.CholW + g * GG, G, i, F, diag);
    const float* Ug = a.CholUt + (size_t)g * n * G;
#pragma unroll
    for (int q = 0; q < kMaxN; ++q) U[q] = q < n && i < G ? Ug[q * G + i] : 0.f;
  };
  // the warp's first entry of level lv, fetched where it has one
  const auto first_bwd = [&](int lv) {
    const int e = a.lev_ptr[lv] + w;
    if (e < a.lev_ptr[lv + 1]) fetch_bwd(e);
    return e;
  };
  const auto first_fwd = [&](int lv) {
    const int e = a.lev_ptr[lv] + w;
    if (e < a.lev_ptr[lv + 1]) fetch_fwd(e);
    return e;
  };

  // backward sweep
  int e = 0;
  if (L > 0)
    e = first_bwd(0);
  else if (w == 0)
    fetch_root();
  for (int lv = 0; lv < L; ++lv) {
    for (const int e0 = e; e < a.lev_ptr[lv + 1]; e += nw) {
      if (e != e0) fetch_bwd(e);
      const int g = a.lev_child[e];
      float racc = 0.f;
      const float y = warp_ltrsv(F, diag, i < G ? a.rv[(size_t)g * G + i] : 0.f, G, i,
                                 [&](int k, float yk) { racc = __fmaf_rn(U[k], yk, racc); });
      if (i < G) a.ycr[(size_t)g * G + i] = y;
      if (i < n) a.rv[(size_t)a.lev_parent[e] * G + a.lev_slot[e] * n + i] -= racc;
    }
    team.arrive();
    if (lv + 1 < L)
      e = first_bwd(lv + 1);
    else if (w == 0)
      fetch_root();
    team.wait();
  }
  stamp(15);
  // root
  if (w == 0) {
    const float y = warp_ltrsv(F, diag, i < G ? a.rv[i] : 0.f, G, i, [](int, float) {});
    if (i < G) a.ycr[i] = y;
    const float z = warp_uttrsv(U, diag, y, G, i);
    if (i < G) a.dg[i] = z;
  }
  team.arrive();
  if (L > 0) e = first_fwd(L - 1);
  team.wait();
  stamp(16);
  // forward substitution
  for (int lv = L - 1; lv >= 0; --lv) {
    for (const int e0 = e; e < a.lev_ptr[lv + 1]; e += nw) {
      if (e != e0) fetch_fwd(e);
      const int g = a.lev_child[e];
      const float* dp = a.dg + (size_t)a.lev_parent[e] * G + a.lev_slot[e] * n;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxN; ++q)
        if (q < n) acc = __fmaf_rn(U[q], dp[q], acc);
      const float v = i < G ? a.ycr[(size_t)g * G + i] - acc : 0.f;
      const float z = warp_uttrsv(F, diag, v, G, i);
      if (i < G) a.dg[(size_t)g * G + i] = z;
    }
    team.arrive();
    if (lv > 0) e = first_fwd(lv - 1);
    team.wait();
  }
  stamp(17);
}

// The crown's solve on the team: on its warps for G <= kCrownW, else
// crown_solve_core on the threads of the team's block 0 (a thread a
// group); ends behind the team's barrier.
template <typename Team, typename Stamp>
__device__ __forceinline__ void crown(const Team& team, const CrownArgs& a, Stamp stamp) {
  if (a.K * a.n <= kCrownW) {
    crown_solve_warps(team, a, stamp);
  } else {
    if (team.rank == 0)
      crown_solve_core(a.CholW, a.CholUt, a.lev_ptr, a.lev_child, a.lev_parent, a.lev_slot,
                       a.rv, a.ycr, a.dg, a.n, a.K, a.n_lev);
    team.sync();
  }
}

}  // namespace tq

// The IPM's crown tree-Riccati recursion, factorize and solve, each in one
// launch of one thread-block cluster or one block, a group of lanes per
// single-kid run of the tree.
//
// Replaces the Pallas kernels crown_ric_factor and crown_ric_solve of
// treeqp_tpu/ops/crown_riccati.py (reached through
// ipm_multistage.ipm_ms_solve on box-only trees and ipm.ipm_solve on
// diagonal box-only trees, on their f32-factored iterations with
// chain_backend="pallas"). Tensors are node-major [Nc, ...].
//
// The schedule (ops/crown_riccati._get_sched) cuts the tree into runs: a
// run starts at the root, at a leaf or at a node with two or more kids,
// and climbs through every node that is its parent's only kid (the root
// excepted); its nodes are run_node[run_ptr[r] .. run_ptr[r+1]), deepest
// first. A run's phase is one past the latest phase of its first node's
// kids' runs (0 at a leaf); the runs of phase h are [ph_ptr[h],
// ph_ptr[h+1]), and the last phase is the root's run alone. Each node's
// kids are kid_idx[kid_ptr[n] .. kid_ptr[n+1]), ascending.
//   factor, phases in order: M = Wsum_n + diag(hbar_n) with Wsum_n =
//     Wsum0_n + (0 + W_kid1 + W_kid2 + ...) at a node with kids and Wsum0_n
//     at a leaf; tq_riccati.cuh's stage factors and W_n = AB_n' P_n AB_n;
//   solve: the backward sweep the same way with m = rg_n + wsum_n (wsum_n
//     from wsum0_n and the kids' w), p, k and w_n = AB_n'(P_n rb_n + p_n);
//     the root solves P_0 dx_0 = -p_0 (clamped Cholesky, no shift); the
//     forward sweep, phases in reverse, dx = AB_n dz_parent + rb_n, du = K
//     dx + k, dlam = P dx + p.
// Every sum of kids' terms keeps its kid order (no atomics, the same bits
// on every run). The TPU kernel computed every level on all lanes and moved
// the sums with a 0/1 [NPc, NPc] matmul per level; the crown here has no
// node or depth cap.
//
// What bounds it on the card: latency. A node is one Riccati stage (~2.7k
// flops at nx = 8, nz = 9; ~150 dependent FMAs a lane on a lane group) and
// the nodes of a path from a leaf to the root run in sequence: 5 on the
// 341-node crown of the spring-mass tree, 21 on its 4437-node whole tree.
// The bytes (each node's operands and factors, ~0.2 MB at 341 nodes) take
// ~0.1 us at the card's memory rate.
//
// The one-block kernels this replaces ran a thread a node, the stage's
// ~1300 dependent FMAs (factor) in one thread with M and T in local memory,
// then one thread a parent summing its kids' 81-float W in series, two
// barriers a level (0.58 ms at 341 nodes, 4.5 ms at 4437). Design:
// - A group of G = tq::ric_lanes(nz) lanes takes a run, lane i owning row i
//   of the stage (8 lanes for nz <= 8, 16 for nz <= 16, a warp for nz <=
//   32; one instantiation per nz = 2 .. 16, nz a template parameter, and
//   one for 16 < nz <= 32 with nz at run time: tq_riccati.cuh's kRicWide,
//   built by crown_ric_wide.cu; its blocks hold at most 8 warps, for the
//   registers of its 32-entry rows, max_threads). The stages are
//   tq_riccati.cuh's ric_stage_factor_lanes, ric_stage_bwd_lanes and
//   ric_stage_fwd_lanes, the chain kernels' (ric_chain.cu), their shuffles
//   on the group's lanes.
// - The team is one cluster of blocks (the cluster's barrier, release /
//   acquire) or, where the widest phase is narrow, one block
//   (__syncthreads); crown_riccati._ric_launch sizes it, and one kernel
//   per nz serves every size (cudaLaunchKernelEx's cluster dimension). A
//   phase's runs go to the groups interleaved over the blocks (group q of
//   block b is group q blocks + b), and stride over them where there are
//   more.
// - Along a run the group keeps W (w, dz) in registers: no barrier. A run's
//   top writes its W rows (w rows) to global memory, and after the barrier
//   the group of its parent's run folds its kids' rows in, lane i its row
//   i, in kid order; the forward sweep's run top reads its parent's dz.
//   These cross blocks: plain loads after the barrier, never the read-only
//   path.
// - Each node's operands stream through a ring of shared memory per group
//   with cp.async (the factor: AB_n, hbar_n, Wsum0_n; the backward sweep:
//   P, Lu, Mxu, AB, rg, rb, wsum0; the forward: P, K, AB, rb, p, k), up to
//   the ring's depth - 1 nodes ahead along the group's walk, so the next
//   phase's operands arrive while the team waits at the barrier.
// - The root's P_0 dx_0 = -p_0 runs on the root's group, lane x owning row
//   x of P_0 (the one-thread step took ~12 us of the solve's ~55 at 341
//   nodes).
// Every sum runs in the one-block kernels' order, each product folded in
// by one FMA as nvcc contracted their per-thread body (the first onto the
// 0 a sum starts from), the kid sums 0 + W_kid1 + ... and every other add
// rounded on its own, rsqrtf pivots and true divisions: bit for bit those
// kernels. No tensor cores: a stage is a dependent factorization and
// product chain of nz <= 32 rows; wgmma needs 64-row tiles.

#include "tq_crown.cuh"
#include "tq_riccati.cuh"

namespace {

// A block's threads: 512 (128 registers a thread) up to nz = 16, 256 (255
// registers, the most a thread may have) for the wide instantiation
__host__ __device__ constexpr int max_threads(int NZ) {
  return NZ <= tq::kRicNarrow ? 512 : 256;
}
constexpr int kFactorStages = 3;  // the factor's ring
constexpr int kSolveStages = 4;   // the solve's rings

// operands: hbar, AB, Wsum0, lev_ptr, lev_node, acc_ptr, acc_node, kid_ptr,
// kid_idx, P, Lu, K, Mxu, Wsum, Wc, ph_ptr, run_ptr, run_node (lev_ptr,
// lev_node, acc_ptr, acc_node and Wsum are not read)
struct FactorOps {
  const void* p[18];
};

// operands: P, Lu, K, Mxu, AB, rg, rb, wsum0, lev_ptr, lev_node, acc_ptr,
// acc_node, kid_ptr, kid_idx, par, p, k, wsum, wv, dz, dl, ph_ptr, run_ptr,
// run_node (lev_ptr, lev_node, acc_ptr, acc_node and wsum are not read)
struct SolveOps {
  const void* p[24];
};

template <class T>
__device__ inline T* arg(const void* p) {
  return static_cast<T*>(const_cast<void*>(p));
}

// The factor's ring stage: [AB_n (nx nz) | hbar_n (nz) | Wsum0_n (nz nz)],
// its stride rounded up to 4 floats; a group's shared memory: the ring,
// then the stage's five nz x nz work areas.
__host__ __device__ inline int factor_stage_floats(int nx, int nz) {
  return (nx * nz + nz + nz * nz + 3) & ~3;
}
__host__ __device__ inline int factor_group_floats(int nx, int nz) {
  return kFactorStages * factor_stage_floats(nx, nz) + 5 * nz * nz;
}

// The backward sweep's ring stage: [P (nx nx) | Lu (nu nu) | Mxu (nx nu) |
// AB (nx nz) | rg (nz) | rb (nx) | wsum0 (nz)], rounded up to 4 floats.
struct BwdStage {
  int P, Lu, Mxu, AB, rg, rb, w0, floats;
  __host__ __device__ BwdStage(int nx, int nz) {
    const int nu = nz - nx;
    P = 0;
    Lu = P + nx * nx;
    Mxu = Lu + nu * nu;
    AB = Mxu + nx * nu;
    rg = AB + nx * nz;
    rb = rg + nz;
    w0 = rb + nx;
    floats = (w0 + nz + 3) & ~3;
  }
};

// The forward sweep's: [P (nx nx) | K (nu nx) | AB (nx nz) | rb (nx) | p
// (nx) | k (nu)], rounded up to 4 floats.
struct FwdStage {
  int P, K, AB, rb, p, k, floats;
  __host__ __device__ FwdStage(int nx, int nz) {
    const int nu = nz - nx;
    P = 0;
    K = P + nx * nx;
    AB = K + nu * nx;
    rb = AB + nx * nz;
    p = rb + nx;
    k = p + nx;
    floats = (k + nu + 3) & ~3;
  }
};

// A group's shared memory in the solve: one ring of kSolveStages stages
// the two sweeps take in turn.
__host__ __device__ inline int solve_group_floats(int nx, int nz) {
  const int b = BwdStage(nx, nz).floats, f = FwdStage(nx, nz).floats;
  return kSolveStages * (b > f ? b : f);
}

// The blocks that share the phases and the barrier between them: one
// cluster of ``blocks`` blocks or one block, chosen at launch
// (tq_crown.cuh).
using Team = tq::SizedTeam;

// A group's walk over its nodes: the runs r of phase ph with (r -
// ph_ptr[ph]) % groups == g, phases from ph to end (exclusive) in steps of
// dir, a run's nodes deepest first (dir = 1) or top first (dir = -1). e is
// the node's entry in run_node; ph == end once the walk is over.
struct Walk {
  const int *ph_ptr, *run_ptr;
  int g, groups, dir, end;
  int ph, r, e;
  __device__ Walk(const int* ph_ptr_, const int* run_ptr_, int g_, int groups_, int ph0,
                  int end_, int dir_)
      : ph_ptr(ph_ptr_), run_ptr(run_ptr_), g(g_), groups(groups_), dir(dir_), end(end_),
        ph(ph0), r(0), e(0) {
    settle();
  }
  // the first node of the group's first run at or past phase ph
  __device__ void settle() {
    for (; ph != end; ph += dir) {
      r = ph_ptr[ph] + g;
      if (r < ph_ptr[ph + 1]) {
        e = first();
        return;
      }
    }
  }
  __device__ int first() const { return dir > 0 ? run_ptr[r] : run_ptr[r + 1] - 1; }
  __device__ int last() const { return dir > 0 ? run_ptr[r + 1] - 1 : run_ptr[r]; }
  __device__ void next() {
    if (e != last()) {
      e += dir;
      return;
    }
    r += groups;
    if (r < ph_ptr[ph + 1]) {
      e = first();
      return;
    }
    ph += dir;
    settle();
  }
  __device__ bool done() const { return ph == end; }
};

// The root's step on the group: P_0 dx_0 = -p_0 by the clamped Cholesky
// of P_0 (shift 0), du_0 = K_0 dx_0 + k_0 and dlam_0 = P_0 dx_0 + p_0, into
// dz_0 = [dx_0; du_0] and dl_0; lane x < nx holds p_x in ``pi``, lane nx + u
// k_u in ``ki`` (the root's backward step left them there), ``sL`` is nx nx
// floats of shared memory. Lane x owns row x of P_0 and of its factor L:
// the Cholesky right-looking (lane k's pivot broadcast by __shfl_sync,
// lanes x >= c folding a_xc -= L_xk L_ck in ascending k, the pivot floored
// at 1e-8 and the diagonal clamped), L y = p by nx rounds of a division
// and a shuffle, L' z = y with each lane's column of L from shared memory,
// then dx = -z broadcast and one fold each for du and dlam: every sum in
// the order of the per-thread Cholesky and solves (tq_dense.cuh), each
// product one FMA, true divisions.
template <int NZ, int G>
__device__ __forceinline__ void root_lanes(const float* P, const float* K, float pi, float ki,
                                           int nx, int nz, int i, unsigned mask, float* sL,
                                           float* dz, float* dl) {
  const int r = i < nx ? i : -1;  // row of P_0 and L (-1 past nx - 1)
  const int u = i - nx;           // row of K_0 on lanes nx .. nz-1
  const bool urow = u >= 0 && u < nz - nx;
  // lane x's row of P_0 (l becomes its row of L), lane nx + u's row of K_0
  float l[NZ], row[NZ];
#pragma unroll
  for (int c = 0; c < NZ; ++c) {
    row[c] = c >= nx ? 0.f : r >= 0 ? P[r * nx + c] : urow ? K[u * nx + c] : 0.f;
    l[c] = r >= 0 ? row[c] : 0.f;
    if (c == r) l[c] = __fadd_rn(l[c], 0.f);  // + the shift, 0
  }
#pragma unroll
  for (int k = 0; k < NZ; ++k) {
    if (k < nx) {
      const float akk = __shfl_sync(mask, l[k], k, G);
      const float d = fmaxf(akk, tq::kPivotFloor);
      const float dinv = rsqrtf(d);
      const float lrk = r == k ? __fmul_rn(d, dinv) : __fmul_rn(l[k], dinv);
      if (r >= k) l[k] = lrk;
#pragma unroll
      for (int c = k + 1; c < NZ; ++c) {
        if (c < nx) {
          const float lck = __shfl_sync(mask, lrk, c, G);
          if (r >= c) l[c] = __fmaf_rn(-lrk, lck, l[c]);
        }
      }
    }
  }
  float diag = 1.f;
#pragma unroll
  for (int c = 0; c < NZ; ++c) {
    if (c == r) diag = l[c];
    if (r >= 0 && c < nx) sL[r * nx + c] = l[c];
  }
  __syncwarp(mask);
  float lcol[NZ];  // lane x's column of L below the diagonal
#pragma unroll
  for (int m = 0; m < NZ; ++m) lcol[m] = r >= 0 && m > r && m < nx ? sL[m * nx + r] : 0.f;

  // L y = p, then L' z = y
  float acc = r >= 0 ? pi : 0.f, y = 0.f;
#pragma unroll
  for (int c = 0; c < NZ; ++c) {
    if (c < nx) {
      const float yc = __shfl_sync(mask, tq::quotient(acc, diag, r == c), c, G);
      if (r > c) acc = __fmaf_rn(-l[c], yc, acc);
      if (r == c) y = yc;
    }
  }
  float z[NZ];
#pragma unroll
  for (int c = NZ - 1; c >= 0; --c) {
    z[c] = 0.f;
    if (c < nx) {
      float a = y;
#pragma unroll
      for (int m = c + 1; m < NZ; ++m)
        if (m < nx) a = __fmaf_rn(-lcol[m], z[m], a);
      z[c] = __shfl_sync(mask, tq::quotient(a, diag, r == c), c, G);
    }
  }
  // dx = -z; du = K dx + k by lanes nx + u, dlam = P dx + p by lanes x
  float s = 0.f, dx = 0.f;
#pragma unroll
  for (int x = 0; x < NZ; ++x) {
    if (x < nx) s = __fmaf_rn(row[x], -z[x], s);
    if (x == r) dx = -z[x];
  }
  if (r >= 0) {
    dl[r] = __fadd_rn(s, pi);
    dz[r] = dx;
  } else if (urow) {
    dz[i] = __fadd_rn(s, ki);
  }
}

template <int NZ>
__device__ __forceinline__ void factor(const Team& team, const FactorOps& ops, int nx, int nz_,
                                       int n_ph, float reg) {
  constexpr int G = tq::ric_lanes(NZ);
  const int nz = tq::ric_nz<NZ>(nz_), nn = nz * nz;
  extern __shared__ __align__(16) float smem[];
  const float* hbar = arg<const float>(ops.p[0]);
  const float* AB = arg<const float>(ops.p[1]);
  const float* Wsum0 = arg<const float>(ops.p[2]);
  const int* kid_ptr = arg<const int>(ops.p[7]);
  const int* kid_idx = arg<const int>(ops.p[8]);
  float* P = arg<float>(ops.p[9]);
  float* Lu = arg<float>(ops.p[10]);
  float* K = arg<float>(ops.p[11]);
  float* Mxu = arg<float>(ops.p[12]);
  float* Wc = arg<float>(ops.p[14]);  // the run tops' W, read across blocks
  const int* ph_ptr = arg<const int>(ops.p[15]);
  const int* run_ptr = arg<const int>(ops.p[16]);
  const int* run_node = arg<const int>(ops.p[17]);
  const int nu = nz - nx;
  const int i = threadIdx.x % G, q = threadIdx.x / G;
  const unsigned mask = tq::group_mask<G>();
  const int g = q * team.blocks + team.rank, groups = team.blocks * (blockDim.x / G);
  const int stf = factor_stage_floats(nx, nz);
  float* ring = smem + (size_t)q * factor_group_floats(nx, nz);
  float* work = ring + kFactorStages * stf;

  Walk fw(ph_ptr, run_ptr, g, groups, 0, n_ph, 1);  // the nodes to fetch
  Walk cw = fw;                                     // the node to factor
  int tf = 0;
  const auto fetch = [&]() {
    if (!fw.done()) {
      const size_t n = run_node[fw.e];
      float* st = ring + (tf % kFactorStages) * stf;
      tq::copy_async(st, AB + n * nx * nz, nx * nz, i, G);
      tq::copy_async(st + nx * nz, hbar + n * nz, nz, i, G);
      tq::copy_async(st + nx * nz + nz, Wsum0 + n * nn, nn, i, G);
      fw.next();
    }
    ++tf;
    tq::cp_async_commit();
  };
  for (int t = 0; t < kFactorStages - 1; ++t) fetch();

  float w[NZ];  // row i of W of the run's node below
#pragma unroll
  for (int c = 0; c < NZ; ++c) w[c] = 0.f;
  const bool row = i < nz;
  int t = 0;
  for (int ph = 0; ph < n_ph; ++ph) {
    for (; !cw.done() && cw.ph == ph; cw.next(), ++t) {
      const size_t n = run_node[cw.e];
      fetch();
      tq::cp_async_wait<kFactorStages - 1>();
      __syncwarp(mask);
      const float* ABn = ring + (t % kFactorStages) * stf;
      const float* hb = ABn + nx * nz;
      const float* W0 = hb + nz;

      // M row i = Wsum_n row i + hbar_n on the diagonal
      float a[NZ];
#pragma unroll
      for (int c = 0; c < NZ; ++c) a[c] = 0.f;
      if (row) {
        if (cw.e == cw.first()) {
          const int k0 = kid_ptr[n], k1 = kid_ptr[n + 1];
          if (k1 > k0) {
            float s[NZ];
#pragma unroll
            for (int c = 0; c < NZ; ++c) s[c] = 0.f;
            for (int kq = k0; kq < k1; ++kq) {
              const float* Wk = Wc + (size_t)kid_idx[kq] * nn + i * nz;
#pragma unroll
              for (int c = 0; c < NZ; ++c)
                if (c < nz) s[c] = __fadd_rn(s[c], Wk[c]);
            }
#pragma unroll
            for (int c = 0; c < NZ; ++c)
              if (c < nz) a[c] = __fadd_rn(W0[i * nz + c], s[c]);
          } else {
#pragma unroll
            for (int c = 0; c < NZ; ++c)
              if (c < nz) a[c] = W0[i * nz + c];
          }
        } else {
#pragma unroll
          for (int c = 0; c < NZ; ++c)
            if (c < nz) a[c] = __fadd_rn(W0[i * nz + c], __fadd_rn(0.f, w[c]));
        }
#pragma unroll
        for (int c = 0; c < NZ; ++c)
          if (c == i) a[c] = __fadd_rn(a[c], hb[i]);
      }
      tq::ric_stage_factor_lanes<NZ, G>(a, ABn, nx, nz, i, reg, work, true, P + n * nx * nx,
                                        Lu + n * nu * nu, K + n * nu * nx, Mxu + n * nx * nu,
                                        w, mask);
      if (row && cw.e == cw.last()) {
#pragma unroll
        for (int c = 0; c < NZ; ++c)
          if (c < nz) Wc[n * nn + i * nz + c] = w[c];
      }
      __syncwarp(mask);  // the stage and the work areas are read: refill
    }
    if (ph + 1 < n_ph) team.sync();
  }
  tq::cp_async_wait<0>();
}

template <int NZ>
__device__ __forceinline__ void solve(const Team& team, const SolveOps& ops, int nx, int nz_,
                                      int n_ph) {
  constexpr int G = tq::ric_lanes(NZ);
  const int nz = tq::ric_nz<NZ>(nz_);
  extern __shared__ __align__(16) float smem[];
  const float* P = arg<const float>(ops.p[0]);
  const float* Lu = arg<const float>(ops.p[1]);
  const float* K = arg<const float>(ops.p[2]);
  const float* Mxu = arg<const float>(ops.p[3]);
  const float* AB = arg<const float>(ops.p[4]);
  const float* rg = arg<const float>(ops.p[5]);
  const float* rb = arg<const float>(ops.p[6]);
  const float* wsum0 = arg<const float>(ops.p[7]);
  const int* kid_ptr = arg<const int>(ops.p[12]);
  const int* kid_idx = arg<const int>(ops.p[13]);
  const int* par = arg<const int>(ops.p[14]);
  float* p = arg<float>(ops.p[15]);
  float* k = arg<float>(ops.p[16]);
  float* wv = arg<float>(ops.p[18]);  // the run tops' w, read across blocks
  float* dz = arg<float>(ops.p[19]);  // read across blocks at the run tops
  float* dl = arg<float>(ops.p[20]);
  const int* ph_ptr = arg<const int>(ops.p[21]);
  const int* run_ptr = arg<const int>(ops.p[22]);
  const int* run_node = arg<const int>(ops.p[23]);
  const int nu = nz - nx;
  const int i = threadIdx.x % G, q = threadIdx.x / G;
  const unsigned mask = tq::group_mask<G>();
  const int g = q * team.blocks + team.rank, groups = team.blocks * (blockDim.x / G);
  float* ring = smem + (size_t)q * solve_group_floats(nx, nz);

  // backward right-hand-side sweep, phases in order
  const BwdStage ob(nx, nz);
  Walk fw(ph_ptr, run_ptr, g, groups, 0, n_ph, 1), cw = fw;
  int tf = 0;
  const auto fetch_bwd = [&]() {
    if (!fw.done()) {
      const size_t n = run_node[fw.e];
      float* st = ring + (tf % kSolveStages) * ob.floats;
      tq::copy_async(st + ob.P, P + n * nx * nx, nx * nx, i, G);
      tq::copy_async(st + ob.Lu, Lu + n * nu * nu, nu * nu, i, G);
      tq::copy_async(st + ob.Mxu, Mxu + n * nx * nu, nx * nu, i, G);
      tq::copy_async(st + ob.AB, AB + n * nx * nz, nx * nz, i, G);
      tq::copy_async(st + ob.rg, rg + n * nz, nz, i, G);
      tq::copy_async(st + ob.rb, rb + n * nx, nx, i, G);
      tq::copy_async(st + ob.w0, wsum0 + n * nz, nz, i, G);
      fw.next();
    }
    ++tf;
    tq::cp_async_commit();
  };
  for (int t = 0; t < kSolveStages - 1; ++t) fetch_bwd();
  float w = 0.f;            // row i of w of the run's node below
  float pi = 0.f, ki = 0.f;  // lane i's p or k row of the last node
  int t = 0;
  for (int ph = 0; ph < n_ph; ++ph) {
    for (; !cw.done() && cw.ph == ph; cw.next(), ++t) {
      const size_t n = run_node[cw.e];
      fetch_bwd();
      tq::cp_async_wait<kSolveStages - 1>();
      __syncwarp(mask);
      const float* st = ring + (t % kSolveStages) * ob.floats;
      float m = 0.f;
      if (i < nz) {
        float ws;  // row i of wsum_n
        if (cw.e == cw.first()) {
          const int k0 = kid_ptr[n], k1 = kid_ptr[n + 1];
          ws = st[ob.w0 + i];
          if (k1 > k0) {
            float s = 0.f;
            for (int kq = k0; kq < k1; ++kq) s = __fadd_rn(s, wv[(size_t)kid_idx[kq] * nz + i]);
            ws = __fadd_rn(ws, s);
          }
        } else {
          ws = __fadd_rn(st[ob.w0 + i], __fadd_rn(0.f, w));
        }
        m = __fadd_rn(st[ob.rg + i], ws);
      }
      w = tq::ric_stage_bwd_lanes<NZ, G>(m, st + ob.P, st + ob.Lu, st + ob.Mxu, st + ob.AB,
                                         st + ob.rb, nx, nz, i, pi, ki, mask);
      if (i < nx) p[n * nx + i] = pi;
      else if (i < nz) k[n * nu + i - nx] = ki;
      if (i < nz && cw.e == cw.last()) wv[n * nz + i] = w;
      __syncwarp(mask);  // the stage is read: refill it
    }
    if (ph + 1 < n_ph) team.sync();
  }
  tq::cp_async_wait<0>();
  __syncwarp(mask);

  // the root: its run is the last phase's only one, group 0's, whose last
  // backward step left p_0 and k_0 in pi and ki; L goes through its ring
  if (g == 0) root_lanes<NZ, G>(P, K, pi, ki, nx, nz, i, mask, ring, dz, dl);
  __syncwarp(mask);

  // forward sweep, phases in reverse from the one below the root's; the
  // first stages of the ring fill while the team waits for the root
  const FwdStage of(nx, nz);
  Walk fv(ph_ptr, run_ptr, g, groups, n_ph - 2, -1, -1), cv = fv;
  tf = 0;
  const auto fetch_fwd = [&]() {
    if (!fv.done()) {
      const size_t n = run_node[fv.e];
      float* st = ring + (tf % kSolveStages) * of.floats;
      tq::copy_async(st + of.P, P + n * nx * nx, nx * nx, i, G);
      tq::copy_async(st + of.K, K + n * nu * nx, nu * nx, i, G);
      tq::copy_async(st + of.AB, AB + n * nx * nz, nx * nz, i, G);
      tq::copy_async(st + of.rb, rb + n * nx, nx, i, G);
      tq::copy_async(st + of.p, p + n * nx, nx, i, G);
      tq::copy_async(st + of.k, k + n * nu, nu, i, G);
      fv.next();
    }
    ++tf;
    tq::cp_async_commit();
  };
  team.arrive();
  for (int s = 0; s < kSolveStages - 1; ++s) fetch_fwd();
  team.wait();
  float z = 0.f;  // row i of dz of the run's node above
  t = 0;
  for (int ph = n_ph - 2; ph >= 0; --ph) {
    for (; !cv.done() && cv.ph == ph; cv.next(), ++t) {
      const size_t n = run_node[cv.e];
      fetch_fwd();
      tq::cp_async_wait<kSolveStages - 1>();
      __syncwarp(mask);
      const float* st = ring + (t % kSolveStages) * of.floats;
      if (cv.e == cv.first()) z = i < nz ? dz[(size_t)par[n] * nz + i] : 0.f;
      float dli;
      z = tq::ric_stage_fwd_lanes<NZ, G>(z, st + of.P, st + of.K, st + of.AB, st + of.rb,
                                         st + of.p, st + of.k, nx, nz, i, dli, mask);
      if (i < nz) dz[n * nz + i] = z;
      if (i < nx) dl[n * nx + i] = dli;
      __syncwarp(mask);  // the stage is read: refill it
    }
    if (ph > 0) team.sync();
  }
  tq::cp_async_wait<0>();
}

template <int NZ>
__global__ void __launch_bounds__(max_threads(NZ))
    crown_ric_factor_kernel(const FactorOps ops, int nx, int nz, int n_ph, float reg,
                            int blocks) {
  factor<NZ>(Team(blocks), ops, nx, nz, n_ph, reg);
}

template <int NZ>
__global__ void __launch_bounds__(max_threads(NZ))
    crown_ric_solve_kernel(const SolveOps ops, int nx, int nz, int n_ph, int blocks) {
  solve<NZ>(Team(blocks), ops, nx, nz, n_ph);
}

// Launch ``kernel`` (instantiated for NZ) on one cluster of ``blocks``
// blocks (one block: no cluster) of 32 warps threads with ``bytes`` of
// dynamic shared memory (tq::launch_team).
template <int NZ, typename... Args>
int launch(void (*kernel)(Args...), int n_ph, int blocks, int warps, size_t bytes,
           tq::TeamLimits& lim, cudaStream_t st, Args... args) {
  if (n_ph < 1 || warps < 1 || 32 * warps > max_threads(NZ)) return (int)cudaErrorInvalidValue;
  return tq::launch_team(kernel, blocks, 32 * warps, bytes, lim, st, args...);
}

template <int NZ>
int launch_factor(const FactorOps& ops, int nx, int nz, int n_ph, float reg, int blocks,
                  int warps, cudaStream_t st) {
  static tq::TeamLimits lim;
  const size_t bytes =
      (size_t)warps * (32 / tq::ric_lanes(NZ)) * factor_group_floats(nx, nz) * sizeof(float);
  return launch<NZ>(crown_ric_factor_kernel<NZ>, n_ph, blocks, warps, bytes, lim, st, ops, nx,
                    nz, n_ph, reg, blocks);
}

template <int NZ>
int launch_solve(const SolveOps& ops, int nx, int nz, int n_ph, int blocks, int warps,
                 cudaStream_t st) {
  static tq::TeamLimits lim;
  const size_t bytes =
      (size_t)warps * (32 / tq::ric_lanes(NZ)) * solve_group_floats(nx, nz) * sizeof(float);
  return launch<NZ>(crown_ric_solve_kernel<NZ>, n_ph, blocks, warps, bytes, lim, st, ops, nx,
                    nz, n_ph, blocks);
}

}  // namespace

// The entry points. crown_ric_wide.cu builds this file again with
// TQ_RIC_WIDE defined, for the 32-lane instantiation alone (the _wide
// functions, which the entry points call for 16 < nz <= 32 once they have
// checked the shape): a translation unit of its own, which nvcc compiles
// beside this one's 15 narrow instantiations.
#ifdef TQ_RIC_WIDE

extern "C" int tq_crown_ric_factor_wide(const void* const* p, int nx, int nz, int n_ph,
                                        float reg, int blocks, int warps, void* stream) {
  FactorOps ops;
  for (int i = 0; i < 18; ++i) ops.p[i] = p[i];
  return launch_factor<tq::kRicWide>(ops, nx, nz, n_ph, reg, blocks, warps,
                                     (cudaStream_t)stream);
}

extern "C" int tq_crown_ric_solve_wide(const void* const* p, int nx, int nz, int n_ph,
                                       int blocks, int warps, void* stream) {
  SolveOps ops;
  for (int i = 0; i < 24; ++i) ops.p[i] = p[i];
  return launch_solve<tq::kRicWide>(ops, nx, nz, n_ph, blocks, warps, (cudaStream_t)stream);
}

#else

extern "C" int tq_crown_ric_factor_wide(const void* const*, int, int, int, float, int, int,
                                        void*);
extern "C" int tq_crown_ric_solve_wide(const void* const*, int, int, int, int, int, void*);

// pointers (FactorOps), Nc, nx, nz, n_ph (phases of runs), reg, blocks
// (one cluster of 2 .. 16 blocks, or one block), warps a block, stream
extern "C" int tq_crown_ric_factor(const void* const* p, int Nc, int nx, int nz, int n_ph,
                                   float reg, int blocks, int warps, void* stream) {
  FactorOps ops;
  for (int i = 0; i < 18; ++i) ops.p[i] = p[i];
  const cudaStream_t st = (cudaStream_t)stream;
  if (Nc < 1) return (int)cudaErrorInvalidValue;
#define TQ_RIC(NZ_) \
  case NZ_:         \
    return launch_factor<NZ_>(ops, nx, nz, n_ph, reg, blocks, warps, st);
  TQ_RIC_SWITCH(nx, nz, TQ_RIC,
                tq_crown_ric_factor_wide(p, nx, nz, n_ph, reg, blocks, warps, stream))
#undef TQ_RIC
}

// pointers (SolveOps), Nc, nx, nz, n_ph, blocks, warps, stream
extern "C" int tq_crown_ric_solve(const void* const* p, int Nc, int nx, int nz, int n_ph,
                                  int blocks, int warps, void* stream) {
  SolveOps ops;
  for (int i = 0; i < 24; ++i) ops.p[i] = p[i];
  const cudaStream_t st = (cudaStream_t)stream;
  if (Nc < 1) return (int)cudaErrorInvalidValue;
#define TQ_RIC(NZ_) \
  case NZ_:         \
    return launch_solve<NZ_>(ops, nx, nz, n_ph, blocks, warps, st);
  TQ_RIC_SWITCH(nx, nz, TQ_RIC, tq_crown_ric_solve_wide(p, nx, nz, n_ph, blocks, warps, stream))
#undef TQ_RIC
}

#endif  // TQ_RIC_WIDE

// One stage of the IPM's Riccati recursion on a group of G = ric_lanes(NZ)
// lanes, lane i owning row i of the stage's blocks: the factorization
// (ric_stage_factor_lanes), the backward right-hand side
// (ric_stage_bwd_lanes) and the forward step (ric_stage_fwd_lanes). The
// chain kernels (ric_chain.cu) run them along a chain, a group a chain; the
// crown kernels (crown_ric.cu) along the single-kid runs of a tree, a group
// a run.
//
// Widths: a kernel is instantiated once per NZ = 2 .. 16 (nz = NZ, a group
// of 8 or 16 lanes), and once for NZ = kRicWide = 32, which serves every
// 16 < nz <= 32 with nz passed at run time (ric_nz) on a group of a whole
// warp: the stage's register arrays hold NZ entries, its unrolled loops run
// to NZ and skip the trips at and past nz, so each sum meets the same terms
// in the same order as at an instantiation of its own.
//
// Blocks are row-major. A stage has nx states and nu = nz - nx controls;
// M is its [nz, nz] Hessian with the successors' terms added, AB [nx, nz]
// the edge into it. Every sum is accumulated term by term in the order of
// the Pallas kernels of treeqp_tpu/ops/riccati_kernels.py and of the plain
// twins (ops/riccati_kernels.stage_*), each product folded in by one FMA
// and every other add, scaling and division rounded on its own: the bits
// of the per-thread stage the one-thread-a-node kernels ran (as nvcc
// contracted it: each sum's first product an FFMA onto the 0 it starts
// from), whatever the compiler contracts here. ``mask`` names the group's
// lanes in the warp (all 32 where every group of the warp runs in step).
#pragma once

#include "tq_dense.cuh"
#include "tq_lanes.cuh"

namespace tq {

constexpr int kRicNarrow = 16;  // the widest nz with an instantiation of its own
constexpr int kRicWide = 32;    // the one instantiation of 16 < nz <= 32

// Lanes a group: 8 for nz <= 8, 16 for nz <= 16, a warp beyond.
__host__ __device__ constexpr int ric_lanes(int NZ) { return NZ <= kRicNarrow ? lanes(NZ) : 32; }

// The nz an instantiation runs: NZ itself up to 16 (a constant the
// compiler folds), the run-time nz at kRicWide.
template <int NZ>
__device__ __forceinline__ int ric_nz(int nz) {
  return NZ <= kRicNarrow ? NZ : nz;
}

// A kernel's dispatch: CALL(NZ) for nz = NZ up to 16; the expression WIDE
// for 16 < nz <= 32, the 32-lane instantiation, which a translation unit of
// its own builds (ric_chain_wide.cu, crown_ric_wide.cu: nvcc then compiles
// it beside the 15 narrow ones rather than after them); nz outside 2 .. 32
// or nx outside 1 .. nz - 1 is refused before any launch.
#define TQ_RIC_SWITCH(nx, nz, CALL, WIDE)                                        \
  if ((nx) < 1 || (nx) >= (nz) || (nz) > tq::kRicWide)                           \
    return (int)cudaErrorInvalidValue;                                           \
  switch (nz) {                                                                  \
    CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) CALL(9) CALL(10)     \
    CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)                        \
  }                                                                              \
  return (WIDE);

// The lanes of the group of G lanes that owns this thread, as a warp mask.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return G == 32 ? kFull : ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
}

// The factorization. Lane i holds row i of M in ``a`` (0 on the lanes past
// nz - 1 and in the entries past nz - 1); ABj [nx, nz] is in shared memory;
// ``work`` is five nz x nz shared-memory areas (M, Lu, K, T = Mxx + Mxu K,
// P AB). Writes, where ``live``, lane nx + r row r of Lu = chol(Muu + reg
// I) (pivot floor 1e-8, clamped diagonal), lane c < nx column c of K =
// -Muu^-1 Mux and row c of Mxu and of P = sym(Mxx + Mxu K); returns in
// ``w`` lane i's row of the parent's term W = AB' (P AB) (0 past its entry
// nz - 1; lanes past nz - 1 keep theirs).
// - Lu right-looking: lane nx + k's pivot broadcast by __shfl_sync, lanes
//   r >= c folding a_rc -= L_rk L_ck by one FMA, so each element meets its
//   products in ascending k, the order of the left-looking per-thread
//   Cholesky; M goes through shared memory so that the nu rows start at
//   their own column 0.
// - K: lane c < nx solves column c through Lu in shared memory (true
//   divisions). T and P = (T + T') / 2 row by lane, the transpose through
//   shared memory; P AB row x by lane x and W row i by lane i, from shared
//   memory: ~150 dependent FMAs a lane at NZ = 9.
template <int NZ, int G>
__device__ __forceinline__ void ric_stage_factor_lanes(const float (&a)[NZ], const float* ABj,
                                                       int nx, int nz, int i, float reg,
                                                       float* work, bool live, float* P,
                                                       float* Lu, float* K, float* Mxu,
                                                       float (&w)[NZ],
                                                       unsigned mask = kFull) {
  const int nu = nz - nx, nn = nz * nz;
  float* sM = work;       // [nz, nz]: M
  float* sLu = sM + nn;   // [nu, nu]
  float* sK = sLu + nn;   // [nu, nx]
  float* sT = sK + nn;    // [nx, nx]: Mxx + Mxu K
  float* sPA = sT + nn;   // [nx, nz]: P AB
  const bool row = i < nz;
  const int r = i - nx;  // row of Muu and Lu (0 .. nu-1 on lanes nx .. nz-1)
  const bool urow = row && r >= 0;
  if (row) {
#pragma unroll
    for (int c = 0; c < NZ; ++c)
      if (c < nz) sM[i * nz + c] = a[c];
  }
  __syncwarp(mask);

  // Lu = chol(Muu + reg I), right-looking: lane nx + r holds row r of Muu
  float u[NZ];
#pragma unroll
  for (int c = 0; c < NZ; ++c) {
    u[c] = urow && c < nu ? sM[i * nz + nx + c] : 0.f;
    if (c == r) u[c] = __fadd_rn(u[c], reg);
  }
#pragma unroll
  for (int k = 0; k < NZ; ++k) {
    if (k < nu) {
      const float akk = __shfl_sync(mask, u[k], nx + k, G);
      const float d = fmaxf(akk, kPivotFloor);
      const float dinv = rsqrtf(d);
      const float lrk = r == k ? __fmul_rn(d, dinv) : __fmul_rn(u[k], dinv);
      if (r >= k) u[k] = lrk;
#pragma unroll
      for (int c = k + 1; c < NZ; ++c) {
        if (c < nu) {
          const float lck = __shfl_sync(mask, lrk, nx + c, G);
          if (r >= c) u[c] = __fmaf_rn(-lrk, lck, u[c]);
        }
      }
    }
  }
  if (urow) {
#pragma unroll
    for (int c = 0; c < NZ; ++c) {
      if (c < nu) {
        const float v = c > r ? 0.f : u[c];
        sLu[r * nu + c] = v;
        if (live) Lu[r * nu + c] = v;
      }
    }
  }
  __syncwarp(mask);

  // K = -Muu^-1 Mux: lane i < nx solves column i through Lu; Mxu row i
  if (i < nx) {
    float y[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) y[k] = k < nu ? sM[(nx + k) * nz + i] : 0.f;
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      if (k < nu) {
        float acc = y[k];
#pragma unroll
        for (int m = 0; m < k; ++m) acc = __fmaf_rn(-sLu[k * nu + m], y[m], acc);
        y[k] = __fdiv_rn(acc, sLu[k * nu + k]);
      }
    }
#pragma unroll
    for (int k = NZ - 1; k >= 0; --k) {
      if (k < nu) {
        float acc = y[k];
#pragma unroll
        for (int m = k + 1; m < NZ; ++m)
          if (m < nu) acc = __fmaf_rn(-sLu[m * nu + k], y[m], acc);
        y[k] = __fdiv_rn(acc, sLu[k * nu + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      if (k < nu) {
        sK[k * nx + i] = -y[k];
        if (live) {
          K[k * nx + i] = -y[k];
          Mxu[i * nu + k] = sM[i * nz + nx + k];
        }
      }
    }
  }
  __syncwarp(mask);

  // T = Mxx + Mxu K, row i
  if (i < nx) {
#pragma unroll
    for (int jj = 0; jj < NZ; ++jj) {
      if (jj < nx) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NZ; ++k)
          if (k < nu) acc = __fmaf_rn(sM[i * nz + nx + k], sK[k * nx + jj], acc);
        sT[i * nx + jj] = __fadd_rn(a[jj], acc);
      }
    }
  }
  __syncwarp(mask);

  // P = (T + T') / 2 and P AB, row i
  if (i < nx) {
    float p[NZ];
#pragma unroll
    for (int jj = 0; jj < NZ; ++jj) {
      p[jj] = jj < nx ? __fmul_rn(0.5f, __fadd_rn(sT[i * nx + jj], sT[jj * nx + i])) : 0.f;
      if (jj < nx && live) P[i * nx + jj] = p[jj];
    }
#pragma unroll
    for (int jj = 0; jj < NZ; ++jj) {
      if (jj < nz) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NZ; ++k)
          if (k < nx) acc = __fmaf_rn(p[k], ABj[k * nz + jj], acc);
        sPA[i * nz + jj] = acc;
      }
    }
  }
  __syncwarp(mask);

  // W = AB' (P AB), row i
  if (row) {
#pragma unroll
    for (int jj = 0; jj < NZ; ++jj) {
      float acc = 0.f;
      if (jj < nz) {
#pragma unroll
        for (int x = 0; x < NZ; ++x)
          if (x < nx) acc = __fmaf_rn(ABj[x * nz + i], sPA[x * nz + jj], acc);
      }
      w[jj] = acc;
    }
  }
}

// The backward right-hand side on the group, lane i owning row i of m [nz]
// (``m``; lanes past nz - 1 hold 0): k = -Muu^-1 m_u, p = m_x + Mxu k and
// the parent's term w = AB' (P rb + p). The stage's blocks are read from
// shared memory: P [nx, nx], Lu [nu, nu], Mxu [nx, nu], AB [nx, nz], rb
// [nx]. Returns lane i's row of w; lane x < nx gets p_x in ``p``, lane
// nx + c gets k_c in ``k``.
// - P rb, row x by lane x, does not depend on m: it is summed first, off
//   the dependent chain.
// - Lu y = m_u: for c = 0 .. nu-1 lane nx + c divides by its diagonal and
//   __shfl_sync broadcasts y_c, lanes nx + r > c fold -Lu_rc y_c in, so
//   each row meets its terms in ascending c (ltrsv_inplace's order).
// - Lu' z = y: every lane holds the z_c solved so far; for c = nu-1 .. 0
//   lane nx + c folds -Lu_mc z_m in over m = c+1 .. nu-1 ascending
//   (uttrsv_inplace's order), divides and broadcasts z_c; k = -z.
// - p_x = m_x + sum_c Mxu_xc k_c and v_x = (P rb)_x + p_x by lane x; v is
//   broadcast by nx shuffles and lane i sums w_i = sum_x AB_xi v_x.
// Every sum starts from 0 and runs in the per-thread stage's loop order
// (Lu y = m_u, Lu' z = y, k = -z; p_x = m_x + sum_c Mxu_xc k_c; v_x = sum_c
// P_xc rb_c + p_x; w_i = sum_x AB_xi v_x), each product folded in by one FMA
// (__fmaf_rn), the adds that stand alone rounded on their own (__fadd_rn)
// and the divisions true divisions (quotient).
template <int NZ, int G>
__device__ __forceinline__ float ric_stage_bwd_lanes(float m, const float* P, const float* Lu,
                                                     const float* Mxu, const float* AB,
                                                     const float* rb, int nx, int nz, int i,
                                                     float& p, float& k, unsigned mask = kFull) {
  const int nu = nz - nx;
  const int r = i - nx;  // row of Lu on lanes nx .. nz-1
  const bool urow = r >= 0 && r < nu;
  const bool xrow = i < nx;
  float Lrow[NZ], Lcol[NZ], ABcol[NZ];
  float diag = 1.f;
#pragma unroll
  for (int c = 0; c < NZ; ++c) {
    Lrow[c] = urow && c < r ? Lu[r * nu + c] : 0.f;
    Lcol[c] = urow && c > r && c < nu ? Lu[c * nu + r] : 0.f;
    ABcol[c] = c < nx && i < nz ? AB[c * nz + i] : 0.f;
  }
  if (urow) diag = Lu[r * nu + r];
  float prb = 0.f;  // (P rb)_x
  if (xrow) {
#pragma unroll
    for (int c = 0; c < NZ; ++c)
      if (c < nx) prb = __fmaf_rn(P[i * nx + c], rb[c], prb);
  }

  float acc = m, y = 0.f;
#pragma unroll
  for (int c = 0; c < NZ; ++c) {
    if (c < nu) {
      const float yc = __shfl_sync(mask, quotient(acc, diag, r == c), nx + c, G);
      if (r > c) acc = __fmaf_rn(-Lrow[c], yc, acc);
      if (r == c) y = yc;
    }
  }
  float z[NZ];
#pragma unroll
  for (int c = NZ - 1; c >= 0; --c) {
    z[c] = 0.f;
    if (c < nu) {
      float a = y;
#pragma unroll
      for (int mm = c + 1; mm < NZ; ++mm)
        if (mm < nu) a = __fmaf_rn(-Lcol[mm], z[mm], a);
      z[c] = __shfl_sync(mask, quotient(a, diag, r == c), nx + c, G);
      if (r == c) k = -z[c];
    }
  }

  float v = 0.f;
  if (xrow) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NZ; ++c)
      if (c < nu) s = __fmaf_rn(Mxu[i * nu + c], -z[c], s);
    p = __fadd_rn(m, s);
    v = __fadd_rn(prb, p);
  }
  float w = 0.f;
#pragma unroll
  for (int x = 0; x < NZ; ++x) {
    if (x < nx) w = __fmaf_rn(ABcol[x], __shfl_sync(mask, v, x, G), w);
  }
  return i < nz ? w : 0.f;
}

// The forward step on the group, lane i holding row i of the parent's step
// zp [nz] (``zp``; lanes past nz - 1 hold 0): dx = AB zp + rb, du = K dx +
// k, dlam = P dx + p. The stage's blocks are read from shared memory: P
// [nx, nx], K [nu, nx], AB [nx, nz], rb [nx], p [nx], k [nu]. Returns
// lane i's row of dz = [dx; du] (0 past nz - 1); lane x < nx gets dlam_x
// in ``dl``.
// - zp is broadcast by nz __shfl_sync that do not depend on each other;
//   lane x sums dx_x = sum_c AB_xc zp_c + rb_x.
// - dx is broadcast by nx shuffles, and one fold over them gives lane
//   nx + u du_u = sum_x K_ux dx_x + k_u and lane x dlam_x = sum_c P_xc dx_c
//   + p_x (each lane its own row of K or P).
// Every sum starts from 0 and runs in the per-thread stage's loop order
// (dx_x = sum_c AB_xc zp_c + rb_x; du_u = sum_x K_ux dx_x + k_u; dlam_x =
// sum_c P_xc dx_c + p_x), each product folded in by one FMA (__fmaf_rn) and
// the three adds rounded on their own (__fadd_rn).
template <int NZ, int G>
__device__ __forceinline__ float ric_stage_fwd_lanes(float zp, const float* P, const float* K,
                                                     const float* AB, const float* rb,
                                                     const float* p, const float* k, int nx,
                                                     int nz, int i, float& dl,
                                                     unsigned mask = kFull) {
  const int nu = nz - nx;
  const int u = i - nx;  // row of K on lanes nx .. nz-1
  const bool xrow = i < nx;
  const bool urow = u >= 0 && u < nu;
  // the operands, off the dependent chain: lane x's row of AB and of P,
  // lane nx + u's row of K, and what each adds
  float ABrow[NZ], row[NZ];
#pragma unroll
  for (int c = 0; c < NZ; ++c) {
    ABrow[c] = xrow && c < nz ? AB[i * nz + c] : 0.f;
    row[c] = c >= nx ? 0.f : xrow ? P[i * nx + c] : urow ? K[u * nx + c] : 0.f;
  }
  const float add0 = xrow ? rb[i] : 0.f;
  const float add1 = xrow ? p[i] : urow ? k[u] : 0.f;

  float z[NZ];
#pragma unroll
  for (int c = 0; c < NZ; ++c) z[c] = __shfl_sync(mask, zp, c, G);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NZ; ++c)
    if (c < nz) s = __fmaf_rn(ABrow[c], z[c], s);
  const float dx = xrow ? __fadd_rn(s, add0) : 0.f;

  float d[NZ];
#pragma unroll
  for (int x = 0; x < NZ; ++x) d[x] = x < nx ? __shfl_sync(mask, dx, x, G) : 0.f;
  s = 0.f;
#pragma unroll
  for (int x = 0; x < NZ; ++x)
    if (x < nx) s = __fmaf_rn(row[x], d[x], s);
  const float out = __fadd_rn(s, add1);
  dl = out;
  return xrow ? dx : urow ? out : 0.f;
}

}  // namespace tq

// One stage of the IPM's Riccati recursion, for one thread: shared by the
// chain kernels (ric_chain.cu, a chain's stages in sequence) and the crown
// kernels (crown_ric.cu, a tree level's nodes in parallel); and the
// backward right-hand-side and forward stages on a group of lanes
// (ric_stage_bwd_lanes, ric_stage_fwd_lanes: ric_chain.cu's ric_chain_bwd
// and ric_chain_fwd).
//
// Blocks are row-major. A stage has nx states and nu = nz - nx controls;
// M is its [nz, nz] Hessian with the successors' terms added, AB [nx, nz]
// the edge into it. Every sum is accumulated term by term in the order of
// the Pallas kernels of treeqp_tpu/ops/riccati_kernels.py and of the plain
// twins (ops/riccati_kernels.stage_*), so kernel and twin differ only by
// rounding and FMA contraction.
#pragma once

#include "tq_dense.cuh"
#include "tq_lanes.cuh"

namespace tq {

// Factor: Lu = chol(Muu + reg I) (pivot floor 1e-8, clamped diagonal),
// K = -Muu^-1 Mux (column by column), Mxu, P = sym(Mxx + Mxu K), written to
// P [nx, nx], Lu [nu, nu], K [nu, nx], Mxu [nx, nu]; then the parent's
// term W = AB' (P AB) into W [nz, nz], which may alias M (local).
__device__ inline void ric_stage_factor(const float* M, const float* __restrict__ AB,
                                        int nx, int nz, float reg, float* P, float* Lu,
                                        float* K, float* Mxu, float* W) {
  const int nu = nz - nx;
  for (int i = 0; i < nu; ++i)
    for (int j = 0; j < nu; ++j) Lu[i * nu + j] = M[(nx + i) * nz + nx + j];
  chol_inplace<true>(Lu, nu, reg);
  float y[kMaxN];
  for (int c = 0; c < nx; ++c) {
    for (int i = 0; i < nu; ++i) y[i] = M[(nx + i) * nz + c];
    ltrsv_inplace(Lu, y, nu);
    uttrsv_inplace(Lu, y, nu);
    for (int i = 0; i < nu; ++i) K[i * nx + c] = -y[i];
  }
  for (int i = 0; i < nx; ++i)
    for (int k = 0; k < nu; ++k) Mxu[i * nu + k] = M[i * nz + nx + k];
  float T[kMaxN * kMaxN];
  for (int i = 0; i < nx; ++i)
    for (int j = 0; j < nx; ++j) {
      float s = 0.f;
      for (int k = 0; k < nu; ++k) s += Mxu[i * nu + k] * K[k * nx + j];
      T[i * nx + j] = M[i * nz + j] + s;
    }
  for (int i = 0; i < nx; ++i)
    for (int j = 0; j < nx; ++j) P[i * nx + j] = 0.5f * (T[i * nx + j] + T[j * nx + i]);
  // T = P AB [nx, nz], then W = AB' T
  for (int x = 0; x < nx; ++x)
    for (int j = 0; j < nz; ++j) {
      float s = 0.f;
      for (int k = 0; k < nx; ++k) s += P[x * nx + k] * AB[k * nz + j];
      T[x * nz + j] = s;
    }
  for (int i = 0; i < nz; ++i)
    for (int j = 0; j < nz; ++j) {
      float s = 0.f;
      for (int x = 0; x < nx; ++x) s += AB[x * nz + i] * T[x * nz + j];
      W[i * nz + j] = s;
    }
}

// Backward right-hand side: from m [nz] (local), k = -Muu^-1 m_u,
// p = m_x + Mxu k (written to p [nx], k [nu]) and the parent's term
// w = AB' (P rb + p) into w [nz], which may alias m.
__device__ inline void ric_stage_bwd(const float* m, const float* __restrict__ P,
                                     const float* __restrict__ Lu,
                                     const float* __restrict__ Mxu,
                                     const float* __restrict__ AB,
                                     const float* __restrict__ rb, int nx, int nz,
                                     float* p, float* k, float* w) {
  const int nu = nz - nx;
  float y[kMaxN], v[kMaxN];
  for (int i = 0; i < nu; ++i) y[i] = m[nx + i];
  ltrsv_inplace(Lu, y, nu);
  uttrsv_inplace(Lu, y, nu);
  for (int i = 0; i < nu; ++i) {
    y[i] = -y[i];
    k[i] = y[i];
  }
  for (int i = 0; i < nx; ++i) {
    float s = 0.f;
    for (int c = 0; c < nu; ++c) s += Mxu[i * nu + c] * y[c];
    v[i] = m[i] + s;
    p[i] = v[i];
  }
  for (int i = 0; i < nx; ++i) {
    float s = 0.f;
    for (int c = 0; c < nx; ++c) s += P[i * nx + c] * rb[c];
    v[i] = s + v[i];
  }
  for (int i = 0; i < nz; ++i) {
    float s = 0.f;
    for (int x = 0; x < nx; ++x) s += AB[x * nz + i] * v[x];
    w[i] = s;
  }
}

// ric_stage_bwd on a group of G lanes (G = lanes(NZ)), lane i owning row i
// of m [NZ] (``m``; lanes past NZ - 1 hold 0). The stage's blocks are read
// from shared memory: P [nx, nx], Lu [nu, nu], Mxu [nx, nu], AB [nx, NZ],
// rb [nx]. Returns lane i's row of w = AB' (P rb + p); lane x < nx gets
// p_x in ``p``, lane nx + c gets k_c in ``k``.
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
// Every sum starts from 0 and runs in ric_stage_bwd's loop order, each
// product folded in by one FMA (__fmaf_rn, as nvcc contracts the
// per-thread body), the adds that stand alone rounded on their own
// (__fadd_rn) and the divisions true divisions (quotient): bit for bit
// ric_stage_bwd.
template <int NZ, int G>
__device__ __forceinline__ float ric_stage_bwd_lanes(float m, const float* P, const float* Lu,
                                                     const float* Mxu, const float* AB,
                                                     const float* rb, int nx, int i, float& p,
                                                     float& k) {
  const int nu = NZ - nx;
  const int r = i - nx;  // row of Lu on lanes nx .. NZ-1
  const bool urow = r >= 0 && r < nu;
  const bool xrow = i < nx;
  float Lrow[NZ], Lcol[NZ], ABcol[NZ];
  float diag = 1.f;
#pragma unroll
  for (int c = 0; c < NZ; ++c) {
    Lrow[c] = urow && c < r ? Lu[r * nu + c] : 0.f;
    Lcol[c] = urow && c > r && c < nu ? Lu[c * nu + r] : 0.f;
    ABcol[c] = c < nx && i < NZ ? AB[c * NZ + i] : 0.f;
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
      const float yc = __shfl_sync(kFull, quotient(acc, diag, r == c), nx + c, G);
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
      z[c] = __shfl_sync(kFull, quotient(a, diag, r == c), nx + c, G);
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
    if (x < nx) w = __fmaf_rn(ABcol[x], __shfl_sync(kFull, v, x, G), w);
  }
  return i < NZ ? w : 0.f;
}

// Forward: from the parent's step zp [nz], dx = AB zp + rb, du = K dx + k,
// dlam = P dx + p; writes dz = [dx; du] [nz] and dl [nx] (not aliasing zp).
__device__ inline void ric_stage_fwd(const float* zp, const float* __restrict__ P,
                                     const float* __restrict__ K,
                                     const float* __restrict__ AB,
                                     const float* __restrict__ rb,
                                     const float* __restrict__ p,
                                     const float* __restrict__ k, int nx, int nz,
                                     float* dz, float* dl) {
  const int nu = nz - nx;
  float dx[kMaxN];
  for (int x = 0; x < nx; ++x) {
    float s = 0.f;
    for (int c = 0; c < nz; ++c) s += AB[x * nz + c] * zp[c];
    dx[x] = s + rb[x];
  }
  for (int u = 0; u < nu; ++u) {
    float s = 0.f;
    for (int x = 0; x < nx; ++x) s += K[u * nx + x] * dx[x];
    dz[nx + u] = s + k[u];
  }
  for (int x = 0; x < nx; ++x) {
    float s = 0.f;
    for (int c = 0; c < nx; ++c) s += P[x * nx + c] * dx[c];
    dl[x] = s + p[x];
    dz[x] = dx[x];
  }
}


// ric_stage_fwd on a group of G lanes (G = lanes(NZ)), lane i holding row i
// of the parent's step zp [NZ] (``zp``; lanes past NZ - 1 hold 0). The
// stage's blocks are read from shared memory: P [nx, nx], K [nu, nx], AB
// [nx, NZ], rb [nx], p [nx], k [nu]. Returns lane i's row of dz = [dx; du]
// (0 past NZ - 1); lane x < nx gets dlam_x in ``dl``.
// - zp is broadcast by NZ __shfl_sync that do not depend on each other;
//   lane x sums dx_x = sum_c AB_xc zp_c + rb_x.
// - dx is broadcast by nx shuffles, and one fold over them gives lane
//   nx + u du_u = sum_x K_ux dx_x + k_u and lane x dlam_x = sum_c P_xc dx_c
//   + p_x (each lane its own row of K or P).
// Every sum starts from 0 and runs in ric_stage_fwd's loop order, each
// product folded in by one FMA (__fmaf_rn: nvcc contracts the per-thread
// body's products, the first onto the 0 it starts from) and the three
// adds rounded on their own (__fadd_rn): bit for bit ric_stage_fwd.
template <int NZ, int G>
__device__ __forceinline__ float ric_stage_fwd_lanes(float zp, const float* P, const float* K,
                                                     const float* AB, const float* rb,
                                                     const float* p, const float* k, int nx,
                                                     int i, float& dl) {
  const int nu = NZ - nx;
  const int u = i - nx;  // row of K on lanes nx .. NZ-1
  const bool xrow = i < nx;
  const bool urow = u >= 0 && u < nu;
  // the operands, off the dependent chain: lane x's row of AB and of P,
  // lane nx + u's row of K, and what each adds
  float ABrow[NZ], row[NZ];
#pragma unroll
  for (int c = 0; c < NZ; ++c) {
    ABrow[c] = xrow ? AB[i * NZ + c] : 0.f;
    row[c] = c >= nx ? 0.f : xrow ? P[i * nx + c] : urow ? K[u * nx + c] : 0.f;
  }
  const float add0 = xrow ? rb[i] : 0.f;
  const float add1 = xrow ? p[i] : urow ? k[u] : 0.f;

  float z[NZ];
#pragma unroll
  for (int c = 0; c < NZ; ++c) z[c] = __shfl_sync(kFull, zp, c, G);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NZ; ++c) s = __fmaf_rn(ABrow[c], z[c], s);
  const float dx = xrow ? __fadd_rn(s, add0) : 0.f;

  float d[NZ];
#pragma unroll
  for (int x = 0; x < NZ; ++x) d[x] = x < nx ? __shfl_sync(kFull, dx, x, G) : 0.f;
  s = 0.f;
#pragma unroll
  for (int x = 0; x < NZ; ++x)
    if (x < nx) s = __fmaf_rn(row[x], d[x], s);
  const float out = __fadd_rn(s, add1);
  dl = out;
  return xrow ? dx : urow ? out : 0.f;
}

}  // namespace tq

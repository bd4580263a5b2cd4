// One stage of the IPM's Riccati recursion, for one thread: shared by the
// chain kernels (ric_chain.cu, a chain's stages in sequence) and the crown
// kernels (crown_ric.cu, a tree level's nodes in parallel).
//
// Blocks are row-major. A stage has nx states and nu = nz - nx controls;
// M is its [nz, nz] Hessian with the successors' terms added, AB [nx, nz]
// the edge into it. Every sum is accumulated term by term in the order of
// the Pallas kernels of treeqp_tpu/ops/riccati_kernels.py and of the plain
// twins (ops/riccati_kernels.stage_*), so kernel and twin differ only by
// rounding and FMA contraction.
#pragma once

#include "tq_dense.cuh"

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

}  // namespace tq

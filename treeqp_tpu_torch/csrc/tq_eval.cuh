// Bodies of the f32 stage evaluations (clipping stage solves, active-set
// masked inverses, dual residuals, dual-value partials) for the chains and
// the crown: shared by chain_eval.cu, crown_eval.cu and newton_iter.cu.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn: no FMA contraction) and every sum runs in the index order of
// the Pallas kernels and of the plain PyTorch twins, so that the kernel
// reproduces its twin bit for bit: the active sets qt/rt (Qinv or 0) then
// agree exactly, and the reuse of a factorization on an unchanged active
// set takes the same decisions on the card as on the CPU.
//
// Operands arrive as one host array of device pointers, in the order of the
// ``*_KEYS`` tuples of ``treeqp_tpu_torch/ops/``; PtrCursor reads them off.
#pragma once

#include <cuda_runtime.h>

namespace tq {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// sum_r M[r * ld + c] v[r] over r = 0 .. rows-1, in order.
__device__ inline float col_dot(const float* M, const float* v, int c, int rows, int ld) {
  float acc = 0.f;
  for (int r = 0; r < rows; ++r) acc = add(acc, mul(M[r * ld + c], v[r]));
  return acc;
}

// sum_c M[i * ld + c] v[c] over c = 0 .. cols-1, in order.
__device__ inline float row_dot(const float* M, const float* v, int i, int cols, int ld) {
  float acc = 0.f;
  for (int c = 0; c < cols; ++c) acc = add(acc, mul(M[i * ld + c], v[c]));
  return acc;
}

struct PtrCursor {
  const void* const* p;
  int k = 0;
  __host__ const float* in() { return static_cast<const float*>(p[k++]); }
  __host__ float* out() { return const_cast<float*>(static_cast<const float*>(p[k++])); }
  __host__ const int* idx() { return static_cast<const int*>(p[k++]); }
};

// ---------------------------------------------------------------------------
// chains: [S, L, ...] f32 data (chain_kernels.CHAIN_DATA_KEYS)

struct ChainData {
  const float *AB, *q, *r, *Qd, *Rd, *Qi, *Ri, *xlo, *xhi, *ulo, *uhi, *b;
  int S, L, nx, nu;
};

inline ChainData chain_data(PtrCursor& c, int S, int L, int nx, int nu) {
  ChainData d;
  d.AB = c.in(); d.q = c.in(); d.r = c.in(); d.Qd = c.in(); d.Rd = c.in();
  d.Qi = c.in(); d.Ri = c.in(); d.xlo = c.in(); d.xhi = c.in();
  d.ulo = c.in(); d.uhi = c.in(); d.b = c.in();
  d.S = S; d.L = L; d.nx = nx; d.nu = nu;
  return d;
}

// Outputs of one evaluation; xU, uU and err may be null (not written).
struct EvalOut {
  float *x, *u, *qt, *rt, *xU, *uU, *res, *f, *err;
};

inline EvalOut eval_out(PtrCursor& c) {
  EvalOut o;
  o.x = c.out(); o.u = c.out(); o.qt = c.out(); o.rt = c.out();
  o.xU = c.out(); o.uU = c.out(); o.res = c.out(); o.f = c.out();
  o.err = c.out();
  return o;
}

// Chain s at the dual point lam [S, L, nx]:
//   qmod_j = -q_j + lam_j - A_{j+1}' lam_{j+1},  rmod_j = -r_j - B_{j+1}' lam_{j+1}
//   (no kid term at j = L-1); x = clip(Qinv qmod), u = clip(Rinv rmod);
//   qt/rt = Qinv/Rinv, or 0 where the bound clips;
//   res_j = b_j - x_j + A_j x_{j-1} + B_j u_{j-1} for j >= 1, and b_0 - x_0
//   at j = 0 (the caller adds A_0 z_crown);
//   f[s] = sum_j sum_i x (qmod - Qd x / 2) - b lam + sum_i u (rmod - Rd u / 2);
//   err[s] = max |res_j| over j >= 1;  cqr = [A_0 B_0]' lam_0 (nz values).
__device__ inline void chain_eval_one(const ChainData& d, const float* __restrict__ lam,
                                      const EvalOut& o, float* cqr, int s) {
  const int L = d.L, nx = d.nx, nu = d.nu, nz = nx + nu;
  float facc = 0.f, err = 0.f;
  for (int j = 0; j < L; ++j) {
    const size_t sj = (size_t)s * L + j;
    const float* lj = lam + sj * nx;
    const bool kid = j < L - 1;
    const float* ABn = d.AB + (sj + 1) * nx * nz;
    const float* ln = lam + (sj + 1) * nx;
    float sx = 0.f, su = 0.f;
    for (int i = 0; i < nx; ++i) {
      const size_t e = sj * nx + i;
      float qm = add(-d.q[e], lj[i]);
      if (kid) qm = sub(qm, col_dot(ABn, ln, i, nx, nz));
      const float xu = mul(d.Qi[e], qm);
      const float xv = fminf(fmaxf(xu, d.xlo[e]), d.xhi[e]);
      o.x[e] = xv;
      o.qt[e] = (xu > d.xhi[e] || xu < d.xlo[e]) ? 0.f : d.Qi[e];
      if (o.xU) o.xU[e] = xu;
      sx = add(sx, sub(mul(xv, sub(qm, mul(mul(0.5f, d.Qd[e]), xv))), mul(d.b[e], lj[i])));
    }
    for (int i = 0; i < nu; ++i) {
      const size_t e = sj * nu + i;
      float rm = -d.r[e];
      if (kid) rm = sub(rm, col_dot(ABn, ln, nx + i, nx, nz));
      const float uu = mul(d.Ri[e], rm);
      const float uv = fminf(fmaxf(uu, d.ulo[e]), d.uhi[e]);
      o.u[e] = uv;
      o.rt[e] = (uu > d.uhi[e] || uu < d.ulo[e]) ? 0.f : d.Ri[e];
      if (o.uU) o.uU[e] = uu;
      su = add(su, mul(uv, sub(rm, mul(mul(0.5f, d.Rd[e]), uv))));
    }
    facc = add(add(facc, sx), su);
    const float* AB = d.AB + sj * nx * nz;
    for (int i = 0; i < nx; ++i) {
      const size_t e = sj * nx + i;
      float rr = sub(d.b[e], o.x[e]);
      if (j > 0) {
        const float* xp = o.x + (sj - 1) * nx;
        const float* up = o.u + (sj - 1) * nu;
        rr = add(add(rr, row_dot(AB, xp, i, nx, nz)), row_dot(AB + nx, up, i, nu, nz));
        err = fmaxf(err, fabsf(rr));
      }
      o.res[e] = rr;
    }
  }
  const float* AB0 = d.AB + (size_t)s * L * nx * nz;
  const float* l0 = lam + (size_t)s * L * nx;
  for (int c = 0; c < nz; ++c) cqr[c] = col_dot(AB0, l0, c, nx, nz);
  o.f[s] = facc;
  if (o.err) o.err[s] = err;
}

// ---------------------------------------------------------------------------
// crown: [Nn, ...] f32 node data (crown_kernels.CROWN_DATA_KEYS) and the
// tree as par [Nn] (par[0] = 0) and the kids of each node in slot order
// (kid_idx[kid_ptr[n] .. kid_ptr[n+1]])

struct CrownData {
  const float *AB, *q, *r, *b, *Qd, *Rd, *Qi, *Ri, *xlo, *xhi, *ulo, *uhi,
      *xm, *um, *nr;
  const int *par, *kid_ptr, *kid_idx;
  int Nn, nx, nu;
};

inline CrownData crown_data(PtrCursor& c, int Nn, int nx, int nu) {
  CrownData d;
  d.AB = c.in(); d.q = c.in(); d.r = c.in(); d.b = c.in(); d.Qd = c.in();
  d.Rd = c.in(); d.Qi = c.in(); d.Ri = c.in(); d.xlo = c.in();
  d.xhi = c.in(); d.ulo = c.in(); d.uhi = c.in(); d.xm = c.in();
  d.um = c.in(); d.nr = c.in();
  d.par = c.idx(); d.kid_ptr = c.idx(); d.kid_idx = c.idx();
  d.Nn = Nn; d.nx = nx; d.nu = nu;
  return d;
}

// Phase A, node n: atb[n] = [A_n B_n]' lam_n  (nz values).
__device__ inline void crown_atb(const CrownData& d, const float* __restrict__ lam,
                                 float* __restrict__ atb, int n) {
  const int nx = d.nx, nz = nx + d.nu;
  const float* AB = d.AB + (size_t)n * nx * nz;
  for (int c = 0; c < nz; ++c) atb[(size_t)n * nz + c] = col_dot(AB, lam + (size_t)n * nx, c, nx, nz);
}

// Phase B, node n (after phase A of every node): the kid sum of atb plus
// the chain contributions extra [Nn, nz], the clipping solve, the masked
// inverses and the dual-value partial f[n].
__device__ inline void crown_clip(const CrownData& d, const float* __restrict__ lam,
                                  const float* __restrict__ atb,
                                  const float* __restrict__ extra, const EvalOut& o, int n) {
  const int nx = d.nx, nu = d.nu, nz = nx + nu;
  const int k0 = d.kid_ptr[n], k1 = d.kid_ptr[n + 1];
  float sx = 0.f, su = 0.f;
  for (int i = 0; i < nx; ++i) {
    const size_t e = (size_t)n * nx + i;
    float ks = 0.f;
    for (int k = k0; k < k1; ++k) ks = add(ks, atb[(size_t)d.kid_idx[k] * nz + i]);
    const float sA = add(ks, extra[(size_t)n * nz + i]);
    const float qm = mul(sub(add(-d.q[e], lam[e]), sA), d.xm[e]);
    const float xu = mul(d.Qi[e], qm);
    const float xv = mul(fminf(fmaxf(xu, d.xlo[e]), d.xhi[e]), d.xm[e]);
    o.x[e] = xv;
    o.qt[e] = (xu > d.xhi[e] || xu < d.xlo[e]) ? 0.f : d.Qi[e];
    if (o.xU) o.xU[e] = xu;
    sx = add(sx, sub(mul(xv, sub(qm, mul(mul(0.5f, d.Qd[e]), xv))),
                     mul(mul(d.b[e], lam[e]), d.nr[e])));
  }
  for (int i = 0; i < nu; ++i) {
    const size_t e = (size_t)n * nu + i;
    float ks = 0.f;
    for (int k = k0; k < k1; ++k) ks = add(ks, atb[(size_t)d.kid_idx[k] * nz + nx + i]);
    const float sB = add(ks, extra[(size_t)n * nz + nx + i]);
    const float rm = mul(sub(-d.r[e], sB), d.um[e]);
    const float uu = mul(d.Ri[e], rm);
    const float uv = mul(fminf(fmaxf(uu, d.ulo[e]), d.uhi[e]), d.um[e]);
    o.u[e] = uv;
    o.rt[e] = (uu > d.uhi[e] || uu < d.ulo[e]) ? 0.f : d.Ri[e];
    if (o.uU) o.uU[e] = uu;
    su = add(su, mul(uv, sub(rm, mul(mul(0.5f, d.Rd[e]), uv))));
  }
  o.f[n] = add(sx, su);
}

// Phase C, node n (after phase B of every node): the dual residual
// res_n = ([A_n B_n] z_par(n) + b_n - x_n) * nonroot, and err[n] = max |res_n|.
__device__ inline void crown_res(const CrownData& d, const EvalOut& o, int n) {
  const int nx = d.nx, nu = d.nu, nz = nx + nu;
  const int p = d.par[n];
  const float* AB = d.AB + (size_t)n * nx * nz;
  const float* xp = o.x + (size_t)p * nx;
  const float* up = o.u + (size_t)p * nu;
  float err = 0.f;
  for (int i = 0; i < nx; ++i) {
    const size_t e = (size_t)n * nx + i;
    float acc = 0.f;
    for (int c = 0; c < nx; ++c) acc = add(acc, mul(AB[i * nz + c], xp[c]));
    for (int c = 0; c < nu; ++c) acc = add(acc, mul(AB[i * nz + nx + c], up[c]));
    const float rr = mul(sub(add(acc, d.b[e]), o.x[e]), d.nr[e]);
    o.res[e] = rr;
    err = fmaxf(err, fabsf(rr));
  }
  if (o.err) o.err[n] = err;
}

}  // namespace tq

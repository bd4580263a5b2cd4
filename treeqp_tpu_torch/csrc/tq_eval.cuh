// Bodies of the stage evaluations (clipping stage solves, active-set masked
// inverses, dual residuals, dual-value partials) for the chains and the
// crown, templated on the scalar type: float for the coarse phase
// (chain_eval.cu, crown_eval.cu, newton_iter.cu), double for the
// high-precision phase (chain_eval_df.cu, crown_eval_df.cu).
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, __dmul_rn / __dadd_rn / __dsub_rn: no FMA contraction) and
// every sum runs in the index order of the plain PyTorch twins, so that the
// kernel reproduces its twin bit for bit: the active sets qt/rt (Qinv or 0)
// then agree exactly, and the reuse of a factorization on an unchanged
// active set takes the same decisions on the card as on the CPU.
//
// Operands arrive as one host array of device pointers, in the order of the
// ``*_KEYS`` tuples of ``treeqp_tpu_torch/ops/``; PtrCursor reads them off.
#pragma once

#include <cuda_runtime.h>

namespace tq {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float clip(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }
__device__ __forceinline__ double clip(double v, double lo, double hi) { return fmin(fmax(v, lo), hi); }
__device__ __forceinline__ float absmax(float m, float v) { return fmaxf(m, fabsf(v)); }
__device__ __forceinline__ double absmax(double m, double v) { return fmax(m, fabs(v)); }
__device__ __forceinline__ float maxof(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double maxof(double a, double b) { return fmax(a, b); }

// sum_r M[r * ld + c] v[r] over r = 0 .. rows-1, in order (v widened to T).
template <typename T, typename V>
__device__ inline T col_dot(const T* M, const V* v, int c, int rows, int ld) {
  T acc = T(0);
  for (int r = 0; r < rows; ++r) acc = add(acc, mul(M[r * ld + c], T(v[r])));
  return acc;
}

// sum_c M[i * ld + c] v[c] over c = 0 .. cols-1, in order.
template <typename T>
__device__ inline T row_dot(const T* M, const T* v, int i, int cols, int ld) {
  T acc = T(0);
  for (int c = 0; c < cols; ++c) acc = add(acc, mul(M[i * ld + c], v[c]));
  return acc;
}

// acc[c] = sum_r M[r * ld + c0 + c] v[r] over r = 0 .. rows-1, for the
// kCols columns c0 + c < cols at once (each column in col_dot's order;
// their loads and sums overlap).
constexpr int kCols = 16;

template <typename T, typename V>
__device__ __forceinline__ void col_dots(const T* M, const V* v, int c0, int cols, int rows,
                                         int ld, T (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = T(0);
  for (int r = 0; r < rows; ++r) {
    const T vr = T(v[r]);
    const T* Mr = M + (size_t)r * ld + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c0 + c < cols) acc[c] = add(acc[c], mul(Mr[c], vr));
  }
}

// The rows i < nx <= kRows of [A B] [x; u] (A the first nx columns of M, B
// the next nu, row stride ld): acc[i] = sum_c M[i ld + c] x[c] over c < nx,
// then + sum_c M[i ld + nx + c] u[c] over c < nu, in that order as one sum
// (split = false) or as two (split = true: the u part in accu).
constexpr int kRows = 16;

template <typename T, bool kSplit>
__device__ __forceinline__ void row_dots(const T* M, const T* x, const T* u, int nx, int nu,
                                         int ld, T (&acc)[kRows], T (&accu)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = accu[i] = T(0);
  for (int c = 0; c < nx; ++c) {
    const T xc = x[c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < nx) acc[i] = add(acc[i], mul(M[(size_t)i * ld + c], xc));
  }
  for (int c = 0; c < nu; ++c) {
    const T uc = u[c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < nx) {
        if (kSplit)
          accu[i] = add(accu[i], mul(M[(size_t)i * ld + nx + c], uc));
        else
          acc[i] = add(acc[i], mul(M[(size_t)i * ld + nx + c], uc));
      }
    }
  }
}

struct PtrCursor {
  const void* const* p;
  int k = 0;
  template <typename T = float>
  __host__ const T* in() { return static_cast<const T*>(p[k++]); }
  template <typename T = float>
  __host__ T* out() { return const_cast<T*>(static_cast<const T*>(p[k++])); }
  __host__ const int* idx() { return static_cast<const int*>(p[k++]); }
};

// ---------------------------------------------------------------------------
// chains: [S, L, ...] data (chain_kernels.CHAIN_DATA_KEYS)

template <typename T>
struct ChainData {
  const T *AB, *q, *r, *Qd, *Rd, *Qi, *Ri, *xlo, *xhi, *ulo, *uhi, *b;
  int S, L, nx, nu;
};

template <typename T>
inline ChainData<T> chain_data(PtrCursor& c, int S, int L, int nx, int nu) {
  ChainData<T> d;
  d.AB = c.in<T>(); d.q = c.in<T>(); d.r = c.in<T>(); d.Qd = c.in<T>();
  d.Rd = c.in<T>(); d.Qi = c.in<T>(); d.Ri = c.in<T>(); d.xlo = c.in<T>();
  d.xhi = c.in<T>(); d.ulo = c.in<T>(); d.uhi = c.in<T>(); d.b = c.in<T>();
  d.S = S; d.L = L; d.nx = nx; d.nu = nu;
  return d;
}

// Outputs of one evaluation; xU, uU and err may be null (not written).
template <typename T>
struct EvalOut {
  T *x, *u, *qt, *rt, *xU, *uU, *res, *f, *err;
};

template <typename T>
inline EvalOut<T> eval_out(PtrCursor& c) {
  EvalOut<T> o;
  o.x = c.out<T>(); o.u = c.out<T>(); o.qt = c.out<T>(); o.rt = c.out<T>();
  o.xU = c.out<T>(); o.uU = c.out<T>(); o.res = c.out<T>(); o.f = c.out<T>();
  o.err = c.out<T>();
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
// chain_eval_one runs the chain node by node in one thread; newton_iter.cu
// and chain_eval_df.cu run chain_clip_node (chain_clip_at) for every node
// at once, then chain_res_node (chain_res_at), then the per-chain sums in j
// order: the same operations on every element.

// Node sj = s L + j: the clipping solve, the masked inverses, and the
// node's dual-value partials sx (the x rows) and su (the u rows), with its
// dual row lj, and (kid = j < L-1) the kid's block ABn and dual row ln read
// from wherever the caller keeps them (global memory, or a block's tile in
// shared memory: chain_eval_df.cu).
template <typename T>
__device__ inline void chain_clip_at(const ChainData<T>& d, const T* __restrict__ lj,
                                     const T* ABn, const T* __restrict__ ln,
                                     const EvalOut<T>& o, size_t sj, bool kid, T& sx, T& su) {
  const int nx = d.nx, nu = d.nu, nz = nx + nu;
  const T half = T(0.5);
  sx = T(0);
  su = T(0);
  // the columns of [x; u] a chunk at a time: the kid terms col_dot(ABn, ln,
  // c) of the chunk's columns, then their rows, x rows first, i ascending
  for (int c0 = 0; c0 < nz; c0 += kCols) {
    T kt[kCols];
    if (kid) {
      col_dots(ABn, ln, c0, nz, nx, nz, kt);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) kt[c] = T(0);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + c;
      if (col < nx) {
        const int i = col;
        const size_t e = sj * nx + i;
        T qm = add(-d.q[e], lj[i]);
        if (kid) qm = sub(qm, kt[c]);
        const T xu = mul(d.Qi[e], qm);
        const T xv = clip(xu, d.xlo[e], d.xhi[e]);
        o.x[e] = xv;
        o.qt[e] = (xu > d.xhi[e] || xu < d.xlo[e]) ? T(0) : d.Qi[e];
        if (o.xU) o.xU[e] = xu;
        sx = add(sx, sub(mul(xv, sub(qm, mul(mul(half, d.Qd[e]), xv))), mul(d.b[e], lj[i])));
      } else if (col < nz) {
        const size_t e = sj * nu + (col - nx);
        T rm = -d.r[e];
        if (kid) rm = sub(rm, kt[c]);
        const T uu = mul(d.Ri[e], rm);
        const T uv = clip(uu, d.ulo[e], d.uhi[e]);
        o.u[e] = uv;
        o.rt[e] = (uu > d.uhi[e] || uu < d.ulo[e]) ? T(0) : d.Ri[e];
        if (o.uU) o.uU[e] = uu;
        su = add(su, mul(uv, sub(rm, mul(mul(half, d.Rd[e]), uv))));
      }
    }
  }
}

// Node j of chain s (sj = s L + j), after the clip of nodes j-1 and j:
// the residual row res_j, and max |res_j| (0 at j = 0, whose row the
// caller completes); the node's block ABj read from wherever the caller
// keeps it.
template <typename T>
__device__ inline T chain_res_at(const ChainData<T>& d, const T* ABj, const EvalOut<T>& o,
                                 size_t sj, int j) {
  const int nx = d.nx, nu = d.nu, nz = nx + nu;
  T err = T(0);
  if (j == 0) {
    for (int i = 0; i < nx; ++i) o.res[sj * nx + i] = sub(d.b[sj * nx + i], o.x[sj * nx + i]);
    return err;
  }
  // row_dot(AB, x_{j-1}, i) and row_dot(AB + nx, u_{j-1}, i) of every row
  T ax[kRows], au[kRows];
  row_dots<T, true>(ABj, o.x + (sj - 1) * nx, o.u + (sj - 1) * nu, nx, nu, nz, ax, au);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < nx) {
      const size_t e = sj * nx + i;
      const T rr = add(add(sub(d.b[e], o.x[e]), ax[i]), au[i]);
      err = absmax(err, rr);
      o.res[e] = rr;
    }
  }
  return err;
}

// Node j of chain s, after the clip of nodes j-1 and j (chain_res_at with
// the block in global memory).
template <typename T>
__device__ inline T chain_res_node(const ChainData<T>& d, const EvalOut<T>& o, int s, int j) {
  const size_t sj = (size_t)s * d.L + j;
  return chain_res_at(d, d.AB + sj * d.nx * (d.nx + d.nu), o, sj, j);
}

// Node j of chain s (chain_clip_at with its operands in global memory).
template <typename T>
__device__ inline void chain_clip_node(const ChainData<T>& d, const T* __restrict__ lam,
                                       const EvalOut<T>& o, int s, int j, T& sx, T& su) {
  const int nx = d.nx, nz = nx + d.nu;
  const size_t sj = (size_t)s * d.L + j;
  chain_clip_at(d, lam + sj * nx, d.AB + (sj + 1) * nx * nz, lam + (sj + 1) * nx, o, sj,
                j < d.L - 1, sx, su);
}

// cqr = [A_0 B_0]' v_0 (nz values) of a chain's root block AB0 and row v0
// (v widened to T).
template <typename T, typename V>
__device__ inline void chain_root_cqr_at(const T* AB0, const V* v0, int nx, int nz, T* cqr) {
  for (int c0 = 0; c0 < nz; c0 += kCols) {
    T acc[kCols];
    col_dots(AB0, v0, c0, nz, nx, nz, acc);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c0 + c < nz) cqr[c0 + c] = acc[c];
  }
}

// cqr = [A_0 B_0]' lam_0 of chain s (nz values).
template <typename T>
__device__ inline void chain_root_cqr(const ChainData<T>& d, const T* __restrict__ lam, T* cqr,
                                      int s) {
  const int nx = d.nx, nz = nx + d.nu;
  chain_root_cqr_at(d.AB + (size_t)s * d.L * nx * nz, lam + (size_t)s * d.L * nx, nx, nz, cqr);
}

template <typename T>
__device__ inline void chain_eval_one(const ChainData<T>& d, const T* __restrict__ lam,
                                      const EvalOut<T>& o, T* cqr, int s) {
  T facc = T(0), err = T(0);
  for (int j = 0; j < d.L; ++j) {
    T sx, su;
    chain_clip_node(d, lam, o, s, j, sx, su);
    facc = add(add(facc, sx), su);
    err = maxof(err, chain_res_node(d, o, s, j));
  }
  chain_root_cqr(d, lam, cqr, s);
  o.f[s] = facc;
  if (o.err) o.err[s] = err;
}

// ---------------------------------------------------------------------------
// crown: [Nn, ...] node data (crown_kernels.CROWN_DATA_KEYS) and the tree as
// par [Nn] (par[0] = 0) and the kids of each node in slot order
// (kid_idx[kid_ptr[n] .. kid_ptr[n+1]])

template <typename T>
struct CrownData {
  const T *AB, *q, *r, *b, *Qd, *Rd, *Qi, *Ri, *xlo, *xhi, *ulo, *uhi, *xm, *um, *nr;
  const int *par, *kid_ptr, *kid_idx;
  int Nn, nx, nu;
};

template <typename T>
inline CrownData<T> crown_data(PtrCursor& c, int Nn, int nx, int nu) {
  CrownData<T> d;
  d.AB = c.in<T>(); d.q = c.in<T>(); d.r = c.in<T>(); d.b = c.in<T>();
  d.Qd = c.in<T>(); d.Rd = c.in<T>(); d.Qi = c.in<T>(); d.Ri = c.in<T>();
  d.xlo = c.in<T>(); d.xhi = c.in<T>(); d.ulo = c.in<T>(); d.uhi = c.in<T>();
  d.xm = c.in<T>(); d.um = c.in<T>(); d.nr = c.in<T>();
  d.par = c.idx(); d.kid_ptr = c.idx(); d.kid_idx = c.idx();
  d.Nn = Nn; d.nx = nx; d.nu = nu;
  return d;
}

// Phase A, node n: atb[n] = [A_n B_n]' v_n  (nz values; v widened to T).
template <typename T, typename V>
__device__ inline void crown_atb(const CrownData<T>& d, const V* __restrict__ v,
                                 T* __restrict__ atb, int n) {
  const int nx = d.nx, nz = nx + d.nu;
  const T* AB = d.AB + (size_t)n * nx * nz;
  for (int c0 = 0; c0 < nz; c0 += kCols) {
    T acc[kCols];
    col_dots(AB, v + (size_t)n * nx, c0, nz, nx, nz, acc);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c0 + c < nz) atb[(size_t)n * nz + c0 + c] = acc[c];
  }
}

// The kid sum of atb column c at node n, in slot order, plus extra[n, c].
template <typename T>
__device__ inline T crown_kid_sum(const CrownData<T>& d, const T* __restrict__ atb,
                                  const T* __restrict__ extra, int n, int c) {
  const int nz = d.nx + d.nu;
  T ks = T(0);
  for (int k = d.kid_ptr[n]; k < d.kid_ptr[n + 1]; ++k) ks = add(ks, atb[(size_t)d.kid_idx[k] * nz + c]);
  return add(ks, extra[(size_t)n * nz + c]);
}

// ks[c] = crown_kid_sum of column c0 + c, for the kCols columns at once.
template <typename T>
__device__ __forceinline__ void crown_kid_sums(const CrownData<T>& d, const T* __restrict__ atb,
                                               const T* __restrict__ extra, int n, int c0,
                                               T (&ks)[kCols]) {
  const int nz = d.nx + d.nu;
#pragma unroll
  for (int c = 0; c < kCols; ++c) ks[c] = T(0);
  for (int k = d.kid_ptr[n]; k < d.kid_ptr[n + 1]; ++k) {
    const T* row = atb + (size_t)d.kid_idx[k] * nz + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c0 + c < nz) ks[c] = add(ks[c], row[c]);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c0 + c < nz) ks[c] = add(ks[c], extra[(size_t)n * nz + c0 + c]);
}

// Phase B, node n (after phase A of every node): the kid sum of atb plus
// the chain contributions extra [Nn, nz], the clipping solve, the masked
// inverses and the dual-value partial f[n]; the columns of [x; u] a chunk
// at a time, x rows first, i ascending.
template <typename T>
__device__ inline void crown_clip(const CrownData<T>& d, const T* __restrict__ lam,
                                  const T* __restrict__ atb, const T* __restrict__ extra,
                                  const EvalOut<T>& o, int n) {
  const int nx = d.nx, nu = d.nu, nz = nx + nu;
  const T half = T(0.5);
  T sx = T(0), su = T(0);
  for (int c0 = 0; c0 < nz; c0 += kCols) {
    T ks[kCols];
    crown_kid_sums(d, atb, extra, n, c0, ks);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + c;
      if (col < nx) {
        const size_t e = (size_t)n * nx + col;
        const T qm = mul(sub(add(-d.q[e], lam[e]), ks[c]), d.xm[e]);
        const T xu = mul(d.Qi[e], qm);
        const T xv = mul(clip(xu, d.xlo[e], d.xhi[e]), d.xm[e]);
        o.x[e] = xv;
        o.qt[e] = (xu > d.xhi[e] || xu < d.xlo[e]) ? T(0) : d.Qi[e];
        if (o.xU) o.xU[e] = xu;
        sx = add(sx, sub(mul(xv, sub(qm, mul(mul(half, d.Qd[e]), xv))),
                         mul(mul(d.b[e], lam[e]), d.nr[e])));
      } else if (col < nz) {
        const size_t e = (size_t)n * nu + (col - nx);
        const T rm = mul(sub(-d.r[e], ks[c]), d.um[e]);
        const T uu = mul(d.Ri[e], rm);
        const T uv = mul(clip(uu, d.ulo[e], d.uhi[e]), d.um[e]);
        o.u[e] = uv;
        o.rt[e] = (uu > d.uhi[e] || uu < d.ulo[e]) ? T(0) : d.Ri[e];
        if (o.uU) o.uU[e] = uu;
        su = add(su, mul(uv, sub(rm, mul(mul(half, d.Rd[e]), uv))));
      }
    }
  }
  o.f[n] = add(sx, su);
}

// Phase C, node n (after phase B of every node): the dual residual
// res_n = ([A_n B_n] [x; u]_par(n) + b_n - x_n) * nonroot, and
// err[n] = max |res_n|; with b = null the linearized residual
// ([A_n B_n] [x; u]_par(n) - x_n) * nonroot (the Hessian action).
template <typename T>
__device__ inline void crown_res(const CrownData<T>& d, const T* __restrict__ x,
                                 const T* __restrict__ u, const T* b, T* __restrict__ res,
                                 T* err, int n) {
  const int nx = d.nx, nu = d.nu, nz = nx + nu;
  const int p = d.par[n];
  const T* AB = d.AB + (size_t)n * nx * nz;
  const T* xp = x + (size_t)p * nx;
  const T* up = u + (size_t)p * nu;
  T emax = T(0);
  T acc[kRows], unused[kRows];
  row_dots<T, false>(AB, xp, up, nx, nu, nz, acc, unused);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < nx) {
      const size_t e = (size_t)n * nx + i;
      const T a = b ? add(acc[i], b[e]) : acc[i];
      const T rr = mul(sub(a, x[e]), d.nr[e]);
      res[e] = rr;
      emax = absmax(emax, rr);
    }
  }
  if (err) err[n] = emax;
}

template <typename T>
__device__ inline void crown_res(const CrownData<T>& d, const EvalOut<T>& o, int n) {
  crown_res(d, o.x, o.u, d.b, o.res, o.err, n);
}

// ---------------------------------------------------------------------------
// the two evaluation kernels and their launchers, for either scalar type

// One thread per chain (chain_eval.cu).
template <typename T>
__global__ void chain_eval_kernel(ChainData<T> d, const T* __restrict__ lam, EvalOut<T> o,
                                  T* __restrict__ cqr) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= d.S) return;
  const int nz = d.nx + d.nu;
  chain_eval_one(d, lam, o, cqr + (size_t)s * nz, s);
}

// p: CHAIN_DATA_KEYS (12), lam, then x, u, qt, rt, xU, uU, res, f, err, cqr.
template <typename T>
inline int launch_chain_eval(const void* const* p, int S, int L, int nx, int nu, void* stream) {
  constexpr int kThreads = 128;
  PtrCursor c{p};
  const ChainData<T> d = chain_data<T>(c, S, L, nx, nu);
  const T* lam = c.in<T>();
  const EvalOut<T> o = eval_out<T>(c);
  T* cqr = c.out<T>();
  chain_eval_kernel<T><<<(S + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      d, lam, o, cqr);
  return (int)cudaGetLastError();
}

// The high-precision phase's chain kernels (chain_eval_df.cu,
// chain_apply_df.cu) run a thread a chain node, ``chains`` whole chains a
// block of at most kNodeThreads threads (a longer chain's block strides
// over its nodes). tile_bytes: the shared memory of a tile of count
// elements of elem bytes that stage_async fills (tq_lanes.cuh).
constexpr int kNodeThreads = 128;

__host__ __device__ inline size_t tile_bytes(size_t count, size_t elem) {
  return (count * elem + 15) / 16 * 16 + 16;
}

// Opt the kernel in to ``bytes`` of dynamic shared memory, once for each
// new high-water mark (``opted``, the kernel's own).
template <typename K>
inline cudaError_t opt_in_smem(K kernel, size_t bytes, size_t& opted) {
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) opted = bytes;
  return e;
}

// One block; threads stride over the nodes with a barrier between the
// phases A, B, C (crown_eval.cu, crown_eval_df.cu).
template <typename T>
__global__ void __launch_bounds__(1024) crown_eval_kernel(
    CrownData<T> d, const T* __restrict__ lam, const T* __restrict__ extra,
    T* __restrict__ atb, EvalOut<T> o) {
  for (int n = threadIdx.x; n < d.Nn; n += blockDim.x) crown_atb(d, lam, atb, n);
  __syncthreads();
  for (int n = threadIdx.x; n < d.Nn; n += blockDim.x) crown_clip(d, lam, atb, extra, o, n);
  __syncthreads();
  for (int n = threadIdx.x; n < d.Nn; n += blockDim.x) crown_res(d, o, n);
}

// p: CROWN_DATA_KEYS (15), par, kid_ptr, kid_idx, lam, extra, atb (scratch),
// then x, u, qt, rt, xU, uU, res, f, err.
template <typename T>
inline int launch_crown_eval(const void* const* p, int Nn, int nx, int nu, int threads,
                             void* stream) {
  PtrCursor c{p};
  const CrownData<T> d = crown_data<T>(c, Nn, nx, nu);
  const T* lam = c.in<T>();
  const T* extra = c.in<T>();
  T* atb = c.out<T>();
  const EvalOut<T> o = eval_out<T>(c);
  crown_eval_kernel<T><<<1, threads, 0, (cudaStream_t)stream>>>(d, lam, extra, atb, o);
  return (int)cudaGetLastError();
}

}  // namespace tq

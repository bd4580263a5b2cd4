// Bodies of the stage evaluations (clipping stage solves, active-set masked
// inverses, dual residuals, dual-value partials) for the chains and the
// crown, templated on the scalar type: float for the coarse phase
// (chain_eval.cu, crown_eval.cu, newton_iter.cu), double for the
// high-precision phase (chain_eval_df.cu, crown_eval_df.cu); and the two
// layouts of the evaluation kernels: the chains a thread a node
// (chain_eval_nodes: chain_eval.cu, chain_eval_df.cu) and the crown a lane
// group a node (crown_eval_lanes: crown_eval.cu, crown_eval_df.cu; and
// crown_apply_lanes, the Hessian action's: crown_apply_df.cu).
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

#include "tq_crown.cuh"
#include "tq_lanes.cuh"

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
// newton_iter.cu and chain_eval_nodes run chain_clip_node (chain_clip_at)
// for every node at once, then chain_res_node (chain_res_at), then the
// per-chain sums in j order, facc = (facc + sx_j) + su_j from 0: the same
// operations on every element as a walk of the chain node by node.

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

// ks[c] = the kid sum of atb column c0 + c at node n, in slot order, plus
// extra[n, c0 + c], for the kCols columns at once.
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
// the evaluation kernels and their launchers, for either scalar type

// The chain evaluation kernels (chain_eval.cu, chain_eval_df.cu) and
// chain_apply_df.cu run a thread a chain node, ``chains`` whole chains a
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

// The chain evaluation a thread a node (chain_eval.cu in float,
// chain_eval_df.cu in double): ``chains`` whole chains a block; with
// kStaged the block's [A B] blocks and lam rows are first copied to shared
// memory (one contiguous tile each, stage_async), where each node's block
// is read by its own thread (the residual row) and its parent's (the kid
// term). 1. every node's clip (chain_clip_at), its dual-value partials
// parked in shared memory, and each chain's cqr by its node j = 0; 2. after
// the barrier, every node's residual row, which needs x_{j-1}, u_{j-1}
// (chain_res_at); 3. each chain's partials summed in j order by one
// thread. err is not written.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kNodeThreads) chain_eval_nodes(
    const ChainData<T> d, const T* __restrict__ lam, const EvalOut<T> o, T* __restrict__ cqr,
    int chains) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = d.L, nx = d.nx, nz = nx + d.nu;
  const int s0 = blockIdx.x * chains;
  const int nn = min(chains, d.S - s0) * L;  // this block's nodes
  const size_t e0 = (size_t)s0 * L;
  T* sx = reinterpret_cast<T*>(smem);  // [chains L] each
  T* su = sx + (size_t)chains * L;
  const T* AB = d.AB + e0 * nx * nz;
  const T* lm = lam + e0 * nx;
  if (kStaged) {
    unsigned char* buf = smem + tile_bytes(2 * (size_t)chains * L, sizeof(T)) - 16;
    AB = stage_async(buf, AB, (size_t)nn * nx * nz);
    buf += tile_bytes((size_t)chains * L * nx * nz, sizeof(T));
    lm = stage_async(buf, lm, (size_t)nn * nx);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // 1. the clips, the partials, the roots' cqr
  for (int k = threadIdx.x; k < nn; k += blockDim.x) {
    const int j = k % L;
    T a, b;
    chain_clip_at(d, lm + (size_t)k * nx, AB + (size_t)(k + 1) * nx * nz,
                  lm + (size_t)(k + 1) * nx, o, e0 + k, j < L - 1, a, b);
    sx[k] = a;
    su[k] = b;
    if (j == 0)
      chain_root_cqr_at(AB + (size_t)k * nx * nz, lm + (size_t)k * nx, nx, nz,
                        cqr + (size_t)(s0 + k / L) * nz);
  }
  __syncthreads();
  // 2. the residual rows
  for (int k = threadIdx.x; k < nn; k += blockDim.x)
    chain_res_at(d, AB + (size_t)k * nx * nz, o, e0 + k, k % L);
  // 3. each chain's dual-value partial (sx, su complete since the barrier)
  for (int c = threadIdx.x; c * L < nn; c += blockDim.x) {
    T facc = T(0);
    for (int j = 0; j < L; ++j) facc = add(add(facc, sx[c * L + j]), su[c * L + j]);
    o.f[s0 + c] = facc;
  }
}

// The dynamic shared memory of chain_eval_nodes' block: the partials (two
// T a node), then, staged, the [A B] and lam tiles.
template <typename T>
__host__ inline size_t chain_eval_smem(int chains, int L, int nx, int nu, bool staged) {
  const size_t nodes = (size_t)chains * L;
  size_t bytes = tile_bytes(2 * nodes, sizeof(T)) - 16;
  if (staged)
    bytes += tile_bytes(nodes * nx * (nx + nu), sizeof(T)) + tile_bytes(nodes * nx, sizeof(T));
  return bytes;
}

// The launchers keep their kernel's limits (opt-in shared memory, cluster
// size) in function-local statics. They are static (internal linkage): as
// inline templates with external linkage those statics would be one
// process-wide (GNU unique) symbol, shared by two builds of these kernels
// loaded into one process (a parent comparison), and the second build's
// kernel would launch without its own opt-in.
template <typename T, bool kStaged>
static inline int chain_eval_nodes_launch(const ChainData<T>& d, const T* lam,
                                          const EvalOut<T>& o, T* cqr, int chains,
                                          cudaStream_t st) {
  const size_t nodes = (size_t)chains * d.L;
  const size_t bytes = chain_eval_smem<T>(chains, d.L, d.nx, d.nu, kStaged);
  static size_t opted = 48 * 1024;
  const cudaError_t e = opt_in_smem(chain_eval_nodes<T, kStaged>, bytes, opted);
  if (e != cudaSuccess) return (int)e;
  const int threads = (int)(nodes < kNodeThreads ? nodes : kNodeThreads);
  chain_eval_nodes<T, kStaged><<<(d.S + chains - 1) / chains, threads, bytes, st>>>(
      d, lam, o, cqr, chains);
  return (int)cudaGetLastError();
}

// p: CHAIN_DATA_KEYS (12), lam, then x, u, qt, rt, xU, uU, res, f, err
// (null: not written), cqr; all T. chains: whole chains a block; staged: 1
// to copy the block's [A B] and lam to shared memory first (both from
// chain_kernels.chain_node_launch).
template <typename T>
inline int launch_chain_eval_nodes(const void* const* p, int S, int L, int nx, int nu,
                                   int chains, int staged, void* stream) {
  if (chains < 1 || S < 1 || L < 1) return (int)cudaErrorInvalidValue;
  PtrCursor c{p};
  const ChainData<T> d = chain_data<T>(c, S, L, nx, nu);
  const T* lam = c.in<T>();
  const EvalOut<T> o = eval_out<T>(c);
  T* cqr = c.out<T>();
  const cudaStream_t st = (cudaStream_t)stream;
  return staged ? chain_eval_nodes_launch<T, true>(d, lam, o, cqr, chains, st)
                : chain_eval_nodes_launch<T, false>(d, lam, o, cqr, chains, st);
}

// ---------------------------------------------------------------------------
// The crown kernels a lane group a node (crown_eval.cu, crown_eval_df.cu,
// crown_apply_df.cu): the phases of crown_atb, crown_clip and crown_res
// with a node's columns, elements and rows split over a group of G =
// lanes(nz) lanes, lane c taking column (element, row) c, c + G, ... Each
// element meets the same operations in the same order as in those bodies:
//   A. lane c: atb_n[c] = sum_r [A_n B_n][r, c] v_n[r], r ascending
//      (col_dots; crown_atb_lanes);
//   B. lane c: the kid sum of atb column c in slot order from 0, + extra,
//      then the evaluation's clip (crown_eval_lanes) or the Hessian
//      action's masked products (crown_apply_lanes);
//   C. lane i < nx: residual row i, the x part then the u part of
//      [A_n B_n] [x; u]_par(n) in one sum, + b where given, - x, * nr
//      (row_dots<T, false>); err, where given, the group's max |row|
//      (crown_res_lanes).
// A team (tq_crown.cuh's SizedTeam: one block or one cluster) runs the
// phases with its barrier between them. Group g of the team (block rank's
// groups rank GB .. rank GB + GB - 1) takes nodes g, g + NG, ... (NG
// groups in all) in every phase, and reads their [A B] blocks from global
// memory (staged in shared memory, they were no faster on the H100:
// PERF.md). atb (kids to parent) and x, u (parent to kids) cross groups
// and blocks through global memory behind the team's barrier, read by
// plain loads (never the read-only path: the same launch writes them).
// Each phase's loads that do not depend on the other groups' writes are
// issued between the barrier's two halves for the group's first node.
constexpr int kEvalThreads = 1024;  // the most threads a block of the lane-group kernels has

// A thread's place in the team: its lane c of its group g, the team's NG
// groups, and the shuffle mask of its group's lanes.
template <int G>
struct NodeGroup {
  int lane, g, NG;
  unsigned mask;
  template <typename Team>
  __device__ explicit NodeGroup(const Team& team)
      : lane((int)threadIdx.x % G),
        g(team.rank * (int)(blockDim.x / G) + (int)threadIdx.x / G),
        NG((int)(blockDim.x / G * gridDim.x)),
        mask(((1u << G) - 1) << (threadIdx.x % 32 / G * G)) {}
};

// Phase A: atb_n = [A_n B_n]' v_n for the group's nodes, lane c its
// columns (v widened to T one element at a time, as crown_atb).
template <typename T, int G, typename V>
__device__ inline void crown_atb_lanes(const CrownData<T>& d, const NodeGroup<G>& grp,
                                       const V* __restrict__ v, T* atb) {
  const int nx = d.nx, nz = nx + d.nu;
  for (int n = grp.g; n < d.Nn; n += grp.NG) {
    const T* AB = d.AB + (size_t)n * nx * nz;
    const V* vn = v + (size_t)n * nx;
    for (int c = grp.lane; c < nz; c += G) {
      T acc = T(0);
      for (int r = 0; r < nx; ++r) acc = add(acc, mul(AB[(size_t)r * nz + c], T(vn[r])));
      atb[(size_t)n * nz + c] = acc;
    }
  }
}

// The kid sum of atb column c at node n (kids k0 .. k1 - 1 of kid_idx), in
// slot order from 0, plus the node's extra term.
template <typename T>
__device__ __forceinline__ T kid_sum_lane(const CrownData<T>& d, const T* atb, int k0, int k1,
                                          T extra, int c) {
  const int nz = d.nx + d.nu;
  T ks = T(0);
  for (int k = k0; k < k1; ++k) ks = add(ks, atb[(size_t)d.kid_idx[k] * nz + c]);
  return add(ks, extra);
}

// A lane's operands of phase C for row i of node n: the parent, b (0 where
// b is null), nr and x_n[i] (written by this lane in phase B).
template <typename T>
struct ResIn {
  int p;
  T b, nr, x;
};

template <typename T>
__device__ __forceinline__ ResIn<T> res_in(const CrownData<T>& d, const T* x, const T* b, int n,
                                           int i) {
  ResIn<T> in{0, T(0), T(0), T(0)};
  if (n < d.Nn && i < d.nx) {
    const size_t e = (size_t)n * d.nx + i;
    in.p = d.par[n];
    in.nr = d.nr[e];
    in.x = x[e];
    if (b) in.b = b[e];
  }
  return in;
}

// Phase C: res_n = ([A_n B_n] [x; u]_par(n) (+ b_n) - x_n) * nonroot for
// the group's nodes, lane i row i (nx <= G), and err[n] = max |res_n|
// where err is given; ``in`` holds the group's first node's operands
// (res_in), loaded across the barrier.
template <typename T, int G>
__device__ inline void crown_res_lanes(const CrownData<T>& d, const NodeGroup<G>& grp,
                                       const T* x, const T* u, const T* b, T* res, T* err,
                                       ResIn<T> in) {
  const int nx = d.nx, nu = d.nu, nz = nx + nu, lane = grp.lane;
  for (int n = grp.g; n < d.Nn; n += grp.NG) {
    T emax = T(0);
    if (lane < nx) {
      if (n != grp.g) in = res_in(d, x, b, n, lane);
      const T* AB = d.AB + ((size_t)n * nx + lane) * nz;
      const T* xp = x + (size_t)in.p * nx;
      const T* up = u + (size_t)in.p * nu;
      T acc = T(0);
      for (int c = 0; c < nx; ++c) acc = add(acc, mul(AB[c], xp[c]));
      for (int c = 0; c < nu; ++c) acc = add(acc, mul(AB[nx + c], up[c]));
      const T a = b ? add(acc, in.b) : acc;
      const T rr = mul(sub(a, in.x), in.nr);
      res[(size_t)n * nx + lane] = rr;
      emax = absmax(emax, rr);
    }
    if (err) {
      for (int off = G / 2; off > 0; off /= 2)
        emax = maxof(emax, __shfl_xor_sync(grp.mask, emax, off, G));
      if (lane == 0) err[n] = emax;
    }
  }
}

// A lane's operands of the evaluation's phase B for column c of node n:
// its kid list, the chains' extra term and, for an x element, q, lam,
// Qinv, the bounds, the mask, Qd, b and nr; for a u element r, Rinv, the
// bounds, the mask and Rd in the fields of q, Qi, lo, hi, m and Qd.
template <typename T>
struct ClipIn {
  T extra, q, lam, Qi, lo, hi, m, Qd, b, nr;
  int k0, k1;
};

template <typename T>
__device__ __forceinline__ ClipIn<T> clip_in(const CrownData<T>& d, const T* __restrict__ lam,
                                             const T* __restrict__ extra, int n, int c) {
  const int nx = d.nx, nu = d.nu, nz = nx + nu;
  ClipIn<T> in;
  in.k0 = d.kid_ptr[n];
  in.k1 = d.kid_ptr[n + 1];
  in.extra = in.q = in.lam = in.Qi = in.lo = in.hi = in.m = in.Qd = in.b = in.nr = T(0);
  if (c < nx) {
    const size_t e = (size_t)n * nx + c;
    in.q = d.q[e]; in.lam = lam[e]; in.Qi = d.Qi[e]; in.lo = d.xlo[e]; in.hi = d.xhi[e];
    in.m = d.xm[e]; in.Qd = d.Qd[e]; in.b = d.b[e]; in.nr = d.nr[e];
  } else if (c < nz) {
    const size_t e = (size_t)n * nu + (c - nx);
    in.q = d.r[e]; in.Qi = d.Ri[e]; in.lo = d.ulo[e]; in.hi = d.uhi[e]; in.m = d.um[e];
    in.Qd = d.Rd[e];
  }
  if (c < nz) in.extra = extra[(size_t)n * nz + c];
  return in;
}

// The crown evaluation (crown_eval.cu in float, crown_eval_df.cu in
// double) at the dual point lam: phase A of lam; phase B lane c's clip,
// qt / rt, xU / uU and its term of the dual-value partial, the group then
// folding the terms in column order through shuffles, sx over the x
// elements and su over the u elements, f = sx + su (crown_clip's chunks of
// kCols columns keep the same order); phase C with b.
template <typename T, int G, typename Team>
__device__ inline void crown_eval_lanes(const Team& team, const CrownData<T>& d,
                                        const T* __restrict__ lam, const T* __restrict__ extra,
                                        T* atb, const EvalOut<T>& o) {
  const int nx = d.nx, nu = d.nu, nz = nx + nu, Nn = d.Nn;
  const NodeGroup<G> grp(team);
  const int lane = grp.lane, g = grp.g;

  crown_atb_lanes(d, grp, lam, atb);
  team.arrive();
  ClipIn<T> in{};  // the first node's first columns' operands load across the barrier
  if (g < Nn) in = clip_in(d, lam, extra, g, lane);
  team.wait();

  // B. the kid sums, the clips and the dual-value partials, lane c its
  // elements; the terms folded in column order
  const T half = T(0.5);
  for (int n = g; n < Nn; n += grp.NG) {
    T sx = T(0), su = T(0);
    for (int c0 = 0; c0 < nz; c0 += G) {
      const int c = c0 + lane;
      if (n != g || c0 != 0) in = clip_in(d, lam, extra, n, c);
      T term = T(0);
      if (c < nz) {
        const T ks = kid_sum_lane(d, atb, in.k0, in.k1, in.extra, c);
        if (c < nx) {
          const size_t e = (size_t)n * nx + c;
          const T qm = mul(sub(add(-in.q, in.lam), ks), in.m);
          const T xu = mul(in.Qi, qm);
          const T xv = mul(clip(xu, in.lo, in.hi), in.m);
          o.x[e] = xv;
          o.qt[e] = (xu > in.hi || xu < in.lo) ? T(0) : in.Qi;
          if (o.xU) o.xU[e] = xu;
          term = sub(mul(xv, sub(qm, mul(mul(half, in.Qd), xv))), mul(mul(in.b, in.lam), in.nr));
        } else {
          const size_t e = (size_t)n * nu + (c - nx);
          const T rm = mul(sub(-in.q, ks), in.m);
          const T uu = mul(in.Qi, rm);
          const T uv = mul(clip(uu, in.lo, in.hi), in.m);
          o.u[e] = uv;
          o.rt[e] = (uu > in.hi || uu < in.lo) ? T(0) : in.Qi;
          if (o.uU) o.uU[e] = uu;
          term = mul(uv, sub(rm, mul(mul(half, in.Qd), uv)));
        }
      }
      for (int k = 0; k < G && c0 + k < nz; ++k) {
        const T t = __shfl_sync(grp.mask, term, k, G);
        if (c0 + k < nx)
          sx = add(sx, t);
        else
          su = add(su, t);
      }
    }
    if (lane == 0) o.f[n] = add(sx, su);
  }
  team.arrive();
  const ResIn<T> rin = res_in(d, o.x, d.b, g, lane);
  team.wait();

  crown_res_lanes(d, grp, o.x, o.u, d.b, o.res, o.err, rin);
}

// A lane's operands of the Hessian action's phase B for column c of node
// n: its kid list, the extra term and, for an x element, qtilde, the
// direction d (widened to double) and xm; for a u element rtilde and um
// in the fields of t and m (dv 0).
struct ApplyIn {
  double extra, t, dv, m;
  int k0, k1;
};

__device__ __forceinline__ ApplyIn apply_in(const CrownData<double>& cd,
                                            const double* __restrict__ qt,
                                            const double* __restrict__ rt,
                                            const float* __restrict__ dv,
                                            const double* __restrict__ extra, int n, int c) {
  const int nx = cd.nx, nu = cd.nu, nz = nx + nu;
  ApplyIn in;
  in.k0 = cd.kid_ptr[n];
  in.k1 = cd.kid_ptr[n + 1];
  in.extra = in.t = in.dv = in.m = 0.0;
  if (c < nx) {
    const size_t e = (size_t)n * nx + c;
    in.t = qt[e]; in.dv = (double)dv[e]; in.m = cd.xm[e];
  } else if (c < nz) {
    const size_t e = (size_t)n * nu + (c - nx);
    in.t = rt[e]; in.m = cd.um[e];
  }
  if (c < nz) in.extra = extra[(size_t)n * nz + c];
  return in;
}

// The crown half of the high-precision phase's Hessian action
// (crown_apply_df.cu) on the f32 direction dv, with the masked inverses
// qt / rt: phase A of dv; phase B lane c's
//   xl = (qtilde (dv - s_A)) xm,  ul = (rtilde (-s_B)) um
// (s the kid sum plus extra; each operation rounded on its own, in the
// one-thread kernel's order); phase C without b or err.
template <int G, typename Team>
__device__ inline void crown_apply_lanes(const Team& team, const CrownData<double>& cd,
                                         const double* __restrict__ qt,
                                         const double* __restrict__ rt,
                                         const float* __restrict__ dv,
                                         const double* __restrict__ extra, double* atb,
                                         double* xl, double* ul, double* res) {
  const int nx = cd.nx, nu = cd.nu, nz = nx + nu, Nn = cd.Nn;
  const NodeGroup<G> grp(team);
  const int lane = grp.lane, g = grp.g;

  crown_atb_lanes(cd, grp, dv, atb);
  team.arrive();
  ApplyIn in{};  // the first node's first columns' operands load across the barrier
  if (g < Nn) in = apply_in(cd, qt, rt, dv, extra, g, lane);
  team.wait();

  // B. the kid sums and the masked products, lane c its elements
  for (int n = g; n < Nn; n += grp.NG) {
    for (int c0 = 0; c0 < nz; c0 += G) {
      const int c = c0 + lane;
      if (n != g || c0 != 0) in = apply_in(cd, qt, rt, dv, extra, n, c);
      if (c < nz) {
        const double s = kid_sum_lane(cd, atb, in.k0, in.k1, in.extra, c);
        if (c < nx)
          xl[(size_t)n * nx + c] = mul(mul(in.t, sub(in.dv, s)), in.m);
        else
          ul[(size_t)n * nu + (c - nx)] = mul(mul(in.t, -s), in.m);
      }
    }
  }
  team.arrive();
  const ResIn<double> rin = res_in<double>(cd, xl, nullptr, g, lane);
  team.wait();

  crown_res_lanes<double, G>(cd, grp, xl, ul, nullptr, res, nullptr, rin);
}

// The lane-group evaluation kernel of crown_eval.cu (float) and
// crown_eval_df.cu (double), its team one cluster of ``blocks`` blocks or
// one block (SizedTeam).
template <typename T, int G>
__global__ void __launch_bounds__(kEvalThreads) crown_eval_lanes_kernel(
    const CrownData<T> d, const T* __restrict__ lam, const T* __restrict__ extra, T* atb,
    const EvalOut<T> o, int blocks) {
  crown_eval_lanes<T, G>(SizedTeam(blocks), d, lam, extra, atb, o);
}

// p: CROWN_DATA_KEYS (15), par, kid_ptr, kid_idx, lam, extra, atb
// (scratch), then x, u, qt, rt, xU, uU, res, f, err (null: not written);
// all T but the indices. blocks: one cluster of 2 .. 16 blocks, or one
// block; threads a block (a multiple of 32, at most kEvalThreads; both
// from crown_kernels._crown_eval_launch).
template <typename T>
static inline int launch_crown_eval_lanes(const void* const* p, int Nn, int nx, int nu,
                                          int blocks, int threads, void* stream) {
  if (Nn < 1 || nx < 1 || nu < 1 || threads < 32 || threads % 32 || threads > kEvalThreads)
    return (int)cudaErrorInvalidValue;
  PtrCursor c{p};
  const CrownData<T> d = crown_data<T>(c, Nn, nx, nu);
  const T* lam = c.in<T>();
  const T* extra = c.in<T>();
  T* atb = c.out<T>();
  const EvalOut<T> o = eval_out<T>(c);
  const cudaStream_t st = (cudaStream_t)stream;
  if (lanes(nx + nu) == 8) {
    static TeamLimits lim;
    return launch_team(crown_eval_lanes_kernel<T, 8>, blocks, threads, 0, lim, st, d, lam, extra,
                       atb, o, blocks);
  }
  static TeamLimits lim;
  return launch_team(crown_eval_lanes_kernel<T, 16>, blocks, threads, 0, lim, st, d, lam, extra,
                     atb, o, blocks);
}

}  // namespace tq

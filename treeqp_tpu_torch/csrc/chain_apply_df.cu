// Chain half of the dual-Hessian action M d of the high-precision phase, in
// native f64, one thread per chain.
//
// Replaces the Pallas kernel chain_apply_df of
// treeqp_tpu/ops/df_eval_kernels.py ((hi, lo) f32 pairs there). With the
// chain's masked inverses qt/rt (from chain_eval_df) and an f32 direction
// d [S, L, nx], per chain node j:
//   xl_j = qt_j (d_j - A_{j+1}' d_{j+1}),   ul_j = rt_j (0 - B_{j+1}' d_{j+1})
//   (no kid term at j = L-1), the linearized residual rows
//   res_j = -xl_j + A_j xl_{j-1} + B_j ul_{j-1} (j >= 1; row 0 is -xl_0, the
//   caller adds A_0 [xl; ul] of the crown root), and the root contributions
//   cqr = [A_0 B_0]' d_0 (nz values) that crown_apply_df takes as extra.
// The direction is widened to f64 on read; every operation is rounded on its
// own in the plain twin's order.
//
// What bounds it on the card: latency, as chain_eval_df.cu (the same walk
// without the clipping).

#include "tq_eval.cuh"

namespace {

struct ApplyArgs {
  const double *AB, *qt, *rt;
  const float* d;
  double *xl, *ul, *res, *cqr;
  int S, L, nx, nu;
};

__global__ void chain_apply_df_kernel(const ApplyArgs a) {
  using tq::add;
  using tq::col_dot;
  using tq::mul;
  using tq::row_dot;
  using tq::sub;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= a.S) return;
  const int L = a.L, nx = a.nx, nu = a.nu, nz = nx + nu;
  for (int j = 0; j < L; ++j) {
    const size_t sj = (size_t)s * L + j;
    const float* dj = a.d + sj * nx;
    const bool kid = j < L - 1;
    const double* ABn = a.AB + (sj + 1) * nx * nz;
    const float* dn = a.d + (sj + 1) * nx;
    for (int i = 0; i < nx; ++i) {
      double qm = (double)dj[i];
      if (kid) qm = sub(qm, col_dot(ABn, dn, i, nx, nz));
      a.xl[sj * nx + i] = mul(a.qt[sj * nx + i], qm);
    }
    for (int i = 0; i < nu; ++i) {
      double rm = 0.0;
      if (kid) rm = sub(rm, col_dot(ABn, dn, nx + i, nx, nz));
      a.ul[sj * nu + i] = mul(a.rt[sj * nu + i], rm);
    }
    const double* AB = a.AB + sj * nx * nz;
    for (int i = 0; i < nx; ++i) {
      double rr = -a.xl[sj * nx + i];
      if (j > 0) {
        rr = add(add(rr, row_dot(AB, a.xl + (sj - 1) * nx, i, nx, nz)),
                 row_dot(AB + nx, a.ul + (sj - 1) * nu, i, nu, nz));
      }
      a.res[sj * nx + i] = rr;
    }
  }
  const double* AB0 = a.AB + (size_t)s * L * nx * nz;
  const float* d0 = a.d + (size_t)s * L * nx;
  for (int c = 0; c < nz; ++c) a.cqr[(size_t)s * nz + c] = col_dot(AB0, d0, c, nx, nz);
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int tq_chain_apply_df(const double* AB, const double* qt, const double* rt,
                                 const float* d, double* xl, double* ul, double* res,
                                 double* cqr, int S, int L, int nx, int nu, void* stream) {
  const ApplyArgs a{AB, qt, rt, d, xl, ul, res, cqr, S, L, nx, nu};
  chain_apply_df_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

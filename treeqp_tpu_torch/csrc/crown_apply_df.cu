// Crown half of the dual-Hessian action M d of the high-precision phase, in
// native f64, in one launch of one thread block.
//
// Replaces the Pallas kernel crown_apply_df of
// treeqp_tpu/ops/df_eval_kernels.py ((hi, lo) f32 pairs and one-hot kid and
// parent matrices there; doubles and the kid lists / par here, no node cap).
// With the crown's masked inverses qtilde/rtilde (from crown_eval_df), an
// f32 direction d [Nn, nxm] and the chains' root contributions extra
// [Nn, nz] (chain_apply_df's cqr at the root nodes), three phases with a
// barrier between them, as crown_eval_df:
//   A. atb_n = [A_n B_n]' d_n
//   B. s = kid sum of atb (slot order) + extra;
//      xl_n = qtilde_n (d_n - s_A) xm_n,  ul_n = rtilde_n (-s_B) um_n
//   C. res_n = ([A_n B_n] [xl; ul]_par(n) - xl_n) * nonroot
// M d is then -res on the crown. Every operation is rounded on its own in
// the plain twin's order (tq_eval.cuh).
//
// What bounds it on the card: latency (one block, two barriers).

#include "tq_eval.cuh"

namespace {

__global__ void __launch_bounds__(1024) crown_apply_df_kernel(
    tq::CrownData<double> cd, const double* __restrict__ qt, const double* __restrict__ rt,
    const float* __restrict__ d, const double* __restrict__ extra, double* __restrict__ atb,
    double* __restrict__ xl, double* __restrict__ ul, double* __restrict__ res) {
  using tq::mul;
  using tq::sub;
  const int nx = cd.nx, nu = cd.nu;
  for (int n = threadIdx.x; n < cd.Nn; n += blockDim.x) tq::crown_atb(cd, d, atb, n);
  __syncthreads();
  for (int n = threadIdx.x; n < cd.Nn; n += blockDim.x) {
    for (int i = 0; i < nx; ++i) {
      const size_t e = (size_t)n * nx + i;
      const double sA = tq::crown_kid_sum(cd, atb, extra, n, i);
      xl[e] = mul(mul(qt[e], sub((double)d[e], sA)), cd.xm[e]);
    }
    for (int i = 0; i < nu; ++i) {
      const size_t e = (size_t)n * nu + i;
      const double sB = tq::crown_kid_sum(cd, atb, extra, n, nx + i);
      ul[e] = mul(mul(rt[e], -sB), cd.um[e]);
    }
  }
  __syncthreads();
  for (int n = threadIdx.x; n < cd.Nn; n += blockDim.x)
    tq::crown_res<double>(cd, xl, ul, nullptr, res, nullptr, n);
}

}  // namespace

// p: CROWN_DATA_KEYS (15, f64), par, kid_ptr, kid_idx, qt, rt, d (f32),
// extra, atb (scratch), then xl, ul, res.
extern "C" int tq_crown_apply_df(const void* const* p, int Nn, int nx, int nu, int threads,
                                 void* stream) {
  tq::PtrCursor c{p};
  const tq::CrownData<double> cd = tq::crown_data<double>(c, Nn, nx, nu);
  const double* qt = c.in<double>();
  const double* rt = c.in<double>();
  const float* d = c.in<float>();
  const double* extra = c.in<double>();
  double* atb = c.out<double>();
  double* xl = c.out<double>();
  double* ul = c.out<double>();
  double* res = c.out<double>();
  crown_apply_df_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(cd, qt, rt, d, extra, atb,
                                                                  xl, ul, res);
  return (int)cudaGetLastError();
}

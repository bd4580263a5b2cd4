// Chain half of the dual-Hessian action M d of the high-precision phase, in
// native f64, a thread a chain node.
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
// own in the plain twin's order (no DFMA), each column of A' d in col_dot's
// order and each residual row's two sums kept apart, so the outputs equal
// the twin's bit for bit.
//
// What bounds it on the card: latency, as chain_eval_df.cu, whose design
// this kernel shares (the same walk without the clipping): ``chains`` whole
// chains a block, a thread a node, the block's [A B] blocks and d rows
// staged in shared memory where they fit; 1. every node's xl, ul (and each
// chain's cqr at j = 0), 2. after a barrier, every node's residual row from
// its parent's xl, ul.

#include "tq_eval.cuh"
#include "tq_lanes.cuh"

namespace {

struct ApplyArgs {
  const double *AB, *qt, *rt;
  const float* d;
  double *xl, *ul, *res, *cqr;
  int S, L, nx, nu;
};

template <bool kStaged>
__global__ void __launch_bounds__(tq::kNodeThreads) chain_apply_df_kernel(const ApplyArgs a,
                                                                          int chains) {
  using tq::add;
  using tq::kCols;
  using tq::mul;
  using tq::sub;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, nx = a.nx, nu = a.nu, nz = nx + nu;
  const int s0 = blockIdx.x * chains;
  const int nn = min(chains, a.S - s0) * L;  // this block's nodes
  const size_t e0 = (size_t)s0 * L;
  const double* AB = a.AB + e0 * nx * nz;
  const float* dd = a.d + e0 * nx;
  if (kStaged) {
    AB = tq::stage_async(smem, AB, (size_t)nn * nx * nz);
    dd = tq::stage_async(smem + tq::tile_bytes((size_t)chains * L * nx * nz, sizeof(double)),
                         dd, (size_t)nn * nx);
    tq::cp_async_commit();
    tq::cp_async_wait<0>();
    __syncthreads();
  }
  // 1. the linear stage response, the roots' cqr
  for (int k = threadIdx.x; k < nn; k += blockDim.x) {
    const int j = k % L;
    const bool kid = j < L - 1;
    const size_t sj = e0 + k;
    const float* dj = dd + (size_t)k * nx;
    const double* ABn = AB + (size_t)(k + 1) * nx * nz;
    const float* dn = dd + (size_t)(k + 1) * nx;
    for (int c0 = 0; c0 < nz; c0 += kCols) {
      double kt[kCols];  // col_dot(ABn, dn, c0 + c) of the chunk's columns
      if (kid) {
        tq::col_dots(ABn, dn, c0, nz, nx, nz, kt);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) kt[c] = 0.0;
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = c0 + c;
        if (col < nx) {
          double qm = (double)dj[col];
          if (kid) qm = sub(qm, kt[c]);
          a.xl[sj * nx + col] = mul(a.qt[sj * nx + col], qm);
        } else if (col < nz) {
          double rm = 0.0;
          if (kid) rm = sub(rm, kt[c]);
          a.ul[sj * nu + col - nx] = mul(a.rt[sj * nu + col - nx], rm);
        }
      }
    }
    if (j == 0)
      tq::chain_root_cqr_at(AB + (size_t)k * nx * nz, dj, nx, nz,
                            a.cqr + (size_t)(s0 + k / L) * nz);
  }
  __syncthreads();
  // 2. the linearized residual rows
  for (int k = threadIdx.x; k < nn; k += blockDim.x) {
    const int j = k % L;
    const size_t sj = e0 + k;
    if (j == 0) {
      for (int i = 0; i < nx; ++i) a.res[sj * nx + i] = -a.xl[sj * nx + i];
      continue;
    }
    // row_dot(AB_j, xl_{j-1}, i) and row_dot(AB_j + nx, ul_{j-1}, i)
    double ax[tq::kRows], au[tq::kRows];
    tq::row_dots<double, true>(AB + (size_t)k * nx * nz, a.xl + (sj - 1) * nx,
                               a.ul + (sj - 1) * nu, nx, nu, nz, ax, au);
#pragma unroll
    for (int i = 0; i < tq::kRows; ++i)
      if (i < nx) a.res[sj * nx + i] = add(add(-a.xl[sj * nx + i], ax[i]), au[i]);
  }
}

template <bool kStaged>
int launch(const ApplyArgs& a, int chains, cudaStream_t st) {
  const size_t nodes = (size_t)chains * a.L;
  const size_t bytes = kStaged ? tq::tile_bytes(nodes * a.nx * (a.nx + a.nu), sizeof(double)) +
                                     tq::tile_bytes(nodes * a.nx, sizeof(float))
                               : 0;
  static size_t opted = 48 * 1024;
  const cudaError_t e = tq::opt_in_smem(chain_apply_df_kernel<kStaged>, bytes, opted);
  if (e != cudaSuccess) return (int)e;
  const int threads = (int)(nodes < tq::kNodeThreads ? nodes : tq::kNodeThreads);
  chain_apply_df_kernel<kStaged><<<(a.S + chains - 1) / chains, threads, bytes, st>>>(a, chains);
  return (int)cudaGetLastError();
}

}  // namespace

// chains: whole chains a block; staged: 1 to copy the block's [A B] and d
// to shared memory first (both from chain_kernels.chain_node_launch).
extern "C" int tq_chain_apply_df(const double* AB, const double* qt, const double* rt,
                                 const float* d, double* xl, double* ul, double* res,
                                 double* cqr, int S, int L, int nx, int nu, int chains,
                                 int staged, void* stream) {
  if (chains < 1 || S < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const ApplyArgs a{AB, qt, rt, d, xl, ul, res, cqr, S, L, nx, nu};
  const cudaStream_t st = (cudaStream_t)stream;
  return staged ? launch<true>(a, chains, st) : launch<false>(a, chains, st);
}

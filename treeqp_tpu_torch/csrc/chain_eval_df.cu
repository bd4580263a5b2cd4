// Chain stage evaluation at a dual point of the high-precision phase, in
// native f64, a thread a chain node.
//
// Replaces the Pallas kernel chain_eval_df of
// treeqp_tpu/ops/df_eval_kernels.py, which carries every value as an
// (hi, lo) pair of f32 words because TPU Pallas has no f64. Hopper has
// native FP64, so this is the f32 chain evaluation's body in double
// (tq_eval.cuh): clipping stage solve, masked inverses qt/rt (Qinv or 0),
// xUnc/uUnc, the residual rows (row 0 without A_0 z_crown), cqr =
// [A_0 B_0]' lam_0 and the per-chain dual-value partials. Every operation
// is rounded on its own (__dmul_rn, __dadd_rn, __dsub_rn: no DFMA) in the
// plain twin's order, so the outputs and active sets equal the twin's bit
// for bit.
//
// What bounds it on the card: latency. A launch moves ~5.2 MB at the bench
// path's S = 256 chains of L = 16 nodes (nx = 6, nu = 4), ~1.6 us at the
// card's memory rate, and each node's work is a chain of ~60 dependent
// FP64 operations. The kernel it replaces ran a thread a chain (2 blocks of
// 128 threads on 2 of 132 SMs), each thread walking its 16 nodes one after
// another with its lanes' loads 7.7 KB apart. Design (newton_iter.cu's
// evaluation, without the crown or a cluster):
// - ``chains`` whole chains a block (chain_df_launch in
//   ops/df_eval_kernels.py), a thread a node;
// - with ``staged``, the block's [A B] blocks and lam rows are copied to
//   shared memory first (one contiguous tile each, 16-byte cp.async copies
//   on neighbouring addresses); each node's block is then read by its own
//   thread (the residual row) and its parent's (the kid term). Shapes whose
//   tile does not fit read global memory;
// - 1. every node's clip (tq::chain_clip_at), its dual-value partials
//   parked in shared memory, and each chain's cqr by its node j = 0;
//   2. after a barrier, every node's residual row, which needs x_{j-1},
//   u_{j-1} (tq::chain_res_at); 3. each chain's partials summed in j order
//   by one thread, as chain_eval_one sums them.
// Every element meets the operations of the one-thread-a-chain walk in the
// same order, so every output equals that kernel's bit for bit.
// No tensor cores: FP64 mma fuses each product into its sum, and the active
// sets rest on the twin's separately rounded bits.

#include "tq_eval.cuh"
#include "tq_lanes.cuh"

namespace {

using tq::ChainData;
using tq::EvalOut;

template <bool kStaged>
__global__ void __launch_bounds__(tq::kNodeThreads) chain_eval_df_kernel(
    const ChainData<double> d, const double* __restrict__ lam, const EvalOut<double> o,
    double* __restrict__ cqr, int chains) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = d.L, nx = d.nx, nz = nx + d.nu;
  const int s0 = blockIdx.x * chains;
  const int nn = min(chains, d.S - s0) * L;  // this block's nodes
  const size_t e0 = (size_t)s0 * L;
  double* sx = reinterpret_cast<double*>(smem);  // [chains L] each
  double* su = sx + (size_t)chains * L;
  const double* AB = d.AB + e0 * nx * nz;
  const double* lm = lam + e0 * nx;
  if (kStaged) {
    unsigned char* buf = reinterpret_cast<unsigned char*>(su + (size_t)chains * L);
    AB = tq::stage_async(buf, AB, (size_t)nn * nx * nz);
    buf += tq::tile_bytes((size_t)chains * L * nx * nz, sizeof(double));
    lm = tq::stage_async(buf, lm, (size_t)nn * nx);
    tq::cp_async_commit();
    tq::cp_async_wait<0>();
    __syncthreads();
  }
  // 1. the clips, the partials, the roots' cqr
  for (int k = threadIdx.x; k < nn; k += blockDim.x) {
    const int j = k % L;
    double a, b;
    tq::chain_clip_at(d, lm + (size_t)k * nx, AB + (size_t)(k + 1) * nx * nz,
                      lm + (size_t)(k + 1) * nx, o, e0 + k, j < L - 1, a, b);
    sx[k] = a;
    su[k] = b;
    if (j == 0)
      tq::chain_root_cqr_at(AB + (size_t)k * nx * nz, lm + (size_t)k * nx, nx, nz,
                            cqr + (size_t)(s0 + k / L) * nz);
  }
  __syncthreads();
  // 2. the residual rows
  for (int k = threadIdx.x; k < nn; k += blockDim.x)
    tq::chain_res_at(d, AB + (size_t)k * nx * nz, o, e0 + k, k % L);
  // 3. each chain's dual-value partial (sx, su complete since the barrier)
  for (int c = threadIdx.x; c * L < nn; c += blockDim.x) {
    double facc = 0.0;
    for (int j = 0; j < L; ++j) facc = tq::add(tq::add(facc, sx[c * L + j]), su[c * L + j]);
    o.f[s0 + c] = facc;
  }
}

template <bool kStaged>
int launch(const ChainData<double>& d, const double* lam, const EvalOut<double>& o,
           double* cqr, int chains, cudaStream_t st) {
  const size_t nodes = (size_t)chains * d.L, nz = d.nx + d.nu;
  size_t bytes = 2 * nodes * sizeof(double);
  if (kStaged)
    bytes += tq::tile_bytes(nodes * d.nx * nz, sizeof(double)) +
             tq::tile_bytes(nodes * d.nx, sizeof(double));
  static size_t opted = 48 * 1024;
  const cudaError_t e = tq::opt_in_smem(chain_eval_df_kernel<kStaged>, bytes, opted);
  if (e != cudaSuccess) return (int)e;
  const int threads = (int)(nodes < tq::kNodeThreads ? nodes : tq::kNodeThreads);
  chain_eval_df_kernel<kStaged><<<(d.S + chains - 1) / chains, threads, bytes, st>>>(
      d, lam, o, cqr, chains);
  return (int)cudaGetLastError();
}

}  // namespace

// p: CHAIN_DATA_KEYS (12, f64), lam, then x, u, qt, rt, xU, uU, res, f,
// err (null), cqr; all f64. chains: whole chains a block; staged: 1 to copy
// the block's [A B] and lam to shared memory first (both from
// chain_df_launch).
extern "C" int tq_chain_eval_df(const void* const* p, int S, int L, int nx, int nu,
                                int chains, int staged, void* stream) {
  if (chains < 1 || S < 1 || L < 1) return (int)cudaErrorInvalidValue;
  tq::PtrCursor c{p};
  const ChainData<double> d = tq::chain_data<double>(c, S, L, nx, nu);
  const double* lam = c.in<double>();
  const EvalOut<double> o = tq::eval_out<double>(c);
  double* cqr = c.out<double>();
  const cudaStream_t st = (cudaStream_t)stream;
  return staged ? launch<true>(d, lam, o, cqr, chains, st)
                : launch<false>(d, lam, o, cqr, chains, st);
}

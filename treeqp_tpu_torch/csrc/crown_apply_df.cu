// Crown half of the dual-Hessian action M d of the high-precision phase, in
// native f64, in one launch of one thread-block cluster (or one block), a
// group of lanes a crown node.
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
// M d is then -res on the crown. There is no + b in phase C: adding a zero
// would turn a -0 into +0, and the outputs' bits are held to the twin's.
//
// What bounds it on the card: latency. A launch moves ~0.48 MB at the bench
// path's 341-node crown (nx = 6, nu = 4), ~0.14 us at the card's memory
// rate; each phase is a short chain of dependent FP64 operations a node
// between two barriers. Design: crown_eval_df.cu's (tq::crown_apply_lanes,
// tq_eval.cuh, which shares crown_eval_lanes' phases A and C,
// crown_atb_lanes and crown_res_lanes): a group of tq::lanes(nz) lanes a
// node, lane c its column c of phase A, its element c of phase B and its
// row c of phase C (c + G, ... where nz > G), so that a group's loads of a
// block's row or column coalesce; one cluster of 16 blocks
// (crown_kernels._crown_eval_launch); atb and xl, ul crossing blocks
// through global memory behind the cluster's split barrier (plain loads),
// each group's first node's loop-invariant operands loaded between the
// barrier's two halves. It replaced a one-block kernel, a thread a node,
// whose threads read their own [A B] blocks uncoalesced. What holds it
// back: the phases' dependent operations and the two cluster barriers,
// each with its release's memory fence.
//
// Every operation is rounded on its own (__dmul_rn, __dadd_rn, __dsub_rn:
// no DFMA) in the plain twin's order, so the outputs equal the twin's and
// the one-block kernel's bit for bit. No tensor cores: each step is a dot
// of at most nz terms or a per-element product.

#include "tq_eval.cuh"

namespace {

using tq::CrownData;

template <int G>
__global__ void __launch_bounds__(tq::kEvalThreads) crown_apply_df_kernel(
    const CrownData<double> cd, const double* __restrict__ qt, const double* __restrict__ rt,
    const float* __restrict__ d, const double* __restrict__ extra, double* atb, double* xl,
    double* ul, double* res, int blocks) {
  tq::crown_apply_lanes<G>(tq::SizedTeam(blocks), cd, qt, rt, d, extra, atb, xl, ul, res);
}

template <int G>
int launch(const CrownData<double>& cd, const double* qt, const double* rt, const float* d,
           const double* extra, double* atb, double* xl, double* ul, double* res, int blocks,
           int threads, cudaStream_t st) {
  static tq::TeamLimits lim;
  return tq::launch_team(crown_apply_df_kernel<G>, blocks, threads, 0, lim, st, cd, qt, rt, d,
                         extra, atb, xl, ul, res, blocks);
}

}  // namespace

// p: CROWN_DATA_KEYS (15, f64), par, kid_ptr, kid_idx, qt, rt, d (f32),
// extra, atb (scratch), then xl, ul, res; f64 but d and the indices.
// blocks: one cluster of 2 .. 16 blocks, or one block; threads a block (a
// multiple of 32, at most 1024; both from crown_kernels._crown_eval_launch).
extern "C" int tq_crown_apply_df(const void* const* p, int Nn, int nx, int nu, int blocks,
                                 int threads, void* stream) {
  if (Nn < 1 || nx < 1 || nu < 1 || threads < 32 || threads % 32 ||
      threads > tq::kEvalThreads)
    return (int)cudaErrorInvalidValue;
  tq::PtrCursor c{p};
  const CrownData<double> cd = tq::crown_data<double>(c, Nn, nx, nu);
  const double* qt = c.in<double>();
  const double* rt = c.in<double>();
  const float* d = c.in<float>();
  const double* extra = c.in<double>();
  double* atb = c.out<double>();
  double* xl = c.out<double>();
  double* ul = c.out<double>();
  double* res = c.out<double>();
  const cudaStream_t st = (cudaStream_t)stream;
  if (tq::lanes(nx + nu) == 8)
    return launch<8>(cd, qt, rt, d, extra, atb, xl, ul, res, blocks, threads, st);
  return launch<16>(cd, qt, rt, d, extra, atb, xl, ul, res, blocks, threads, st);
}

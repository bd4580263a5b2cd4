// Chain stage evaluation at a dual point of the high-precision phase, in
// native f64, one thread per chain.
//
// Replaces the Pallas kernel chain_eval_df of
// treeqp_tpu/ops/df_eval_kernels.py, which carries every value as an
// (hi, lo) pair of f32 words because TPU Pallas has no f64. Hopper has
// native FP64, so this is the f32 chain evaluation's body instantiated in
// double (tq::chain_eval_kernel<double>, tq_eval.cuh): clipping stage solve,
// masked inverses qt/rt (Qinv or 0), xUnc/uUnc, the residual rows (row 0
// without A_0 z_crown), cqr = [A_0 B_0]' lam_0 and the per-chain dual-value
// partials. Every operation is rounded on its own (__dmul_rn, __dadd_rn,
// __dsub_rn) in the plain twin's order, so the outputs and active sets
// equal the twin's bit for bit.
//
// What bounds it on the card: latency, as chain_eval.cu; FP64 runs at half
// the FP32 rate on the H100, which this serial per-thread walk does not
// reach.

#include "tq_eval.cuh"

// p: CHAIN_DATA_KEYS (12, f64), lam, then x, u, qt, rt, xU, uU, res, f,
// err (null), cqr; all f64.
extern "C" int tq_chain_eval_df(const void* const* p, int S, int L, int nx, int nu,
                                void* stream) {
  return tq::launch_chain_eval<double>(p, S, L, nx, nu, stream);
}

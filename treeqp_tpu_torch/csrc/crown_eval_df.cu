// Crown stage evaluation at a dual point of the high-precision phase, in
// native f64, in one launch of one thread block.
//
// Replaces the Pallas kernel crown_eval_df of
// treeqp_tpu/ops/df_eval_kernels.py. The TPU kernel carried (hi, lo) f32
// pairs and did the kid sum with one one-hot [NPc, NPc] matmul per kid slot
// (exact copies, then df adds) and the parent gather with another, which
// capped the crown by VMEM. Here the values are doubles and the kid sum and
// parent gather read the kid lists and par (crown_kernels.eval_sched), so
// the crown has no node cap. The kernel is the f32 crown evaluation's
// instantiated in double (tq::crown_eval_kernel<double>, tq_eval.cuh):
//   A. atb_n = [A_n B_n]' lam_n
//   B. kid sum of atb (slot order) + extra, clip, qtilde/rtilde, f_n
//   C. res_n = ([A_n B_n] z_par(n) + b_n - x_n) * nonroot
// Every operation is rounded on its own in the plain twin's order, so the
// outputs and active sets equal the twin's bit for bit.
//
// What bounds it on the card: latency (one block, two barriers).

#include "tq_eval.cuh"

// p: CROWN_DATA_KEYS (15, f64), par, kid_ptr, kid_idx, lam, extra, atb
// (scratch), then x, u, qt, rt, xU, uU, res, f, err (null); all f64.
extern "C" int tq_crown_eval_df(const void* const* p, int Nn, int nx, int nu,
                                int threads, void* stream) {
  return tq::launch_crown_eval<double>(p, Nn, nx, nu, threads, stream);
}

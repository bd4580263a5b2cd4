// Crown stage evaluation at a dual point, f32, in one launch of one thread
// block.
//
// Replaces the Pallas kernel crown_eval of treeqp_tpu/ops/crown_kernels.py:
// modified gradients with the chain-root contributions injected, the
// clipping stage solve, the active-set masked inverses, the dual residual
// and the per-node dual-value partials. The TPU kernel put the nodes on the
// lanes and did the kid sum and the parent gather as matmuls against a
// one-hot [NPc, NPc] parent matrix (which capped the crown at 2048 nodes of
// VMEM); here they are indexed reads over the kid lists and par. Three
// phases depend on each other across nodes, so threads stride over the
// nodes with a barrier between them (tq::crown_eval_kernel<float> in
// tq_eval.cuh; its bodies run in newton_iter.cu too, its double instance is
// crown_eval_df.cu):
//   A. atb_n = [A_n B_n]' lam_n                   (scratch [Nn, nz])
//   B. kid sum of atb + extra, clip, qt/rt, f_n    (needs A of the kids)
//   C. res_n = [A_n B_n] z_par(n) + b_n - x_n      (needs B of the parent)
//
// What bounds it on the card: latency. The work is ~Nn * 6 nx nz flops
// (~80k at the 341-node headline crown), spread over one block; each phase
// is a short dependent sum per thread plus a barrier.

#include "tq_eval.cuh"

// p: CROWN_DATA_KEYS (15), par, kid_ptr, kid_idx, lam, extra, atb (scratch),
// then x, u, qt, rt, xU, uU, res, f, err.
extern "C" int tq_crown_eval(const void* const* p, int Nn, int nx, int nu,
                             int threads, void* stream) {
  return tq::launch_crown_eval<float>(p, Nn, nx, nu, threads, stream);
}

// Crown stage evaluation at a dual point, f32, in one launch of one
// thread-block cluster (or one block), a group of lanes a crown node.
//
// Replaces the Pallas kernel crown_eval of treeqp_tpu/ops/crown_kernels.py:
// modified gradients with the chain-root contributions injected, the
// clipping stage solve, the active-set masked inverses, the dual residual
// and the per-node dual-value partials. The TPU kernel put the nodes on the
// lanes and did the kid sum and the parent gather as matmuls against a
// one-hot [NPc, NPc] parent matrix (which capped the crown at 2048 nodes of
// VMEM); here they are indexed reads over the kid lists and par
// (crown_kernels.eval_sched), so the crown has no node cap. Three phases
// depend on each other across nodes:
//   A. atb_n = [A_n B_n]' lam_n                   (scratch [Nn, nz])
//   B. kid sum of atb + extra, clip, qt/rt, f_n    (needs A of the kids)
//   C. res_n = [A_n B_n] z_par(n) + b_n - x_n      (needs B of the parent)
//
// What bounds it on the card: latency. A launch moves ~0.26 MB at the
// 341-node crowns of the two-norm path (nx = 6, nu = 4) and tdunes_ms_f32
// (nx = 8, nu = 1), ~0.08 us at the card's memory rate; each phase is a
// chain of dependent FP32 operations a node (nx products, a kid sum, a fold
// of nz terms) between two barriers. Design: crown_eval_df.cu's, in float
// (tq::crown_eval_lanes_kernel<float, G>, tq_eval.cuh): a group of
// tq::lanes(nz) lanes a node, lane c its column, element and row c (c + G,
// ... where nz > G), so that a group's loads of a block's row or column
// coalesce; one cluster of 16 blocks (crown_kernels._crown_eval_launch),
// atb and x, u crossing blocks through global memory behind the cluster's
// split barrier. It replaced a one-block kernel, a thread a node, whose
// threads read their own [A B] blocks uncoalesced. What holds it back: the
// three phases' dependent operations and the two cluster barriers, each
// with its release's memory fence.
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn:
// no FFMA) in the one-thread bodies' order (tq::crown_atb, crown_clip,
// crown_res, which newton_iter.cu runs), so the outputs equal the one-block
// kernel's bit for bit and the active sets the plain twin's. No tensor
// cores: each step is a per-node clip or a dot of at most nz terms.

#include "tq_eval.cuh"

// p: CROWN_DATA_KEYS (15), par, kid_ptr, kid_idx, lam, extra, atb (scratch),
// then x, u, qt, rt, xU, uU, res, f, err (null: not written); all f32 but
// the indices. blocks, threads: crown_kernels._crown_eval_launch's.
extern "C" int tq_crown_eval(const void* const* p, int Nn, int nx, int nu, int blocks,
                             int threads, void* stream) {
  return tq::launch_crown_eval_lanes<float>(p, Nn, nx, nu, blocks, threads, stream);
}

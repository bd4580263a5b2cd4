// Chain stage evaluation at a dual point, f32, one thread per chain.
//
// Replaces the Pallas kernel chain_eval of treeqp_tpu/ops/chain_kernels.py:
// the clipping stage solve of every chain node, the active-set masked
// inverses, the chain-edge dual residual rows (row j = 0 without the
// A_0 z_crown term), the crown-root contributions cqr = [A_0 B_0]' lam_0 and
// the per-chain dual-value partial sums, in one launch. The kernel is
// tq::chain_eval_kernel<float> (tq_eval.cuh), whose body newton_iter.cu runs
// too, a thread a node, as chain_eval_df.cu runs it in double.
//
// What bounds it on the card: latency and occupancy. Each thread walks its
// chain's L nodes serially (~L (4 nx nz + 10 nz) flops, ~3k at the
// quadcopter shapes) and reads ~L nx nz + 12 L n floats of loop-invariant
// data; with S = 256 chains the launch fills 2 blocks of 128 threads. The
// chains are independent, so the grid grows with S (many blocks, no
// cross-chain traffic).

#include "tq_eval.cuh"

// p: CHAIN_DATA_KEYS (12), lam, then x, u, qt, rt, xU, uU, res, f, err, cqr.
extern "C" int tq_chain_eval(const void* const* p, int S, int L, int nx, int nu,
                             void* stream) {
  return tq::launch_chain_eval<float>(p, S, L, nx, nu, stream);
}

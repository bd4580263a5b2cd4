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
// evaluation, without the crown or a cluster; tq::chain_eval_nodes<double>
// in tq_eval.cuh, which chain_eval.cu runs in float):
// - ``chains`` whole chains a block (chain_kernels.chain_node_launch), a
//   thread a node;
// - with ``staged``, the block's [A B] blocks and lam rows are copied to
//   shared memory first (one contiguous tile each, 16-byte cp.async copies
//   on neighbouring addresses); each node's block is then read by its own
//   thread (the residual row) and its parent's (the kid term). Shapes whose
//   tile does not fit read global memory;
// - 1. every node's clip (tq::chain_clip_at), its dual-value partials
//   parked in shared memory, and each chain's cqr by its node j = 0;
//   2. after a barrier, every node's residual row, which needs x_{j-1},
//   u_{j-1} (tq::chain_res_at); 3. each chain's partials summed in j order
//   by one thread, as the one-thread-a-chain walk summed them.
// Every element meets the operations of that walk in the same order, so
// every output equals that kernel's bit for bit.
// No tensor cores: FP64 mma fuses each product into its sum, and the active
// sets rest on the twin's separately rounded bits.

#include "tq_eval.cuh"

// p: CHAIN_DATA_KEYS (12, f64), lam, then x, u, qt, rt, xU, uU, res, f,
// err (null), cqr; all f64. chains: whole chains a block; staged: 1 to copy
// the block's [A B] and lam to shared memory first (both from
// chain_kernels.chain_node_launch).
extern "C" int tq_chain_eval_df(const void* const* p, int S, int L, int nx, int nu,
                                int chains, int staged, void* stream) {
  return tq::launch_chain_eval_nodes<double>(p, S, L, nx, nu, chains, staged, stream);
}

// Chain stage evaluation at a dual point, f32, a thread a chain node.
//
// Replaces the Pallas kernel chain_eval of treeqp_tpu/ops/chain_kernels.py:
// the clipping stage solve of every chain node, the active-set masked
// inverses, the chain-edge dual residual rows (row j = 0 without the
// A_0 z_crown term), the crown-root contributions cqr = [A_0 B_0]' lam_0 and
// the per-chain dual-value partial sums, in one launch. The coarse phase
// runs it where it cannot run the fused newton_iter (two-norm termination,
// refinement steps, the all-f32 loop).
//
// What bounds it on the card: latency. A launch moves ~0.63 MB at S = 256
// chains of L = 16 nodes (nx = 6, nu = 4), ~0.2 us at the card's memory
// rate, and each node's work is a chain of ~60 dependent FP32 operations.
// The kernel it replaces ran a thread a chain (2 blocks of 128 threads on 2
// of 132 SMs at S = 256), each thread walking its 16 nodes one after
// another with its lanes' loads 3.8 KB apart. Design: chain_eval_df.cu's,
// the same kernel in float (tq::chain_eval_nodes<float>,
// tq_eval.cuh): ``chains`` whole chains a block, a thread a node; with
// ``staged`` the block's [A B] blocks and lam rows copied to shared memory
// first by 16-byte cp.async copies; every node's clip (tq::chain_clip_at),
// then after a barrier its residual row (tq::chain_res_at), then each
// chain's partials summed in j order by one thread. Every element meets
// the operations of the one-thread-a-chain walk in the same order, each
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: no FFMA), so every
// output equals that kernel's bit for bit. No tensor cores: a node is a
// clip and dots of at most nz terms, and mma would fuse products into
// sums where the active sets rest on separately rounded bits.

#include "tq_eval.cuh"

// p: CHAIN_DATA_KEYS (12), lam, then x, u, qt, rt, xU, uU, res, f, err
// (null), cqr; all f32. chains: whole chains a block; staged: 1 to copy the
// block's [A B] and lam to shared memory first (both from
// chain_kernels.chain_node_launch).
extern "C" int tq_chain_eval(const void* const* p, int S, int L, int nx, int nu, int chains,
                             int staged, void* stream) {
  return tq::launch_chain_eval_nodes<float>(p, S, L, nx, nu, chains, staged, stream);
}

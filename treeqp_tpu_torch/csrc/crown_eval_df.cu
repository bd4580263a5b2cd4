// Crown stage evaluation at a dual point of the high-precision phase, in
// native f64, in one launch of one thread block or one thread-block
// cluster, a group of lanes a crown node.
//
// Replaces the Pallas kernel crown_eval_df of
// treeqp_tpu/ops/df_eval_kernels.py. The TPU kernel carried (hi, lo) f32
// pairs and did the kid sum with one one-hot [NPc, NPc] matmul per kid slot
// (exact copies, then df adds) and the parent gather with another, which
// capped the crown by VMEM. Here the values are doubles and the kid sum and
// parent gather read the kid lists and par (crown_kernels.eval_sched), so
// the crown has no node cap. Three phases depend on each other across
// nodes:
//   A. atb_n = [A_n B_n]' lam_n
//   B. kid sum of atb (slot order) + extra, clip, qtilde/rtilde, f_n
//   C. res_n = ([A_n B_n] z_par(n) + b_n - x_n) * nonroot
//
// What bounds it on the card: latency. A launch moves ~0.5 MB at the bench
// path's 341-node crown (nx = 6, nu = 4), ~0.15 us at the card's memory
// rate; each phase is a chain of dependent FP64 operations a node (nx
// products, a kid sum, a fold of nz terms) between two barriers. It
// replaced a one-block kernel, a thread a node on one SM, each thread
// reading its own 480-byte [A B] block twice, so no warp's loads were
// coalesced. Design (tq::crown_eval_lanes_kernel<double, G>, tq_eval.cuh;
// crown_eval.cu runs it in float, crown_apply_df.cu its phases A and C):
// - a group of G = tq::lanes(nz) lanes a node (8 for nz <= 8, 16 beyond;
//   a template parameter), lane c its column c of phase A, its element c
//   of phase B and its row c of phase C (c, c + G, ... where nz > G), so
//   that a group's loads of a block's row or column are coalesced;
// - the team is one cluster of ``blocks`` blocks (the cluster's barrier,
//   release / acquire, in two halves) or one block (__syncthreads), as
//   crown_kernels._crown_eval_launch chooses; one kernel serves both
//   (tq::SizedTeam, tq::launch_team);
// - a group keeps its nodes in all three phases and reads their [A B]
//   blocks from global memory, the group's lanes a row's or a column's
//   consecutive entries;
// - atb and x, u cross blocks through global memory behind the barrier
//   (plain loads); each group's first node's loop-invariant operands load
//   between the barrier's two halves.
// What holds it back: the three phases' dependent FP64 operations and the
// two cluster barriers, each with its release's memory fence.
// Every operation is rounded on its own (__dmul_rn, __dadd_rn, __dsub_rn:
// no DFMA) in the one-thread body's order, the phase-B fold included, so
// the outputs and active sets equal the plain twin's, and the old
// kernel's, bit for bit. No tensor cores: each step is a per-node clip or
// a dot of at most nz terms, and FP64 mma fuses each product into its sum
// where the active sets rest on separately rounded bits.

#include "tq_eval.cuh"

// p: CROWN_DATA_KEYS (15, f64), par, kid_ptr, kid_idx, lam, extra, atb
// (scratch), then x, u, qt, rt, xU, uU, res, f, err (null: not written);
// all f64 but the indices. blocks: one cluster of 2 .. 16 blocks, or one
// block; threads a block (a multiple of 32, at most 1024; both from
// crown_kernels._crown_eval_launch).
extern "C" int tq_crown_eval_df(const void* const* p, int Nn, int nx, int nu, int blocks,
                                int threads, void* stream) {
  return tq::launch_crown_eval_lanes<double>(p, Nn, nx, nu, blocks, threads, stream);
}

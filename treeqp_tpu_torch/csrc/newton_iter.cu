// One whole f32 Newton iteration of the coarse phase, in one launch of one
// thread-block cluster.
//
// Replaces the Pallas kernel newton_iter of treeqp_tpu/ops/iter_kernel.py.
// mode "iter" (eval_only = 0):
//   1. equilibrated right-hand sides: rv = res_cr * s_node in the crown
//      group layout (each (group, slot) reads its kid node, 0 on empty
//      slots), rch = res_ch * sc
//   2. the Newton-system solve with the stored factors, tq_system.cuh's
//      body (system_solve.cu runs it alone): the chains' backward sweeps
//      (y_j parked in dch_s, each chain's CUs_0 y_0 taken from its crown
//      slot of rv), the crown's level-synchronous solve, the chains'
//      forward sweeps from their crown slot of dg
//   3. direction dcr = dg at each node's (group, slot) * s_node (0 at the
//      root), dch = dch_s * sc; the tau = 1 trial point lam2 = lam + d; the
//      per-node / per-chain partials of the directional derivative
//      dot = -res' d
//   4. the evaluation at lam2 (tq_eval.cuh): the chains' clips, the crown's
//      [A B]' lam2, the chains' residual rows and the crown's clips (whose
//      kid sums take each chain's [A_0 B_0]' lam2_0 at its root node), the
//      crown's residuals and each chain's row j = 0 completed with
//      A_0 z_crown at its root, with the dual-value and error partials.
// mode "eval" (eval_only = 1): lam2 = lam is given, d = 0, and only step 4
// runs; the factors and the residuals are not read (null pointers).
// The TPU kernel moved values between the scenario, crown-node and
// crown-group layouts with one-hot matmuls (J, N2G, R); every one of those
// moves has one source per element, so the indexed reads and writes here
// give the same values.
//
// What bounds it on the card: latency. The work is small (a launch moves
// ~1.3 MB at the quadcopter headline, S = 256 chains of L = 16, n = 6, and
// 341 crown nodes: ~0.4 us at the card's memory rate) and sits on a chain
// of dependent phases. The one-block kernel this replaces ran all of it on
// one SM (2.1 ms there): the chain sweeps one thread per chain with the
// blocks in local memory, the evaluation one thread per chain walking its
// 16 nodes. Design:
// - One cluster of kCluster = 8 blocks (the portable maximum) of kThreads
//   threads, on 8 SMs; the phases are separated by the cluster's barrier
//   (release / acquire at cluster scope), and the data that crosses blocks
//   goes through global memory, which stays in L2.
// - The chain sweeps of step 2 are tq_lanes.cuh's sweep_bwd / sweep_fwd,
//   the steps of chain_sweeps.cu: 8 or 16 lanes a chain, lane i owning row
//   i, the blocks Ls_j, CUs_j streamed through a cp.async ring. A block
//   gives as many warps to the sweeps as its shared memory holds rings
//   (tq_system.cuh's kSysRingBytes); the groups stride over the chains.
//   The forward sweep writes dch and lam2_ch as it goes.
// - The crown's solve (step 2) runs on the cluster's warps, the cluster's
//   barrier between levels: with G = K n <= 32 rows a group (the
//   headline's 24) a warp takes a group, lane i row i, its triangular
//   solves G rounds of a division and a shuffle as in the chain sweeps (the
//   per-thread bodies of tq_crown.cuh, which wider groups keep in block 0,
//   walked each group's rows from global memory in one thread: 56% of the
//   launch at the headline). Its direction (step 3) follows a thread a
//   node.
// - The evaluation runs a thread a node: every chain node's clip depends
//   only on lam2_j and lam2_{j+1}; its residual row, which needs x_{j-1}
//   and u_{j-1}, follows after a barrier. Each chain's dual-value, error
//   and directional-derivative partials are then summed in j order by one
//   thread per chain, so the partials keep the one-thread-per-chain order.
// Every element meets the operations of the one-block kernel in the same
// order (the evaluations round each product and sum on its own, the sweeps
// are bit for bit the thread-per-chain bodies), so every output equals that
// kernel's bit for bit, and the active sets, the Armijo decisions and the
// iteration counts stay as they were.
// No tensor cores: every step is a dependent n <= 16 triangular solve or a
// per-node clip; wgmma needs 64-row tiles, and a chain has no batch
// dimension of its own.

#include <cooperative_groups.h>

#include <cstdint>

#include "tq_eval.cuh"
#include "tq_system.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = tq::kSysCluster;
constexpr int kThreads = tq::kSysThreads;

struct IterArgs {
  tq::ChainData<float> ch;
  tq::CrownData<float> cr;
  tq::SystemArgs sys;  // step 2's factors, schedule and crown vectors rv, ycr, dg
  const float *s_node, *sc;
  const int *rid, *kidsP, *gon, *son;
  const float *lam_cr, *lam_ch, *res_cr, *res_ch;
  float *dcr, *dch, *lam2_cr, *lam2_ch;
  tq::EvalOut<float> cho, cro;
  float *dots, *dotc;
  float *rch_s, *dch_s, *extra, *atb;
  float *part;  // [4, S, L]: each chain node's sx, su, max |res|, res' d
  unsigned long long* stamps;  // null, or kCluster kStamps timer reads (profiling)
  int NpG, eval_only;
};

// With stamps, thread 0 of each block reads the global timer (ns) at the
// start (slot 0), before and after each cluster barrier k (slots 1 + 2k,
// 2 + 2k; k = 0 .. 6 in the order of the iter mode's barriers, 6 the extra
// one that ends a stamped launch) and, in block 0, after the crown's
// backward levels, its root and its forward levels (slots 15, 16, 17):
// kStamps slots a block. Outputs are the same with or without.
constexpr int kStamps = 20;

__device__ __forceinline__ void stamp(const IterArgs& a, int b, int k) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[b * kStamps + k] = t;
  }
}

__device__ __forceinline__ void barrier(cg::cluster_group& cluster, const IterArgs& a, int b,
                                        int k) {
  stamp(a, b, 1 + 2 * k);
  cluster.sync();
  stamp(a, b, 2 + 2 * k);
}

template <int GL>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    newton_iter_kernel(const IterArgs a) {
  using tq::add;
  using tq::mul;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const tq::ChainData<float>& ch = a.ch;
  const tq::CrownData<float>& cr = a.cr;
  const int S = ch.S, L = ch.L, n = ch.nx, nu = ch.nu, nz = n + nu;
  const int Nn = cr.Nn, K = a.sys.K, G = K * n;
  const int b = (int)cluster.block_rank();
  // the cluster's threads: gt block by block, for the loops over chain
  // nodes and elements (neighbouring threads on neighbouring nodes), and ix
  // interleaved over the blocks, for the loops over fewer items than threads
  // (chains, crown nodes), so that those spread over all eight
  const int gt = b * blockDim.x + threadIdx.x, ix = threadIdx.x * kCluster + b;
  const int gn = kCluster * blockDim.x;
  const size_t SL = (size_t)S * L;
  float* sxn = a.part;
  float* sun = a.part + SL;
  float* errn = a.part + 2 * SL;
  float* dotn = a.part + 3 * SL;

  stamp(a, b, 0);
  for (int e = ix; e < Nn * nz; e += gn) a.extra[e] = 0.f;
  if (a.eval_only) {
    for (int e = ix; e < Nn * n; e += gn) {
      a.lam2_cr[e] = a.lam_cr[e];
      a.dcr[e] = 0.f;
    }
    for (size_t e = gt; e < SL * n; e += gn) {
      a.lam2_ch[e] = a.lam_ch[e];
      a.dch[e] = 0.f;
    }
    for (int m = ix; m < Nn; m += gn) a.dotc[m] = 0.f;
  } else {
    // 1. equilibrated right-hand sides
    for (int e = ix; e < a.NpG * G; e += gn) {
      const int g = e / G, k = (e % G) / n, i = e % n;
      const int kid = a.kidsP[g * K + k];
      a.sys.rv[e] = kid >= 0 ? mul(a.res_cr[kid * n + i], a.s_node[kid * n + i]) : 0.f;
      a.sys.dg[e] = 0.f;
    }
    for (size_t e = gt; e < SL * n; e += gn) a.rch_s[e] = mul(a.res_ch[e], a.sc[e]);
    barrier(cluster, a, b, 0);

    // 2a. chain backward sweeps, y_j into dch_s, CUs_0 y_0 out of the crown slot
    tq::chain_bwd<GL>(a.sys, smem, b, a.rch_s, [&](int s, bool live, int i, int j, float y) {
      if (live && i < n) a.dch_s[((size_t)s * L + j) * n + i] = y;
    });
    barrier(cluster, a, b, 1);

    // 2b. the crown (on the cluster's warps, or in block 0 where a group
    // is wider than a warp), and 3. its direction, trial point and partials
    tq::crown(a.sys, [&](int k) { stamp(a, b, k); });
    for (int m = ix; m < Nn; m += gn) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) {
        const int e = m * n + i;
        const float dn = m == 0 ? 0.f : a.sys.dg[(size_t)a.gon[m] * G + a.son[m] * n + i];
        const float d = mul(dn, a.s_node[e]);
        a.dcr[e] = d;
        a.lam2_cr[e] = add(a.lam_cr[e], d);
        acc = add(acc, mul(a.res_cr[e], d));
      }
      a.dotc[m] = -acc;
    }
    barrier(cluster, a, b, 2);

    // 2c. chain forward sweeps from the crown slot's direction, and 3. the
    // chains' direction and trial point
    float scv = 0.f, lmv = 0.f;  // step j's scale and dual, loaded as it starts
    tq::chain_fwd<GL>(
        a.sys, smem, b, a.dch_s,
        [&](int s, bool live, int i, int j) {
          if (live && i < n) {
            const size_t e = ((size_t)s * L + j) * n + i;
            scv = a.sc[e];
            lmv = a.lam_ch[e];
          }
        },
        [&](int s, bool live, int i, int j, float dl) {
          if (live && i < n) {
            const size_t e = ((size_t)s * L + j) * n + i;
            const float d = mul(dl, scv);
            a.dch[e] = d;
            a.lam2_ch[e] = add(lmv, d);
          }
        });
  }
  barrier(cluster, a, b, 3);

  // 4. evaluation at the trial point. The chains' clips, their roots'
  // [A_0 B_0]' lam2_0 into the crown's extra term, the crown's [A B]' lam2,
  // and each chain node's part of res' d.
  for (size_t e = gt; e < SL; e += gn) {
    const int s = (int)(e / L), j = (int)(e % L);
    float sx, su;
    tq::chain_clip_node(ch, a.lam2_ch, a.cho, s, j, sx, su);
    sxn[e] = sx;
    sun[e] = su;
    if (j == 0) tq::chain_root_cqr(ch, a.lam2_ch, a.extra + (size_t)a.rid[s] * nz, s);
    if (!a.eval_only) {
      float sj = 0.f;
      for (int i = 0; i < n; ++i) sj = add(sj, mul(a.res_ch[e * n + i], a.dch[e * n + i]));
      dotn[e] = sj;
    }
  }
  for (int m = ix; m < Nn; m += gn) tq::crown_atb(cr, a.lam2_cr, a.atb, m);
  barrier(cluster, a, b, 4);
  // the chains' residual rows, the crown's clips
  for (size_t e = gt; e < SL; e += gn)
    errn[e] = tq::chain_res_node(ch, a.cho, (int)(e / L), (int)(e % L));
  for (int m = ix; m < Nn; m += gn) tq::crown_clip(cr, a.lam2_cr, a.atb, a.extra, a.cro, m);
  barrier(cluster, a, b, 5);
  // the crown's residuals; per chain, row j = 0 + [A_0 B_0] z_crown at the
  // chain's root, and the partials summed in j order
  for (int m = ix; m < Nn; m += gn) tq::crown_res(cr, a.cro, m);
  for (int s = ix; s < S; s += gn) {
    const int root = a.rid[s];
    const float* AB0 = ch.AB + (size_t)s * L * n * nz;
    const float* xr = a.cro.x + (size_t)root * n;
    const float* ur = a.cro.u + (size_t)root * nu;
    float err = 0.f, facc = 0.f, dacc = 0.f;
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const size_t e = (size_t)s * L + j;
      err = fmaxf(err, errn[e]);
      facc = add(add(facc, sxn[e]), sun[e]);
      if (!a.eval_only) dacc = add(dacc, dotn[e]);
    }
    float acc[tq::kRows], unused[tq::kRows];
    tq::row_dots<float, false>(AB0, xr, ur, n, nu, nz, acc, unused);
#pragma unroll
    for (int i = 0; i < tq::kRows; ++i) {
      if (i < n) {
        float* r = a.cho.res + (size_t)s * L * n + i;
        *r = add(*r, acc[i]);
        err = fmaxf(err, fabsf(*r));
      }
    }
    a.cho.f[s] = facc;
    a.cho.err[s] = err;
    a.dots[s] = a.eval_only ? 0.f : -dacc;
  }
  if (a.stamps != nullptr) barrier(cluster, a, b, 6);
}

template <int GL>
int launch(IterArgs& a, cudaStream_t st) {
  size_t bytes;
  tq::ring_shape(a.ch.nx, GL, &a.sys.groups, &bytes);
  static size_t opted = 0;  // the dynamic shared memory this kernel may take
  if (bytes > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        newton_iter_kernel<GL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted = bytes;
  }
  newton_iter_kernel<GL><<<kCluster, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: CHAIN_DATA_KEYS (12), CROWN_DATA_KEYS (15), par, kid_ptr, kid_idx,
// Ls, CUs, CholW, CholUt, s_node, sc, lev_ptr, lev_child, lev_parent,
// lev_slot, g_of, slot, rid, kidsP, group_of_node, slot_of_node, lam_cr,
// lam_ch, res_cr, res_ch, dcr, dch, lam2_cr, lam2_ch, chain x, u, qt, rt,
// xU, uU, res, f, err, crown x, u, qt, rt, xU, uU, res, f, err, dots, dotc,
// then the scratch rv, ycr, dg, rch_s, dch_s, extra, atb, part, and
// stamps (null, or kCluster kStamps u64).
// dims: S, L, nx, nu, Nn, NpG, K, n_lev, eval_only.
extern "C" int tq_newton_iter(const void* const* p, const int* dims, void* stream) {
  const int S = dims[0], L = dims[1], nx = dims[2], nu = dims[3], Nn = dims[4];
  tq::PtrCursor c{p};
  IterArgs a;
  a.ch = tq::chain_data<float>(c, S, L, nx, nu);
  a.cr = tq::crown_data<float>(c, Nn, nx, nu);
  tq::SystemArgs& y = a.sys;
  y.Ls = c.in(); y.CUs = c.in(); y.CholW = c.in(); y.CholUt = c.in();
  a.s_node = c.in(); a.sc = c.in();
  y.lev_ptr = c.idx(); y.lev_child = c.idx(); y.lev_parent = c.idx();
  y.lev_slot = c.idx(); y.g_of = c.idx(); y.slot = c.idx(); a.rid = c.idx();
  a.kidsP = c.idx(); a.gon = c.idx(); a.son = c.idx();
  a.lam_cr = c.in(); a.lam_ch = c.in(); a.res_cr = c.in(); a.res_ch = c.in();
  a.dcr = c.out(); a.dch = c.out(); a.lam2_cr = c.out(); a.lam2_ch = c.out();
  a.cho = tq::eval_out<float>(c);
  a.cro = tq::eval_out<float>(c);
  a.dots = c.out(); a.dotc = c.out();
  y.rv = c.out(); y.ycr = c.out(); y.dg = c.out(); a.rch_s = c.out();
  a.dch_s = c.out(); a.extra = c.out(); a.atb = c.out(); a.part = c.out();
  a.stamps = (unsigned long long*)c.out();
  a.NpG = dims[5]; y.K = dims[6]; y.n_lev = dims[7]; a.eval_only = dims[8];
  y.S = S; y.L = L; y.n = nx;
  y.vec16 = nx % 2 == 0 && (((uintptr_t)y.Ls | (uintptr_t)y.CUs) & 15) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return nx <= 8 ? launch<8>(a, st) : launch<16>(a, st);
}

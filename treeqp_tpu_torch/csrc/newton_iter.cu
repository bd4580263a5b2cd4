// One whole f32 Newton iteration of the coarse phase, in one launch of one
// thread block.
//
// Replaces the Pallas kernel newton_iter of treeqp_tpu/ops/iter_kernel.py.
// mode "iter" (eval_only = 0):
//   1. equilibrated right-hand sides: rv = res_cr * s_node in the crown
//      group layout (each (group, slot) reads its kid node, 0 on empty
//      slots), rch = res_ch * sc
//   2. the Newton-system solve with the stored factors
//      (tq::system_solve_core, the body of system_solve.cu)
//   3. direction dcr = dg at each node's (group, slot) * s_node (0 at the
//      root), dch = dch_s * sc; the tau = 1 trial point lam2 = lam + d; the
//      per-node / per-chain partials of the directional derivative
//      dot = -res' d
//   4. the evaluation at lam2: chain_eval_one per chain (which writes each
//      chain's root contribution straight into the crown's extra term at
//      its root node), then crown_atb / crown_clip / crown_res
//      (tq_eval.cuh), and the chain residual row j = 0 completed with
//      A_0 z_crown at the chain's root, with the error partials.
// mode "eval" (eval_only = 1): lam2 = lam is given, d = 0, and only step 4
// runs; the factors and the residuals are not read (null pointers).
// The TPU kernel moved values between the scenario, crown-node and
// crown-group layouts with one-hot matmuls (J, N2G, R); every one of those
// moves has one source per element, so the indexed reads and writes here
// give the same values.
//
// What bounds it on the card: latency. It is system_solve (~0.85 ms a
// launch at the headline shapes) plus one chain and one crown evaluation,
// all on one SM, with a barrier between dependent phases. What it saves
// is the host: one launch and one host read of three partial sums per
// common-path iteration instead of ~20 launches and a read per decision.

#include "tq_eval.cuh"
#include "tq_system.cuh"

namespace {

struct IterArgs {
  tq::ChainData<float> ch;
  tq::CrownData<float> cr;
  const float *Ls, *CUs, *CholW, *CholUt, *s_node, *sc;
  const int *lev_ptr, *lev_child, *lev_parent, *lev_slot, *g_of, *slot, *rid,
      *kidsP, *gon, *son;
  const float *lam_cr, *lam_ch, *res_cr, *res_ch;
  float *dcr, *dch, *lam2_cr, *lam2_ch;
  tq::EvalOut<float> cho, cro;
  float *dots, *dotc;
  float *rv, *ycr, *dg, *rch_s, *dch_s, *extra, *atb;
  int NpG, K, n_lev, eval_only;
};

__global__ void __launch_bounds__(1024) newton_iter_kernel(const IterArgs a) {
  using tq::add;
  using tq::mul;
  const tq::ChainData<float>& ch = a.ch;
  const tq::CrownData<float>& cr = a.cr;
  const int S = ch.S, L = ch.L, n = ch.nx, nu = ch.nu, nz = n + nu;
  const int Nn = cr.Nn, K = a.K, G = K * n;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < Nn * nz; e += nt) a.extra[e] = 0.f;
  if (a.eval_only) {
    for (int e = tid; e < Nn * n; e += nt) {
      a.lam2_cr[e] = a.lam_cr[e];
      a.dcr[e] = 0.f;
    }
    for (int e = tid; e < S * L * n; e += nt) {
      a.lam2_ch[e] = a.lam_ch[e];
      a.dch[e] = 0.f;
    }
    for (int m = tid; m < Nn; m += nt) a.dotc[m] = 0.f;
    for (int s = tid; s < S; s += nt) a.dots[s] = 0.f;
    __syncthreads();
  } else {
    // 1. equilibrated right-hand sides
    for (int e = tid; e < a.NpG * G; e += nt) {
      const int g = e / G, k = (e % G) / n, i = e % n;
      const int kid = a.kidsP[g * K + k];
      a.rv[e] = kid >= 0 ? mul(a.res_cr[kid * n + i], a.s_node[kid * n + i]) : 0.f;
      a.dg[e] = 0.f;
    }
    for (int e = tid; e < S * L * n; e += nt) a.rch_s[e] = mul(a.res_ch[e], a.sc[e]);
    __syncthreads();
    // 2. Newton-system solve (ends with a barrier)
    tq::system_solve_core(a.Ls, a.CUs, a.CholW, a.CholUt, a.rch_s, a.lev_ptr,
                          a.lev_child, a.lev_parent, a.lev_slot, a.g_of, a.slot,
                          a.rv, a.ycr, a.dg, a.dch_s, S, L, n, K, a.n_lev);
    // 3. direction, trial point, directional-derivative partials
    for (int m = tid; m < Nn; m += nt) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) {
        const int e = m * n + i;
        const float dn = m == 0 ? 0.f : a.dg[(size_t)a.gon[m] * G + a.son[m] * n + i];
        const float d = mul(dn, a.s_node[e]);
        a.dcr[e] = d;
        a.lam2_cr[e] = add(a.lam_cr[e], d);
        acc = add(acc, mul(a.res_cr[e], d));
      }
      a.dotc[m] = -acc;
    }
    for (int s = tid; s < S; s += nt) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) {
        float sj = 0.f;
        for (int i = 0; i < n; ++i) {
          const size_t e = ((size_t)s * L + j) * n + i;
          const float d = mul(a.dch_s[e], a.sc[e]);
          a.dch[e] = d;
          a.lam2_ch[e] = add(a.lam_ch[e], d);
          sj = add(sj, mul(a.res_ch[e], d));
        }
        acc = add(acc, sj);
      }
      a.dots[s] = -acc;
    }
    __syncthreads();
  }

  // 4. evaluation at the trial point
  for (int s = tid; s < S; s += nt)
    tq::chain_eval_one(ch, a.lam2_ch, a.cho, a.extra + (size_t)a.rid[s] * nz, s);
  for (int m = tid; m < Nn; m += nt) tq::crown_atb(cr, a.lam2_cr, a.atb, m);
  __syncthreads();
  for (int m = tid; m < Nn; m += nt) tq::crown_clip(cr, a.lam2_cr, a.atb, a.extra, a.cro, m);
  __syncthreads();
  for (int m = tid; m < Nn; m += nt) tq::crown_res(cr, a.cro, m);
  // chain residual row j = 0: + [A_0 B_0] z_crown at the chain's root
  for (int s = tid; s < S; s += nt) {
    const int root = a.rid[s];
    const float* AB0 = ch.AB + (size_t)s * L * n * nz;
    const float* xr = a.cro.x + (size_t)root * n;
    const float* ur = a.cro.u + (size_t)root * nu;
    float err = a.cho.err[s];
    for (int i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int c = 0; c < n; ++c) acc = add(acc, mul(AB0[i * nz + c], xr[c]));
      for (int c = 0; c < nu; ++c) acc = add(acc, mul(AB0[i * nz + n + c], ur[c]));
      float* r = a.cho.res + (size_t)s * L * n + i;
      *r = add(*r, acc);
      err = fmaxf(err, fabsf(*r));
    }
    a.cho.err[s] = err;
  }
}

}  // namespace

// p: CHAIN_DATA_KEYS (12), CROWN_DATA_KEYS (15), par, kid_ptr, kid_idx,
// Ls, CUs, CholW, CholUt, s_node, sc, lev_ptr, lev_child, lev_parent,
// lev_slot, g_of, slot, rid, kidsP, group_of_node, slot_of_node, lam_cr,
// lam_ch, res_cr, res_ch, dcr, dch, lam2_cr, lam2_ch, chain x, u, qt, rt,
// xU, uU, res, f, err, crown x, u, qt, rt, xU, uU, res, f, err, dots, dotc,
// then the scratch rv, ycr, dg, rch_s, dch_s, extra, atb.
// dims: S, L, nx, nu, Nn, NpG, K, n_lev, eval_only, threads.
extern "C" int tq_newton_iter(const void* const* p, const int* dims, void* stream) {
  const int S = dims[0], L = dims[1], nx = dims[2], nu = dims[3], Nn = dims[4];
  tq::PtrCursor c{p};
  IterArgs a;
  a.ch = tq::chain_data<float>(c, S, L, nx, nu);
  a.cr = tq::crown_data<float>(c, Nn, nx, nu);
  a.Ls = c.in(); a.CUs = c.in(); a.CholW = c.in(); a.CholUt = c.in();
  a.s_node = c.in(); a.sc = c.in();
  a.lev_ptr = c.idx(); a.lev_child = c.idx(); a.lev_parent = c.idx();
  a.lev_slot = c.idx(); a.g_of = c.idx(); a.slot = c.idx(); a.rid = c.idx();
  a.kidsP = c.idx(); a.gon = c.idx(); a.son = c.idx();
  a.lam_cr = c.in(); a.lam_ch = c.in(); a.res_cr = c.in(); a.res_ch = c.in();
  a.dcr = c.out(); a.dch = c.out(); a.lam2_cr = c.out(); a.lam2_ch = c.out();
  a.cho = tq::eval_out<float>(c);
  a.cro = tq::eval_out<float>(c);
  a.dots = c.out(); a.dotc = c.out();
  a.rv = c.out(); a.ycr = c.out(); a.dg = c.out(); a.rch_s = c.out();
  a.dch_s = c.out(); a.extra = c.out(); a.atb = c.out();
  a.NpG = dims[5]; a.K = dims[6]; a.n_lev = dims[7]; a.eval_only = dims[8];
  newton_iter_kernel<<<1, dims[9], 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

"""The high-precision final phase of the multistage dual-Newton solve, in
native f64.

Port of ``treeqp_tpu/solvers/ms_df64.py``. The two-phase schedule
(``tdunes_multistage.tdunes_ms_solve`` with ``f32_phase_tol > 0``) runs
coarse f32 Newton iterations, then this short high-precision phase to the
final tolerance. The JAX package does its arithmetic in double-float (two
f32 words per value) because TPU Pallas has no f64; the H100 has native
FP64, so every high-precision quantity here (stage solutions, dual
gradients, dual values, the exact Hessian action for iterative refinement
and the dual iterate itself) is an f64 tensor, while the factorization and
the solve stay the f32 kernels of the coarse phase. The semantics are the
JAX loop's:

* evaluation: ``chain_eval_df``, the chains' root contributions written at
  their crown root nodes (one writer per root), then ``crown_eval_df``; the
  chain residual row 0 is completed with A_0 z_crown in plain PyTorch;
* dual value and directional derivative: ``df_reduce_flat`` (a fixed-order
  sum) over the kernels' partials and over res * d;
* direction: the f32 solve of the f32-rounded residual, refined against
  res - M d with M d from ``chain_apply_df`` + ``crown_apply_df`` in f64,
  the direction accumulated in f32;
* Armijo on f = -g with the slack 2^-38 |f0| and candidate steps in f32,
  the descent test dot < 1e-10, the full-step restart and NOT_DESCENT;
* factorization: ``_ms_factorize(lanes=True)`` on the masked inverses
  rounded to f32, reused while the active set is unchanged, and at the
  phase start reused from the coarse phase (the handover) when its
  active-set pattern equals this phase's first.

That is the kernel route, ``chain_backend="pallas"`` (the JAX package's
``fused_eval``, which there also needs a TPU). With ``chain_backend="xla"``
the evaluation, the Hessian action and the sums are the multistage loop's
plain f64 PyTorch, and the factorize and the solve are its plain route;
the Armijo rule, the f32 steps and the factor reuse stay as above. The
factor and solve follow ``tdunes_multistage``'s routes in both.

The error is taken on the f64 residuals; the JAX phase takes it on the hi
words, which differ from them below 2^-24 relative.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _dense
from treeqp_tpu_torch.ops import df_eval_kernels as dek
from treeqp_tpu_torch.ops.df_reduce import df_reduce_flat
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm
from treeqp_tpu_torch.solvers.tdunes import (
    TdunesOpts, TDUNES_OPTIMAL, TDUNES_NOT_DESCENT)

__all__ = ["ms_newton_loop_df", "make_dd", "df_stage_solve", "df_residuals",
           "df_dual_value", "df_apply_M"]

# Armijo slack relative to |f0|: the JAX phase's, set by its double-float
# dual value's noise (treeqp_tpu/solvers/ms_df64.py:567-576)
ARMIJO_SLACK = 2.0 ** -38


def make_dd(ms: tm.MultistageQP, prep_cr) -> dict:
    """The phase's loop-invariant f64 data: the chain and crown operands of
    the kernels and the chain roots' crown node ids."""
    return dict(
        ch=dek.chain_eval_df_data(ms.A, ms.B, ms.q, ms.r, ms.Qd, ms.Rd, ms.xmin,
                                  ms.xmax, ms.umin, ms.umax, ms.b),
        cr=dek.crown_eval_df_data(ms.crown, prep_cr, *td._masks(ms.crown, prep_cr)),
        rid=torch.as_tensor(ms.meta.root_ids, dtype=torch.long, device=ms.q.device))


def _root_extra(dd, cqr):
    """The chains' root contributions [S, nz] at their crown root nodes,
    [Nn, nz] (zero elsewhere)."""
    extra = torch.zeros_like(dd["cr"]["ABt"][:, 0])
    extra[dd["rid"]] = cqr
    return extra


def _with_row0(dd, res_part, x_cr, u_cr):
    """Chain residual rows with row 0 completed by A_0 [x; u] of each
    chain's crown root."""
    rid = dd["rid"]
    res = res_part.clone()
    res[:, 0] = res[:, 0] + _dense.mv(dd["ch"]["ABt"][:, 0],
                                      torch.cat([x_cr[rid], u_cr[rid]], dim=1))
    return res


def df_stage_solve(dd, prep_cr, lam_cr, lam_ch):
    """Chain and crown clipping stage solves at (lam_cr, lam_ch): the
    outputs of ``chain_eval_df`` and ``crown_eval_df`` as (cr, ch)."""
    ch = dek.chain_eval_df(dd["ch"], lam_ch)
    cr = dek.crown_eval_df(dd["cr"], lam_cr, _root_extra(dd, ch["cqr"]), prep_cr)
    return cr, ch


def df_residuals(dd, cr, ch):
    """Dual gradients (res_cr [Nn, nxm], res_ch [S, L, nx])."""
    return cr["res"], _with_row0(dd, ch["res_part"], cr["x"], cr["u"])


def df_dual_value(cr, ch):
    """f(lambda) = -g(lambda) from the kernels' partials (0-dim f64)."""
    return df_reduce_flat(torch.cat([cr["fcr"], ch["fch"]]))


def df_apply_M(dd, prep_cr, cr, ch, dcr, dch):
    """Exact dual-Hessian action M d (f64) for the f32 direction (dcr,
    dch) at the active set of (cr, ch)."""
    cha = dek.chain_apply_df(dd["ch"], ch["qt"], ch["rt"], dch)
    cra = dek.crown_apply_df(dd["cr"], cr["qtilde"], cr["rtilde"], dcr,
                             _root_extra(dd, cha["cqr"]), prep_cr)
    return -cra["res"], -_with_row0(dd, cha["res_part"], cra["xl"], cra["ul"])


def ms_newton_loop_df(ms: tm.MultistageQP, lam0_crown, lam0_chain,
                      opts: TdunesOpts, it0: int, handover=None):
    """The high-precision Newton loop on f64 data, counting iterations from
    ``it0``.

    ``handover``: the coarse phase's last (fact, sets), reused as the first
    factorization when its active-set pattern equals this phase's first
    (``tdunes_multistage._pattern_equal``; the values differ, since the
    coarse masked inverses came from f32 data).

    Returns (lam_cr, lam_ch, it, status, ls_it, cr, ch, err) as
    ``tdunes_multistage._ms_newton_loop`` does (without its handover); err
    is a 0-dim f64 tensor."""
    meta = ms.meta
    prep_cr = td._get_prep(meta.crown_topo)
    f32, f64 = torch.float32, torch.float64
    fused_eval = opts.chain_backend == "pallas"
    # the factorize and the solve run in f32, as the coarse phase's
    ctx = tm._solve_ctx(ms, prep_cr)
    nrxm32 = ctx["nrxm_cr"].to(f32)
    ctx = dict(ctx, dt=f32, nrxm_cr=nrxm32)
    rid = ctx["rid"]
    if fused_eval:
        dd = make_dd(ms, prep_cr)
        stage_solve = lambda lc, lh: df_stage_solve(dd, prep_cr, lc, lh)
        residuals = lambda cr, ch: df_residuals(dd, cr, ch)
        dual_value = lambda lc, lh, cr, ch: df_dual_value(cr, ch)
        apply_M = lambda cr, ch, dcr, dch: df_apply_M(dd, prep_cr, cr, ch, dcr, dch)
        total = df_reduce_flat
    else:
        crown_data = td._stage_data(ms.crown, opts, prep_cr)
        stage_solve = lambda lc, lh: tm._ms_stage_solve(ms, crown_data, lc, lh, opts,
                                                        prep_cr, rid)
        residuals = lambda cr, ch: (td._dual_residual(ms.crown, cr, prep_cr),
                                    tm._chain_residual(ms, ch, cr["x"], cr["u"], rid))
        dual_value = lambda lc, lh, cr, ch: tm._ms_dual_value(ms, crown_data, lc, lh,
                                                              cr, ch, opts)
        apply_M = lambda cr, ch, dcr, dch: tm._ms_apply_M(ms, cr, ch, dcr.to(f64),
                                                          dch.to(f64), prep_cr, rid)
        total = torch.sum

    def active_sig(cr, ch):
        return (cr["qtilde"], cr["rtilde"], ch["qt"], ch["rt"])

    def factorize(cr, ch):
        return tm._ms_factorize(ms, *(v.to(f32) for v in active_sig(cr, ch)), opts,
                                prep_cr, ctx, lanes=fused_eval)

    lam_cr = lam0_crown.to(f64) * ctx["nrxm_cr"].to(f64)
    lam_ch = lam0_chain.to(f64)
    cr, ch = stage_solve(lam_cr, lam_ch)
    res_cr, res_ch = residuals(cr, ch)
    err = tm._error_of(opts, res_cr, res_ch)
    f0 = dual_value(lam_cr, lam_ch, cr, ch)
    sig = active_sig(cr, ch)
    if handover is not None and tm._pattern_equal(sig, handover[1]):
        fact = handover[0]
    else:
        fact = factorize(cr, ch)
    one = torch.ones((), dtype=f32, device=lam_ch.device)
    it, status, restart, ls_it = it0, TDUNES_OPTIMAL, 0, 0
    while bool(err >= opts.tol) and status == TDUNES_OPTIMAL and it < opts.max_iter:
        if not (opts.reuse_factorization and tm._sets_equal(active_sig(cr, ch), sig)):
            fact = factorize(cr, ch)
        sig = active_sig(cr, ch)
        solve = tm._make_ms_solve(fact, meta, prep_cr, f32, nrxm32, opts, rid)

        def refine_resid(dcr, dch):
            mcr, mch = apply_M(cr, ch, dcr, dch)
            return res_cr - mcr, res_ch - mch

        # f32 in / f32 out; the refinement residual in f64
        dcr, dch = solve(res_cr.to(f32), res_ch.to(f32))
        if opts.refine_steps > 0 and not opts.refine_safeguard:
            for _ in range(opts.refine_steps):
                rcr, rch = refine_resid(dcr, dch)
                ccr, cch = solve(rcr.to(f32), rch.to(f32))
                dcr, dch = dcr + ccr, dch + cch
        elif opts.refine_steps > 0:
            # safeguarded: iterate unconditionally, keep the best iterate by
            # the f32 Newton-system residual norm
            def resnorm(dcr, dch):
                rcr, rch = refine_resid(dcr, dch)
                n = torch.sum(rcr.to(f32) ** 2) + torch.sum(rch.to(f32) ** 2)
                return float(n), rcr, rch
            n_best, rcr, rch = resnorm(dcr, dch)
            best = (dcr, dch)
            for _ in range(opts.refine_steps):
                ccr, cch = solve(rcr.to(f32), rch.to(f32))
                dcr, dch = dcr + ccr, dch + cch
                n_new, rcr, rch = resnorm(dcr, dch)
                if n_new < n_best:
                    best, n_best = (dcr, dch), n_new
            dcr, dch = best

        # Armijo on f = -g, the directional derivative summed in f64
        dot = -total(torch.cat([(res_cr * dcr).reshape(-1), (res_ch * dch).reshape(-1)]))

        def lam_at(tau):
            t = tau.to(f64)
            return lam_cr + dcr.to(f64) * t, lam_ch + dch.to(f64) * t

        def f_at(tau):
            lc, lh = lam_at(tau)
            cr2, ch2 = stage_solve(lc, lh)
            return dual_value(lc, lh, cr2, ch2), (cr2, ch2)

        f1, rest1 = f_at(one)
        tau, f_t, (cr_t, ch_t), ls_it, acc = tm._armijo(
            f_at, f0, dot, f1, rest1, opts, slack=ARMIJO_SLACK, tau_dtype=f32)
        restart = restart + 1 if not acc else 0
        if opts.ls_restart_trigger > 0 and restart >= opts.ls_restart_trigger:
            restart = 0
            tau, f_t, (cr_t, ch_t) = one, f1, rest1
        if bool(dot < 1e-10):  # the JAX package's documented < 0 deviation
            lam_cr, lam_ch = lam_at(tau)
            f0, cr, ch = f_t, cr_t, ch_t
        else:
            status = TDUNES_NOT_DESCENT
        it += 1
        res_cr, res_ch = residuals(cr, ch)
        err = tm._error_of(opts, res_cr, res_ch)
    return lam_cr, lam_ch, it, status, ls_it, cr, ch, err

"""The high-precision final phase of the sdunes dual-Newton solve, in
native f64.

Port of ``treeqp_tpu/solvers/sd_df64.py`` (``SdunesOpts.df64_phase``). The
JAX package does the phase's exact-data arithmetic in double-float (two f32
words per value) because TPU Pallas has no f64; the H100 has native FP64,
so the stage solves, residuals, dual values, the exact Hessian action and
the dual iterate are f64 tensors here, while the factorization, the full
solve and the Jay solve stay the f32 machinery of ``solvers.sdunes``. The
semantics are the JAX loop's where they differ from ``_sd_newton_loop``:

* at least one refinement pass (``max(refine_steps, 1)``);
* the factor blocks are built from the f32 rounding of the masked inverses
  qt / rt and of A, B (what the double-float ``.hi`` words hold), the
  directions are accumulated in f32, and the refinement's coupling
  coefficients are formed in f32;
* no stall escalation, no patience, and the Jay solve without an extra
  shift;
* Armijo on f = -g with the slack 2^-38 |f0| (f32), candidate steps in f32,
  and the same slack in the gradient fallback's test.

The error is taken on the f64 residuals; the JAX phase takes it on the hi
words, which differ from them below 2^-24 relative.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.solvers import sdunes as sd
from treeqp_tpu_torch.solvers.ms_df64 import ARMIJO_SLACK
from treeqp_tpu_torch.solvers.tdunes import TDUNES_OPTIMAL, TDUNES_NOT_DESCENT

__all__ = ["sd_newton_loop_df"]


def sd_newton_loop_df(sqp: sd.ScenarioQP, lam0, mu0, opts: sd.SdunesOpts, it0: int):
    """The high-precision Newton loop on f64 data, counting Newton steps
    from ``it0`` (the final phase after the coarse f32 one). Returns (lam,
    mu, it, err, status, ls_it), lam and mu f64, err a 0-dim f64 tensor."""
    meta = sqp.meta
    Ns, Nr = meta.Ns, meta.Nr
    nu = sqp.r.shape[-1]
    nl = Nr * nu
    f32, f64 = torch.float32, torch.float64
    dev = sqp.b.device
    sqp32 = sqp.to(dtype=f32)  # the f32 factor path reads the f32 rounding
    cmask = sd._coupling_masks(meta, f64, dev)
    dm = sd._dmask(cmask, meta, nu)
    cmask32, dm32 = cmask.to(f32), dm.to(f32)
    AT, BT = sqp.A.transpose(2, 3), sqp.B.transpose(2, 3)
    gamma32 = torch.tensor(opts.ls_gamma, dtype=f32, device=dev)
    beta32 = torch.tensor(opts.ls_beta, dtype=f32, device=dev)

    def f_at(mu_t, lam_t):
        return sd._dual_value(sqp, sd._stage_solve(sqp, mu_t, lam_t, cmask), mu_t)

    def armijo(f_of, f0, dot, tau0, eta):
        """Backtracking in f32 steps from tau0: accept unless f0 + gamma
        tau dot + eta < f. Returns (tau, count, accepted)."""
        def accepts(tau):
            rhs = f0 + dot * (gamma32 * tau).to(f64) + eta
            return not bool(rhs < f_of(tau))
        tau, i, acc = tau0, 1, accepts(tau0)
        while not acc and i < opts.ls_max_iter:
            tau = beta32 * tau
            acc = accepts(tau)
            i += 1
        return tau, i, acc

    def newton_step(lam, mu, status, sol, r_mu, r_lam):
        qt_b, rt_b = sol["qt"].to(f32), sol["rt"].to(f32)
        D, Ssub = sd._banded_blocks(sqp32.A, sqp32.B, qt_b, rt_b)
        Uown = sd._coupling_columns(sqp32.B, rt_b, meta)
        fact = sd._sd_factor(D, Ssub, opts)
        Z = sd._sd_full_solve(fact, torch.cat([r_mu.to(f32)[..., None], Uown], dim=-1),
                              opts)
        z_mu, Zu = Z[..., 0], Z[..., 1:]
        Gram = torch.einsum("skxl,skxm->slm", Uown, Zu)
        diag, off, _, _ = sd._jay_blocks(rt_b, Gram, cmask32, meta)
        rl_full = (r_lam.reshape(Ns - 1, nl) * dm if Ns > 1
                   else torch.zeros((1, nl), dtype=f64, device=dev))

        def schur_solve(e_l32, z_mu_):
            if Ns > 1:
                Kv = torch.einsum("skxl,skx->sl", Uown, z_mu_)
                rl = (e_l32 - (Kv[:-1] - Kv[1:])) * dm32
                dl = sd._jay_solve(diag, off, rl, opts) * dm32
            else:
                dl = torch.zeros((1, nl), dtype=f32, device=dev)
            return z_mu_ - torch.einsum("skxl,sl->skx", Zu, sd._coef_of(dl, Ns)), dl

        dmu, dlam_flat = schur_solve(rl_full.to(f32), z_mu)
        for _ in range(max(opts.refine_steps, 1)):
            # refinement against the exact f64 dual Hessian
            Amu, Al = sd._sd_apply_M(sqp, sol, cmask, dm32, dmu.to(f64), dlam_flat, AT, BT)
            z2 = sd._sd_full_solve(fact, (r_mu - Amu).to(f32)[..., None], opts)[..., 0]
            cmu, cl = schur_solve((rl_full - Al).to(f32), z2)
            dmu = dmu + cmu
            dlam_flat = dlam_flat + cl
        dlam = (dlam_flat * dm32).reshape(max(Ns - 1, 1), Nr, nu)

        dot = -(torch.sum(r_mu * dmu) + torch.sum(r_lam * dlam))
        descent_ok = bool(dot < 1e-10)
        f0 = sd._dual_value(sqp, sol, mu)
        eta = (torch.tensor(ARMIJO_SLACK, dtype=f32, device=dev) * f0.abs().to(f32)).to(f64)
        at = lambda t: (mu + dmu.to(f64) * t.to(f64), lam + dlam.to(f64) * t.to(f64))
        one = torch.ones((), dtype=f32, device=dev)
        tau, ls_it, acc = armijo(lambda t: f_at(*at(t)), f0, dot, one, eta)
        mu2, lam2 = at(tau) if descent_ok else (mu, lam)
        if opts.grad_fallback:
            if not descent_ok or not acc:
                L_est = torch.diagonal(D, dim1=2, dim2=3).abs().max()
                if Ns > 1:
                    L_est = torch.maximum(L_est, torch.diagonal(diag, dim1=1, dim2=2).abs().max())
                t0 = 1.0 / torch.clamp(L_est, min=1e-12)
                dot_g = -(torch.sum(r_mu * r_mu) + torch.sum(r_lam * r_lam))
                at_g = lambda t: (mu + r_mu * t.to(f64), lam + r_lam * t.to(f64))
                tau_g, ls_g, _ = armijo(lambda t: f_at(*at_g(t)), f0, dot_g, t0, eta)
                mu2, lam2 = at_g(tau_g)
                ls_it += ls_g
        elif not descent_ok:
            status = TDUNES_NOT_DESCENT
        return lam2, mu2, status, ls_it

    lam, mu, it = lam0.to(f64), mu0.to(f64), it0
    err = torch.full((), float("inf"), dtype=f64, device=dev)
    status, ls_it = TDUNES_OPTIMAL, 0
    while bool(err >= opts.tol) and status == TDUNES_OPTIMAL and it < opts.max_iter:
        sol = sd._stage_solve(sqp, mu, lam, cmask)
        r_mu, r_lam = sd._residuals(sqp, sol, cmask)
        err = sd._error_of(opts, r_mu, r_lam)
        if bool(err < opts.tol):
            break
        lam, mu, status, ls_it = newton_step(lam, mu, status, sol, r_mu, r_lam)
        it += 1
    return lam, mu, it, err, status, ls_it

"""Per-operation profiling (reference PROFILE=3, profiling.h:38-68).

Port of ``treeqp_tpu/utils/profiling.py``, with the same keys. The
reference tic/tocs inside the solve loop (stage QPs / dual build / Newton
direction / line search, dual_Newton_tree.c:1168-1227). Here each phase is
timed as its own call on representative iterates, as the JAX package does:
one warm-up call, then the minimum over ``nrep`` calls, each ending in a
synchronize of the devices its output lives on (``utils.timing``), so CUDA
work is inside the clock.

PROFILE level map:
  1 — total time: utils.timing.min_time_over
  2 — per-iteration stats: TdunesOpts(record_history=True)
  3 — per-op split: profile_tdunes_ops / profile_ms_phases below
"""

from __future__ import annotations

import dataclasses
import time

import torch

from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm
from treeqp_tpu_torch.utils.timing import synchronize

__all__ = ["profile_tdunes_ops", "profile_ms_phases"]


def _time(f, *a, nrep=5):
    synchronize(f(*a))
    ts = []
    for _ in range(nrep):
        t0 = time.perf_counter()
        synchronize(f(*a))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def profile_tdunes_ops(qp, opts=None, lam=None, nrep=5) -> dict:
    """Per-op times (seconds) for one dual-Newton iteration's phases:
    stage_qps / dual_build / newton_direction / line_search_eval, on the
    device of ``qp``'s tensors.

    Mirrors treeqp_profiling_t's PROFILE=3 quantities
    (profiling.h:56-66)."""
    opts = opts or td.TdunesOpts()
    prep = td._get_prep(qp.topo)
    dt = qp.dtype
    if lam is None:
        lam = torch.zeros((qp.topo.Nn, qp.topo.nxm), dtype=dt, device=qp.device)
    data = td._stage_data(qp, opts, prep)

    out = {}
    out["stage_qps"] = _time(
        lambda l: td._stage_solve(qp, l, data, opts, prep)["x"], lam, nrep=nrep)

    sol = td._stage_solve(qp, lam, data, opts, prep)

    def dual_build(l):
        s = td._stage_solve(qp, l, data, opts, prep)
        res = td._dual_residual(qp, s, prep)
        W, Ut = td._build_dual_hessian(qp, s, data, opts, prep)
        return W, res

    t_build_tot = _time(lambda l: dual_build(l)[0], lam, nrep=nrep)
    out["dual_build"] = max(t_build_tot - out["stage_qps"], 0.0)

    res = td._dual_residual(qp, sol, prep)
    W, Ut = td._build_dual_hessian(qp, sol, data, opts, prep)
    rg = td._nodes_to_group_mm(res, prep)
    out["newton_direction"] = _time(
        lambda W, Ut, rg: td._newton_direction(W, Ut, rg, opts, prep, qp, sol, data),
        W, Ut, rg, nrep=nrep)

    dlam_g = td._newton_direction(W, Ut, rg, opts, prep, qp, sol, data)
    dlam = td._group_to_nodes_mm(dlam_g, prep, dt)

    def ls_eval(l, d):
        lt = l + 0.5 * d
        s = td._stage_solve(qp, lt, data, opts, prep)
        return td._dual_value(qp, lt, s, data, opts)

    out["line_search_eval"] = _time(ls_eval, lam, dlam, nrep=nrep)
    out["iteration_estimate"] = (out["stage_qps"] + out["dual_build"]
                                 + out["newton_direction"]
                                 + 2 * out["line_search_eval"])
    return out


def profile_ms_phases(ms, opts=None, nrep=3) -> dict:
    """PROFILE=3 phase split for the two-phase multistage dual Newton:
    wall time of the coarse f32 phase, the high-precision (df64 or f64)
    phase, plus the per-call cost of one factorization and one
    line-search evaluation — the treeqp_profiling_t per-op quantities
    (profiling.h:56-66). As in the JAX package, the coarse phase is the
    per-kernel loop (``_ms_newton_loop``, stall patience 3) from zero
    duals, the high-precision phase starts from its duals, and the
    factorization (the dual Hessian build and the chain Cholesky) and the
    line-search evaluation are timed at that start."""
    opts = opts or td.TdunesOpts()
    meta = ms.meta
    prep_cr = td._get_prep(meta.crown_topo)
    dt, dev = ms.q.dtype, ms.q.device
    lam0_cr = torch.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm), dtype=dt, device=dev)
    lam0_ch = torch.zeros_like(ms.q)
    out = {}

    f32 = torch.float32
    use_coarse = (opts.f32_phase_tol > 0 and dt == torch.float64
                  and opts.factor_dtype == "float32")
    lamA_cr, lamA_ch = lam0_cr, lam0_ch
    if use_coarse:
        ms32 = ms.to(dtype=f32)
        optsA = dataclasses.replace(
            opts, refine_steps=0, tol=max(opts.f32_phase_tol, opts.tol),
            ls_batch=opts.ls_batch if opts.ls_batch > 0 else 4)

        def coarse(lc, lh):
            r = tm._ms_newton_loop(ms32, lc, lh, optsA, 0, patience=3)
            return r[0], r[1], r[2]

        out["f32_phase"] = _time(coarse, lam0_cr.to(f32), lam0_ch.to(f32), nrep=nrep)
        lamA_cr32, lamA_ch32, itA = coarse(lam0_cr.to(f32), lam0_ch.to(f32))
        out["f32_phase_iters"] = int(itA)
        lamA_cr, lamA_ch = lamA_cr32.to(dt), lamA_ch32.to(dt)

    if opts.df64_phase and dt == torch.float64 and opts.factor_dtype == "float32":
        from treeqp_tpu_torch.solvers.ms_df64 import ms_newton_loop_df

        def hi_phase(lc, lh):
            r = ms_newton_loop_df(ms, lc, lh, opts, 0)
            return r[0], r[1], r[2]

        key = "df64_phase"
    else:
        def hi_phase(lc, lh):
            r = tm._ms_newton_loop(ms, lc, lh, opts, 0)
            return r[0], r[1], r[2]

        key = "f64_phase"
    out[key] = _time(hi_phase, lamA_cr, lamA_ch, nrep=nrep)
    out[key + "_iters"] = int(hi_phase(lamA_cr, lamA_ch)[2])

    # per-op: one factorization (dual Hessian build + chain Cholesky) and
    # one line-search dual-value evaluation, at the warm-started iterate
    crown_data = td._stage_data(ms.crown, opts, prep_cr)
    rid = tm._solve_ctx(ms, prep_cr)["rid"]
    fdt = td._factor_dtype(opts, dt)

    def factor(lc, lh):
        cr, ch = tm._ms_stage_solve(ms, crown_data, lc, lh, opts, prep_cr, rid)
        W, Ut = td._build_dual_hessian(ms.crown, cr, crown_data, opts, prep_cr, dtype=fdt)
        Wc, Utc = tm._chain_blocks(ms, ch, cr["qtilde"], cr["rtilde"], rid, fdt)
        Ls, CUs, schur0 = tm._chain_factor(Wc, Utc, opts)
        return Ls, schur0, W

    out["factorization"] = _time(factor, lamA_cr, lamA_ch, nrep=nrep)

    def ls_eval(lc, lh):
        cr, ch = tm._ms_stage_solve(ms, crown_data, lc, lh, opts, prep_cr, rid)
        return tm._ms_dual_value(ms, crown_data, lc, lh, cr, ch, opts)

    out["line_search_eval"] = _time(ls_eval, lamA_cr, lamA_ch, nrep=nrep)
    return out

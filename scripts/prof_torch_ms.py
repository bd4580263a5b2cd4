#!/usr/bin/env python3
"""Where the time of the PyTorch port's multistage solve goes, on one card.

    python3 scripts/prof_torch_ms.py [--md 4 --nr 4 --nh 20] [--reps 10]
                                     [--f32-phase-tol 1e-4] [--termination twonorm]
                                     [--df64-phase]

Prints, for quadcopter(md, nr, nh) with the one-phase options of
chip_smoke.py (or, with --f32-phase-tol > 0, its two-phase options; with
--df64-phase the high-precision phase of ``solvers/ms_df64.py``, so that
``--f32-phase-tol 1e-4 --df64-phase`` are bench.py's options):

* cold and warm solve times (host clock around synchronized solves;
  median of --reps) and their iteration counts;
* the cost of each step of one Newton iteration, timed alone (host clock,
  synchronized): stage evaluation, residuals, dual value, factorize (the
  chain and crown kernels with their operand assembly), one system solve,
  one Hessian action; with the two-phase options also the coarse phase's
  steps: one newton_iter launch in each mode and one f32 factorize; with
  --df64-phase the high-precision phase's evaluation, residuals, dual value
  and Hessian action instead of the f64 loop's;
* the factorizations of one cold solve (factor kernel launches);
* a torch.profiler trace of one cold solve and of one warm solve (the
  cold solve's duals, x0 scaled by 1.01): the device-busy share (summed
  device kernel time over wall time) and the kernels with the most
  device time.

Needs CUDA; imports nothing of JAX.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from prof_common import card as card_name, profile_call, timed  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--md", type=int, default=4)
    ap.add_argument("--nr", type=int, default=4)
    ap.add_argument("--nh", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--f32-phase-tol", type=float, default=0.0)
    ap.add_argument("--termination", default="infnorm")
    ap.add_argument("--df64-phase", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_ms: needs a CUDA device")
    import treeqp_tpu_torch  # noqa: F401
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.models import quadcopter
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import ms_df64 as md
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import iter_kernel as ik
    from chip_smoke import SLICE_OPTS, TWO_PHASE_OPTS

    card = card_name()
    dev = torch.device("cuda", 0)
    base = TWO_PHASE_OPTS if args.f32_phase_tol > 0 else SLICE_OPTS
    opts = td.TdunesOpts(**{**base, "termination": args.termination,
                            "f32_phase_tol": args.f32_phase_tol,
                            "df64_phase": args.df64_phase})
    qp = quadcopter(args.md, args.nr, args.nh).qp.to(dev)
    ms = tm.split_multistage(qp)
    meta = ms.meta
    print(f"quadcopter({args.md},{args.nr},{args.nh}): {meta.full_topo.Nn} nodes, "
          f"S={meta.S}, crown {meta.crown_topo.Nn} nodes / "
          f"{td._get_prep(meta.crown_topo).NpG} groups, on {card}")

    cro, cho, info = tm.tdunes_ms_solve(ms, None, None, opts)
    kkt = max_kkt_residual(qp, tm.merge_output(ms, cro, cho, info))
    print(f"cold solve: iter {info['iter']} (coarse {info['iter_f32']}) status "
          f"{info['status']} kkt {kkt:.2e}; options f32_phase_tol="
          f"{opts.f32_phase_tol} termination={opts.termination} "
          f"df64_phase={opts.df64_phase}")
    lam_w = (cro["lam"], cho["lam"])
    xmin, xmax = ms.crown.xmin.clone(), ms.crown.xmax.clone()
    xmin[0] *= 1.01
    xmax[0] *= 1.01
    ms_p = dataclasses.replace(ms, crown=ms.crown.replace(xmin=xmin, xmax=xmax))
    t_cold = timed(torch, lambda: tm.tdunes_ms_solve(ms, None, None, opts), args.reps)
    t_warm = timed(torch, lambda: tm.tdunes_ms_solve(ms_p, *lam_w, opts), args.reps)
    _, _, info_w = tm.tdunes_ms_solve(ms_p, *lam_w, opts)
    print(f"cold solve {t_cold:.2f} ms ({info['iter']} iter, {info['iter_f32']} "
          f"coarse), warm solve (x0 scaled by 1.01) {t_warm:.2f} ms "
          f"({info_w['iter']} iter, {info_w['iter_f32']} coarse) on {card}")
    factors = (ck.chain_blocks_factor, ck.chain_blocks_factor_lanes)
    for k in factors:
        k.launches = 0
    tm.tdunes_ms_solve(ms, None, None, opts)
    print("factorizations in one cold solve: "
          + ", ".join(f"{k.__name__} {k.launches}" for k in factors))

    # one Newton iteration's steps, each timed alone
    prep = td._get_prep(meta.crown_topo)
    ctx = tm._solve_ctx(ms, prep)
    data = td._stage_data(ms.crown, opts, prep)
    lam_cr, lam_ch = 0.5 * cro["lam"], 0.5 * cho["lam"]
    cr, ch = tm._ms_stage_solve(ms, data, lam_cr, lam_ch, opts, prep, ctx["rid"])
    res_cr = td._dual_residual(ms.crown, cr, prep)
    res_ch = tm._chain_residual(ms, ch, cr["x"], cr["u"], ctx["rid"])
    fact = tm._ms_factorize(ms, cr["qtilde"], cr["rtilde"], ch["qt"], ch["rt"],
                            opts, prep, ctx)
    solve = tm._make_ms_solve(fact, meta, prep, ms.q.dtype, ctx["nrxm_cr"])
    d_cr, d_ch = solve(res_cr, res_ch)
    steps = {
        "stage eval": lambda: tm._ms_stage_solve(ms, data, lam_cr, lam_ch, opts,
                                                 prep, ctx["rid"]),
        "residuals": lambda: (td._dual_residual(ms.crown, cr, prep),
                              tm._chain_residual(ms, ch, cr["x"], cr["u"], ctx["rid"])),
        "dual value": lambda: float(tm._ms_dual_value(ms, data, lam_cr, lam_ch,
                                                      cr, ch, opts)),
        "factorize": lambda: tm._ms_factorize(ms, cr["qtilde"], cr["rtilde"],
                                              ch["qt"], ch["rt"], opts, prep, ctx),
        "system solve": lambda: solve(res_cr, res_ch),
        "Hessian action": lambda: tm._ms_apply_M(ms, cr, ch, d_cr, d_ch, prep,
                                                 ctx["rid"]),
    }
    if opts.f32_phase_tol > 0:
        ms32 = ms.to(dtype=torch.float32)
        ctx32 = tm._solve_ctx(ms32, prep)
        data_ch, data_cr = tm._eval_data(ms32, prep)
        state = dict(lam_cr=lam_cr.float() * ctx32["nrxm_cr"], lam_ch=lam_ch.float())
        ev = ik.newton_iter(data_ch, data_cr, None, state, prep, meta.root_ids, "eval")
        sets = (ev["qtilde"], ev["rtilde"], ev["qt"], ev["rt"])
        fact32 = tm._ms_factorize(ms32, *sets, opts, prep, ctx32, lanes=True)
        state.update(res_cr=ev["res2_cr"], res_ch=ev["res2_ch"])
        steps.update({
            "coarse newton_iter (iter)": lambda: ik.newton_iter(
                data_ch, data_cr, fact32, state, prep, meta.root_ids, "iter"),
            "coarse newton_iter (eval)": lambda: ik.newton_iter(
                data_ch, data_cr, None, state, prep, meta.root_ids, "eval"),
            "coarse factorize (f32)": lambda: tm._ms_factorize(
                ms32, *sets, opts, prep, ctx32, lanes=True),
        })
    if opts.df64_phase:
        dd = md.make_dd(ms, prep)
        crd, chd = md.df_stage_solve(dd, prep, lam_cr, lam_ch)
        d32 = (d_cr.float(), d_ch.float())
        for k in ("stage eval", "residuals", "dual value", "Hessian action"):
            del steps[k]
        steps.update({
            "df stage eval": lambda: md.df_stage_solve(dd, prep, lam_cr, lam_ch),
            "df residuals": lambda: md.df_residuals(dd, crd, chd),
            "df dual value": lambda: float(md.df_dual_value(crd, chd)),
            "df Hessian action": lambda: md.df_apply_M(dd, prep, crd, chd, *d32),
        })
    for name, fn in steps.items():
        print(f"  step {name}: {timed(torch, fn, args.reps):.3f} ms")

    # device-busy share and top kernels over one cold solve and one warm one
    profile_call(torch, lambda: tm.tdunes_ms_solve(ms, None, None, opts), card)
    profile_call(torch, lambda: tm.tdunes_ms_solve(ms_p, *lam_w, opts), card, "warm solve")

if __name__ == "__main__":
    main()

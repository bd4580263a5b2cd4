#!/usr/bin/env python3
"""Where the time of the PyTorch port's sdunes solves goes, on one card.

    python3 scripts/prof_torch_sdunes.py [--reps 3] [--nr 4]

Runs sdunes_bench's modes on its tree, spring_mass_chain(4, 4, Nr, 20)
(``--nr 4``: 256 scenarios, 4437 nodes), at ``models.SDUNES_OPTS``. Prints:

* the cold ``sdunes_solve``: its time, its iterations (coarse f32 phase +
  final f64 phase), the coarse phase alone (``_sd_newton_loop`` on the f32
  data with the coarse phase's options) over its iterations as the ms of
  a coarse iteration, the rest over the final iterations as the ms of a
  final iteration, and the launches of chain_factor, chain_full_solve_mat
  and jay_cr_solve per iteration of each phase;
* sdunes_boot and sdunes_boot_df64, the bench's first perturbed request:
  the bootstrap (``tdunes_ms_solve`` at ``models.SDUNES_BOOT_OPTS``,
  ``merge_output``, ``scenario_duals_from_tree``) and the sdunes solve
  from its duals, each timed, with their iterations;
* sdunes_f32 (f32 data, cold, tol 1e-3, no coarse phase) and
  ``tdunes_ms_solve``'s all-f32 loop on the same request: ms a solve and
  an iteration (sdunes_bench's f32_phase_ms_per_iter);
* torch.profiler traces of one cold solve and one sdunes_boot request:
  device-busy share, launches and the kernels with the most device time.

Times are host-clock medians of --reps synchronized calls. Needs CUDA;
imports nothing of JAX.
"""

import argparse
import dataclasses
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from prof_common import card as card_name, profile_call, timed  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--nr", type=int, default=4)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_sdunes: needs a CUDA device")
    import treeqp_tpu_torch  # noqa: F401
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.models import SDUNES_BOOT_OPTS, SDUNES_OPTS, spring_mass_chain
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import jay_kernel as jk
    from treeqp_tpu_torch.solvers import sdunes as sd
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm

    card = card_name()
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    qp = spring_mass_chain(4, 4, args.nr, 20, device=dev)[0]
    sqp = sd.scenario_data(qp)
    ms = tm.split_multistage(qp)
    opts = sd.SdunesOpts(**SDUNES_OPTS)
    opts_boot = td.TdunesOpts(**SDUNES_BOOT_OPTS)
    kernels = (ck.chain_factor, ck.chain_full_solve_mat, jk.jay_cr_solve)
    meta = sqp.meta
    print(f"spring_mass_chain(4,4,{args.nr},20): {qp.topo.Nn} nodes, {meta.Ns} scenarios, "
          f"Nh={meta.Nh}, nx={meta.nx} nu={meta.nu}; Jay P={meta.Ns - 1} b={meta.Nr * meta.nu}")

    def counted(fn):
        """fn()'s result and the launches of the three kernels in it."""
        for k in kernels:
            k.launches = 0
        res = fn()
        torch.cuda.synchronize()
        return res, {k.__name__: k.launches for k in kernels}

    def solve(sq, lam0, mu0, o):
        res = sd.sdunes_solve(sq, lam0, mu0, o)
        torch.cuda.synchronize()
        return res

    # the cold solve, and its coarse phase alone
    (sol, lam, mu, info), n_all = counted(lambda: solve(sqp, None, None, opts))
    kkt = max_kkt_residual(qp, sd.scenario_output(sqp, sol, lam, mu, info))
    c, n = info["iter_f32"], info["iter"]
    sqp32 = sqp.to(dtype=f32)
    opts_c = dataclasses.replace(opts, refine_steps=0, tol=max(opts.f32_phase_tol, opts.tol))
    z_lam = torch.zeros((meta.Ns - 1, meta.Nr, meta.nu), dtype=f32, device=dev)
    z_mu = torch.zeros((meta.Ns, meta.Nh, meta.nx), dtype=f32, device=dev)

    def coarse():
        out = sd._sd_newton_loop(sqp32, z_lam, z_mu, opts_c, 0, patience=3)
        torch.cuda.synchronize()
        return out
    _, n_c = counted(coarse)
    t_cold = timed(torch, lambda: solve(sqp, None, None, opts), args.reps)
    t_c = timed(torch, coarse, args.reps)
    per = lambda v, it: f"{v / max(it, 1):.2f}"
    print(f"cold solve: {t_cold:.2f} ms, {n} iterations ({c} coarse + {n - c} final), status "
          f"{info['status']}, error {info['error']:.3e}, kkt {kkt:.3e} on {card}")
    print(f"  the coarse phase alone {t_c:.2f} ms: {per(t_c, c)} ms a coarse iteration; "
          f"{per(t_cold - t_c, n - c)} ms a final iteration")
    print("  launches per coarse iteration: " + ", ".join(
        f"{k} {per(v, c)}" for k, v in n_c.items()) + "; per final iteration: " + ", ".join(
        f"{k} {per(n_all[k] - n_c[k], n - c)}" for k in n_all))

    # the bench's first perturbed request, bootstrapped
    fac = 1.0 + 0.02 * math.sin(1.0 + 1.7)
    sq_k = sqp.replace(xmin=sqp.xmin.clone(), xmax=sqp.xmax.clone())
    sq_k.xmin[:, 0] *= fac
    sq_k.xmax[:, 0] *= fac
    cr = ms.crown.replace(xmin=ms.crown.xmin.clone(), xmax=ms.crown.xmax.clone())
    cr.xmin[0] *= fac
    cr.xmax[0] *= fac
    ms_k = dataclasses.replace(ms, crown=cr)

    def bootstrap():
        cro, cho, binfo = tm.tdunes_ms_solve(ms_k, None, None, opts_boot)
        duals = sd.scenario_duals_from_tree(sq_k, None, tm.merge_output(ms_k, cro, cho, binfo))
        torch.cuda.synchronize()
        return duals, binfo
    (lam0, mu0), binfo = bootstrap()
    t_b = timed(torch, bootstrap, args.reps)
    print(f"bootstrap: {t_b:.2f} ms, {binfo['iter']} tdunes_ms_solve iterations "
          f"({binfo['iter_f32']} coarse), error {binfo['error']:.3e} on {card}")
    for mode, o in (("sdunes_boot", opts), ("sdunes_boot_df64",
                                            dataclasses.replace(opts, df64_phase=True))):
        (_, _, _, info_b), n_b = counted(lambda: solve(sq_k, lam0, mu0, o))
        t_s = timed(torch, lambda: solve(sq_k, lam0, mu0, o), args.reps)
        print(f"{mode}: sdunes {t_s:.2f} ms, {info_b['iter']} iterations "
              f"({info_b['iter_f32']} coarse), error {info_b['error']:.3e}, launches {n_b}; "
              f"request {t_b + t_s:.2f} ms on {card}")

    # the all-f32 loops of both solvers
    opts_f = dataclasses.replace(opts, tol=1e-3, max_iter=80, f32_phase_tol=0.0)
    sq32_k = sq_k.to(dtype=f32)
    info_f = solve(sq32_k, None, None, opts_f)[3]
    t_f = timed(torch, lambda: solve(sq32_k, None, None, opts_f), args.reps)
    opts_mf = dataclasses.replace(opts_boot, tol=1e-3, max_iter=80, f32_phase_tol=0.0,
                                  df64_phase=False, refine_steps=0)
    ms32_k = ms_k.to(dtype=f32)

    def ms_f32():
        out = tm.tdunes_ms_solve(ms32_k, None, None, opts_mf)
        torch.cuda.synchronize()
        return out
    info_mf = ms_f32()[2]
    t_mf = timed(torch, ms_f32, args.reps)
    print(f"sdunes_f32: {t_f:.2f} ms, {info_f['iter']} iterations, {per(t_f, info_f['iter'])} "
          f"ms an iteration; tdunes_ms_f32: {t_mf:.2f} ms, {info_mf['iter']} iterations, "
          f"{per(t_mf, info_mf['iter'])} ms an iteration on {card}")

    profile_call(torch, lambda: solve(sqp, None, None, opts), card, what="cold sdunes solve")
    profile_call(torch, lambda: (bootstrap(), solve(sq_k, lam0, mu0, opts)), card,
                 what="sdunes_boot request")


if __name__ == "__main__":
    main()

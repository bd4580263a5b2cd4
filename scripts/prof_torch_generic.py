#!/usr/bin/env python3
"""Where the time of the PyTorch port's generic-tree solve goes, on one card.

    python3 scripts/prof_torch_generic.py [--tree pruned|asym|full|cd_qpgen|cd_mixed]
                                          [--reps 10]

Solves with ``tdunes_solve`` at ``models.GENERIC_SPEED_OPTS``
(generic_bench.speed_opts(on_tpu=True)) one of: the headline
quadcopter(4,4,20) pruned to 128 scenarios (``pruned``, the split path),
the asymmetric thesis-class tree of benchmarks/generic_bench.py (``asym``,
the crown path), or the unpruned headline tree (``full``, the split path
with 256 chains); or at ``models.GENERAL_CD_OPTS`` one of the general C/D
trees of benchmarks/general_cd_bench.py (spring_mass_chain(4,4,4,20),
4437 nodes, the split path): a general row on every node (``cd_qpgen``,
stage solver qpgen) or on every third node (``cd_mixed``). Prints:

* cold and warm solve times (host clock around synchronized solves; median
  of --reps; the warm request scales the root's bound rows by 1.01, or on
  the general C/D trees shifts b by 1e-6 as general_cd_bench's warm chain
  does, and starts from the cold solution's duals and working sets) with
  their iterations, factorizations, ADMM launches and stage solves (line
  search trials included);
* the cost of each step of one f64-phase Newton iteration at the cold
  solution's half-way point, timed alone (host clock, synchronized): stage
  solve (on the general C/D trees hotstarted from the cold solution's
  working sets, and cold, with the ADMM identification, which is also
  timed alone), dual residual, dual-Hessian blocks, equilibrate and
  factorize (the tree-Cholesky kernels with their operand assembly), one
  tree solve, one Hessian action, one line-search trial;
* a torch.profiler trace of one cold solve: the device-busy share (summed
  device kernel time over wall time), the kernel launches, and the
  kernels with the most device time.

Needs CUDA; imports nothing of JAX.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from prof_common import card as card_name, profile_call, timed  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", choices=("pruned", "asym", "full", "cd_qpgen", "cd_mixed"),
                    default="pruned")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_generic: needs a CUDA device")
    import treeqp_tpu_torch  # noqa: F401
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.models import (GENERAL_CD_OPTS, GENERIC_SPEED_OPTS, asym_tree,
                                         general_cd, pruned, quadcopter)
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import qpgen_lanes as ql
    from treeqp_tpu_torch.solvers import tdunes as td

    card = card_name()
    dev = torch.device("cuda", 0)
    opts = td.TdunesOpts(**GENERIC_SPEED_OPTS)
    cd = args.tree.startswith("cd_")
    if cd:
        mode = args.tree[3:]
        qp = general_cd(mode, device=dev)
        # the options tdunes_solve derives from the data, set here for the
        # steps timed alone
        opts = td.TdunesOpts(**{**GENERAL_CD_OPTS, "stage_solver": mode, "h_diag": True},
                             node_solver=td.clipping_applicable_nodes(qp) if mode == "mixed"
                             else None)
    elif args.tree == "asym":
        qp = asym_tree(device=dev)
    else:
        qp = quadcopter(4, 4, 20, device=dev).qp
        if args.tree == "pruned":
            qp = pruned(qp, 128)
    prep = td._get_prep(qp.topo)
    split = td._split_sched(prep)
    print(f"{args.tree} tree: {qp.topo.Nn} nodes, {prep.NpG} lambda-groups of dim "
          f"{prep.G}, " + ("no split schedule (crown path)" if split is None else
                           f"split: {len(split[0])} chain levels of {split[0][0][1]} "
                           f"chains, {len(split[1])} crown levels") + f", on {card}")

    def counted(fn):
        """fn's result, factorizations, ADMM launches and stage solves
        (coarse f32, data dtype): the solver module's _stage_solve, which the
        Newton loop and every line-search trial call, is wrapped for fn."""
        ckr.crown_factor.launches = ql.admm_identify.launches = 0
        n = {torch.float32: 0, torch.float64: 0}
        real = td._stage_solve

        def count(q, *a, **k):
            n[q.dtype] += 1
            return real(q, *a, **k)
        td._stage_solve = count
        try:
            out = fn()
        finally:
            td._stage_solve = real
        torch.cuda.synchronize()
        return (out, ckr.crown_factor.launches, ql.admm_identify.launches,
                f"{sum(n.values())} stage solves ({n[torch.float32]} coarse + "
                f"{n[torch.float64]} final)")

    out, nf, na, ns = counted(lambda: td.tdunes_solve(qp, None, opts))
    info = out.info
    ws = info.get("qpgen_ws")
    if cd:
        qp_w, what = qp.replace(b=qp.b + 1e-6), "b shifted by 1e-6"
    else:
        xmin, xmax = qp.xmin.clone(), qp.xmax.clone()
        xmin[0] *= 1.01
        xmax[0] *= 1.01
        qp_w, what = qp.replace(xmin=xmin, xmax=xmax), "x0 scaled by 1.01"
    warm = lambda: td.tdunes_solve(qp_w, out.lam, opts, stage_ws=ws)
    out_w, nf_w, na_w, ns_w = counted(warm)
    t_cold = timed(torch, lambda: td.tdunes_solve(qp, None, opts), args.reps)
    t_warm = timed(torch, warm, args.reps)
    print(f"cold solve {t_cold:.2f} ms ({info['iter']} iter, {info['iter_f32']} coarse, "
          f"{nf} factorizations, {na} ADMM launches, {ns}, "
          f"kkt {max_kkt_residual(qp, out):.2e}), warm solve ({what}) {t_warm:.2f} ms "
          f"({out_w.info['iter']} iter, {out_w.info['iter_f32']} coarse, {nf_w} "
          f"factorizations, {na_w} ADMM launches, {ns_w}) on {card}")

    # one f64-phase Newton iteration's steps, each timed alone
    data = td._stage_data(qp, opts, prep)
    lam = 0.5 * out.lam
    nrxm = td._masks(qp, prep)[2]
    sol = td._stage_solve(qp, lam, data, opts, prep, inner_ws=ws)
    res = td._dual_residual(qp, sol, prep)
    W, Ut = td._build_dual_hessian(qp, sol, data, opts, prep)
    rg = td._nodes_to_group_mm(res, prep)
    sW, fact = td._newton_factor(W, Ut, opts, prep)
    d_nodes = td._group_to_nodes_mm(td._newton_solve(sW, fact, rg, prep), prep,
                                    qp.dtype) * nrxm
    steps = {
        "stage solve" + (" (hotstart)" if cd else ""):
            lambda: td._stage_solve(qp, lam, data, opts, prep, inner_ws=ws),
        "dual residual": lambda: td._dual_residual(qp, sol, prep),
        "Hessian blocks": lambda: td._build_dual_hessian(qp, sol, data, opts, prep),
        "equilibrate + factorize": lambda: td._newton_factor(W, Ut, opts, prep),
        "tree solve": lambda: td._newton_solve(sW, fact, rg, prep),
        "Hessian action": lambda: td._apply_M_nodes(qp, sol, data, d_nodes, opts, prep),
        "line-search trial": lambda: float(td._dual_value(
            qp, lam + d_nodes,
            td._stage_solve(qp, lam + d_nodes, data, opts, prep, inner_ws=ws), data, opts)),
    }
    if cd:
        d = data.get("gen", data)
        qmod, rmod = td._modified_gradient(qp, lam, prep)
        hmod = torch.cat([qmod, rmod], dim=1)
        hmod = hmod[d["idx"]] if "idx" in d else hmod
        lo_c, hi_c, _ = td._general_bounds(d["lo"], d["hi"], d["m_lo"], d["m_hi"])
        admm = td._admm_operands(hmod, d["Hinv"], d["G"], lo_c, hi_c, d["rho_row"],
                                 d["L_admm"])
        steps["stage solve (cold: ADMM)"] = lambda: td._stage_solve(qp, lam, data, opts, prep)
        steps[f"ADMM identification alone ({hmod.shape[0]} stage QPs)"] = \
            lambda: ql.admm_identify(*admm, opts.qpgen_iters)
    for name, fn in steps.items():
        print(f"  step {name}: {timed(torch, fn, args.reps):.3f} ms")

    # device-busy share and top kernels over one cold solve
    profile_call(torch, lambda: td.tdunes_solve(qp, None, opts), card)


if __name__ == "__main__":
    main()

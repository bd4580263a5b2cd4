#!/usr/bin/env python3
"""Where the time of the PyTorch port's generic-tree solve goes, on one card.

    python3 scripts/prof_torch_generic.py [--tree pruned|asym|full] [--reps 10]

Solves with ``tdunes_solve`` at ``models.GENERIC_SPEED_OPTS``
(generic_bench.speed_opts(on_tpu=True)) one of: the headline
quadcopter(4,4,20) pruned to 128 scenarios (``pruned``, the split path),
the asymmetric thesis-class tree of benchmarks/generic_bench.py (``asym``,
the crown path), or the unpruned headline tree (``full``, the split path
with 256 chains). Prints:

* cold and warm solve times (host clock around synchronized solves; median
  of --reps; the warm request scales the root's bound rows by 1.01 and
  starts from the cold solution) with their iterations and factorizations;
* the cost of each step of one f64-phase Newton iteration at the cold
  solution's half-way point, timed alone (host clock, synchronized): stage
  solve, dual residual, dual-Hessian blocks, equilibrate and factorize
  (the tree-Cholesky kernels with their operand assembly), one tree
  solve, one Hessian action, one line-search trial;
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
    ap.add_argument("--tree", choices=("pruned", "asym", "full"), default="pruned")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_generic: needs a CUDA device")
    import treeqp_tpu_torch  # noqa: F401
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.models import GENERIC_SPEED_OPTS, asym_tree, pruned, quadcopter
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.solvers import tdunes as td

    card = card_name()
    dev = torch.device("cuda", 0)
    opts = td.TdunesOpts(**GENERIC_SPEED_OPTS)
    if args.tree == "asym":
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

    def factorizations(fn):
        ckr.crown_factor.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, ckr.crown_factor.launches

    out, nf = factorizations(lambda: td.tdunes_solve(qp, None, opts))
    info = out.info
    xmin, xmax = qp.xmin.clone(), qp.xmax.clone()
    xmin[0] *= 1.01
    xmax[0] *= 1.01
    qp_w = qp.replace(xmin=xmin, xmax=xmax)
    out_w, nf_w = factorizations(lambda: td.tdunes_solve(qp_w, out.lam, opts))
    t_cold = timed(torch, lambda: td.tdunes_solve(qp, None, opts), args.reps)
    t_warm = timed(torch, lambda: td.tdunes_solve(qp_w, out.lam, opts), args.reps)
    print(f"cold solve {t_cold:.2f} ms ({info['iter']} iter, {info['iter_f32']} coarse, "
          f"{nf} factorizations, kkt {max_kkt_residual(qp, out):.2e}), warm solve "
          f"(x0 scaled by 1.01) {t_warm:.2f} ms ({out_w.info['iter']} iter, "
          f"{out_w.info['iter_f32']} coarse, {nf_w} factorizations) on {card}")

    # one f64-phase Newton iteration's steps, each timed alone
    data = td._stage_data(qp, opts, prep)
    lam = 0.5 * out.lam
    nrxm = td._masks(qp, prep)[2]
    sol = td._stage_solve(qp, lam, data, opts, prep)
    res = td._dual_residual(qp, sol, prep)
    W, Ut = td._build_dual_hessian(qp, sol, prep)
    rg = td._nodes_to_group_mm(res, prep)
    sW, fact = td._newton_factor(W, Ut, opts, prep)
    d_nodes = td._group_to_nodes_mm(td._newton_solve(sW, fact, rg, prep), prep,
                                    qp.dtype) * nrxm
    steps = {
        "stage solve": lambda: td._stage_solve(qp, lam, data, opts, prep),
        "dual residual": lambda: td._dual_residual(qp, sol, prep),
        "Hessian blocks": lambda: td._build_dual_hessian(qp, sol, prep),
        "equilibrate + factorize": lambda: td._newton_factor(W, Ut, opts, prep),
        "tree solve": lambda: td._newton_solve(sW, fact, rg, prep),
        "Hessian action": lambda: td._apply_M_nodes(qp, sol, d_nodes, prep),
        "line-search trial": lambda: float(td._dual_value(
            qp, lam + d_nodes, td._stage_solve(qp, lam + d_nodes, data, opts, prep),
            data, opts)),
    }
    for name, fn in steps.items():
        print(f"  step {name}: {timed(torch, fn, args.reps):.3f} ms")

    # device-busy share and top kernels over one cold solve
    profile_call(torch, lambda: td.tdunes_solve(qp, None, opts), card)

if __name__ == "__main__":
    main()

"""All solver families on the reference's spring_mass robust-MPC instance,
on the PyTorch + CUDA port.

The problem of examples/spring_mass.c (md=3, Nr=2, Nh=10, NX=4, NU=1 from
spring_mass_utils/data.c:13-17, read by ``models.spring_mass_qp`` from
``--data-dir``): tdunes, sdunes, the tree IPM and the multistage
crown+chains variants all solve it; trajectories are cross-checked
element-wise and every solution is certified by the KKT oracle, the same
cross-solver agreement check the reference example runs
(spring_mass.c:309-489). Every solver runs at its default options: the
portable backend (plain PyTorch, f64 factors).

Run from the repo root:

    python examples_torch/spring_mass.py [--data-dir DIR]               # on the card
    python examples_torch/spring_mass.py [--data-dir DIR] --device cpu  # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from treeqp_tpu_torch import (IpmOpts, SdunesOpts, TdunesOpts, ipm_ms_solve,  # noqa: E402
                              ipm_solve, max_kkt_residual, merge_output,
                              scenario_data, scenario_duals_from_tree, scenario_output,
                              sdunes_solve, split_multistage, tdunes_ms_solve, tdunes_solve)
from treeqp_tpu_torch.interfaces.cli import resolve_device  # noqa: E402
from treeqp_tpu_torch.models import SPRING_MASS_DIR, spring_mass_qp  # noqa: E402


def main(device="cuda", data_dir=SPRING_MASS_DIR):
    """The six solves on ``device``, printed and asserted. Returns
    {name: TreeQPOut}."""
    dev = resolve_device(device, "spring_mass")
    qp, _ = spring_mass_qp(data_dir, device=dev)
    results = {}

    results["tdunes"] = tdunes_solve(qp, None, TdunesOpts(stage_solver="clipping", tol=1e-10,
                                                          max_iter=100))

    ms = split_multistage(qp)
    cro, cho, info = tdunes_ms_solve(
        ms, None, None, TdunesOpts(stage_solver="clipping", tol=1e-10, max_iter=100))
    results["tdunes_ms"] = merge_output(ms, cro, cho, info)

    results["ipm"] = ipm_solve(qp, IpmOpts(tol=1e-10, max_iter=40))

    cro, cho, info = ipm_ms_solve(ms, IpmOpts(tol=1e-10, max_iter=40))
    results["ipm_ms"] = merge_output(ms, cro, cho, info)

    # sdunes cold: it converges from the zero dual start on this instance
    # through the stall escalation (SdunesOpts.stall_boost_after); the
    # reference instead ships warm-start txt files (spring_mass.c:69-83)
    sqp = scenario_data(qp)
    sol, lam, mu, sinfo = sdunes_solve(sqp, None, None, SdunesOpts(tol=1e-8, max_iter=100))
    results["sdunes"] = scenario_output(sqp, sol, lam, mu, sinfo)

    # the warm-started variant (the reference's own usage pattern) must
    # still converge in a handful of iterations
    lam0, mu0 = scenario_duals_from_tree(sqp, results["ipm"].lam, results["ipm"])
    sol, lam, mu, sinfo = sdunes_solve(sqp, lam0, mu0, SdunesOpts(tol=1e-8, max_iter=100))
    results["sdunes_ws"] = scenario_output(sqp, sol, lam, mu, sinfo)

    ref = results["tdunes"].x
    for name, out in results.items():
        kkt = max_kkt_residual(qp, out)
        dx = float((out.x - ref).abs().max())
        st, it = out.info["status"], out.info["iter"]
        print(f"{name:10s} status={st} iter={it:3d} KKT={kkt:.2e} max|x - x_tdunes|={dx:.2e}")
        assert st == 0 and kkt < 1e-8 and dx < 1e-7
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--data-dir", default=SPRING_MASS_DIR,
                    help="the directory of data.c and x0.txt (the reference's "
                         "examples/spring_mass_utils)")
    args = ap.parse_args()
    main(args.device, args.data_dir)

#!/usr/bin/env python3
"""Where the time of the PyTorch port's interior-point solves goes, on one card.

    python3 scripts/prof_torch_ipm.py [--path cd|box|generic|generic_small] [--reps 5]

Solves at ``models.IPM_OPTS``: ``cd``, ``ipm_ms_solve`` on general_cd_bench's
ipm_ms tree (spring_mass_chain(4,4,4,20), 4437 nodes, a general row on every
node: the dense chain Riccati kernels, the crown through the plain f32
recursion); ``box``, ``ipm_ms_solve`` on the same tree box-only (ipm_bench's
ms_f32_pallas mode: chain and crown Riccati kernels); ``generic``,
``ipm_solve`` on that box-only tree whole (the crown Riccati kernels over
21 stages); ``generic_small``, ``ipm_solve`` on spring_mass_chain(4,4,3,7)
(341 nodes). Prints:

* cold and warm solve times (host clock around synchronized solves; median
  of --reps; the warm request shifts b by 1e-6 and starts from the cold
  solution), their iterations split into the f32-factored and the f64
  phase, and the Riccati kernel launches per f32 iteration;
* the host time of an f32 and of an f64 iteration: the f32 phase alone
  (the same solve stopped at max_iter = its f32 iterations) over its
  iterations, and the same cold solve with f64 factors throughout
  (``factor_dtype="same"``: every iteration the f64 phase's plain
  recursion) over its iterations;
* a torch.profiler trace of one cold solve: the device-busy share (summed
  device kernel time over wall time), the launches, and the kernels with
  the most device time.

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
    ap.add_argument("--path", choices=("cd", "box", "generic", "generic_small"),
                    default="cd")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_ipm: needs a CUDA device")
    import treeqp_tpu_torch  # noqa: F401
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.models import IPM_OPTS, general_cd, spring_mass_chain
    from treeqp_tpu_torch.ops import crown_riccati as crk
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    from treeqp_tpu_torch.solvers import ipm
    from treeqp_tpu_torch.solvers import ipm_multistage as ims
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm

    card = card_name()
    dev = torch.device("cuda", 0)
    opts = ipm.IpmOpts(**IPM_OPTS["box" if args.path == "box" else "cd"])
    if args.path == "cd":
        qp = general_cd("qpgen", device=dev)
    elif args.path == "generic_small":
        qp = spring_mass_chain(4, 4, 3, 7, device=dev)[0]
    else:
        qp = spring_mass_chain(4, 4, 4, 20, device=dev)[0]
    multistage = args.path in ("cd", "box")
    ms = tm.split_multistage(qp) if multistage else None
    kernels = (rk.ric_chain_factor, rk.ric_chain_bwd, rk.ric_chain_fwd,
               crk.crown_ric_factor, crk.crown_ric_solve)

    def solve(q, m, o, ws=None):
        """One synchronized solve: (TreeQPOut, the (crown, chain) pair)."""
        if m is None:
            out, pair = ipm.ipm_solve(q, o, ws=ws), None
        else:
            pair = ims.ipm_ms_solve(m, o, ws=ws)
            out = tm.merge_output(m, *pair)
        torch.cuda.synchronize()
        return out, pair

    for k in kernels:
        k.launches = 0
    out, pair = solve(qp, ms, opts)
    launches = {k.__name__: k.launches for k in kernels}
    info = out.info
    it, it32 = info["iter"], info["iter_f32"]
    print(f"{args.path}: {qp.topo.Nn} nodes, nx={qp.topo.nxm} nu={qp.topo.num}, "
          f"general rows: {max(qp.topo.nc) > 0}; cold solve {it} iterations ({it32} f32 + "
          f"{it - it32} f64), max res4 {float(info['res4'].max()):.3e}, kkt "
          f"{max_kkt_residual(qp, out):.3e} on {card}")
    print("  Riccati kernel launches per f32 iteration: "
          + ", ".join(f"{n} {c / max(it32, 1):.2f}" for n, c in launches.items()))

    db = 1e-6
    qp_w = qp.replace(b=qp.b + db)
    ms_w = None if ms is None else dataclasses.replace(
        ms, b=ms.b + db, crown=ms.crown.replace(b=ms.crown.b + db))
    ws = out if ms is None else pair[:2]
    out_w, _ = solve(qp_w, ms_w, opts, ws)
    t_cold = timed(torch, lambda: solve(qp, ms, opts), args.reps)
    t_warm = timed(torch, lambda: solve(qp_w, ms_w, opts, ws), args.reps)
    t_f32 = timed(torch, lambda: solve(qp, ms, dataclasses.replace(opts, max_iter=it32)),
                  args.reps)
    opts64 = dataclasses.replace(opts, factor_dtype="same")
    it64 = solve(qp, ms, opts64)[0].info["iter"]
    t_f64 = timed(torch, lambda: solve(qp, ms, opts64), args.reps)
    print(f"  cold solve {t_cold:.2f} ms, warm request (b + {db:g}) {t_warm:.2f} ms "
          f"({out_w.info['iter']} iterations, {out_w.info['iter_f32']} f32), median of "
          f"{args.reps}")
    print(f"  the f32 phase alone {t_f32:.2f} ms: {t_f32 / max(it32, 1):.2f} ms an f32 "
          f"iteration; with f64 factors throughout {t_f64:.2f} ms in {it64} iterations: "
          f"{t_f64 / max(it64, 1):.2f} ms an f64 iteration")
    profile_call(torch, lambda: solve(qp, ms, opts), card)


if __name__ == "__main__":
    main()

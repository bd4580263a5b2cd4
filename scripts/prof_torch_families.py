#!/usr/bin/env python3
"""The crane and the linear chain on the port's kernel paths, on one card.

    python3 scripts/prof_torch_families.py [--families crane,linear_chain] [--reps 3]

Runs ``chip_smoke.py``'s section 14 paths on each family at the reference
grid's largest tree (``chip_smoke.FAMILY_SHAPE``: md=4, Nr=4, Nh=50, 12117
nodes, 256 scenarios): ``tdunes_ms_solve`` at bench.py's options cold and
FAMILY_STEPS closed-loop steps warm (``chip_smoke.family_ms_loop``),
``ipm_ms_solve`` at ``models.IPM_OPTS["box"]`` and ``sdunes_solve`` at
``models.SDUNES_OPTS`` warm from the IPM's duals, each certified (status 0,
the port's KKT < 1e-8). For each path: iterations (coarse / final), the
host milliseconds of each solve, the kernel launches of every wrapper,
the median of --reps more synchronized solves of the cold (and the last
warm) request, and one solve under torch.profiler (device kernel time,
launches, and the device-busy share: kernel time over wall time, profiler
on). The last line is a JSON list of the rows. Needs CUDA; imports nothing
of JAX.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (BENCH_OPTS, FAMILIES, FAMILY_STEPS, family_ipm,  # noqa: E402
                        family_model, family_ms_loop, family_sdunes, kernel_wrappers,
                        profiled)
from prof_common import card as card_name, timed  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_families: needs a CUDA device")
    import treeqp_tpu_torch  # noqa: F401
    from treeqp_tpu_torch.models import IPM_OPTS, SDUNES_OPTS
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.solvers import ipm
    from treeqp_tpu_torch.solvers import ipm_multistage as ims
    from treeqp_tpu_torch.solvers import sdunes as sd
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm

    card = card_name()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    wrappers = kernel_wrappers()
    optsb = td.TdunesOpts(**BENCH_OPTS)
    opts_ipm = ipm.IpmOpts(**IPM_OPTS["box"])
    opts_sd = sd.SdunesOpts(**SDUNES_OPTS)
    rows = []

    def counted(fn):
        for f in wrappers.values():
            f.launches = 0
        torch.cuda.synchronize()
        res = fn()
        torch.cuda.synchronize()
        return res, {n: f.launches for n, f in wrappers.items() if f.launches}

    def report(fam, what, iters, solve_ms, launches, solve):
        med = timed(torch, solve, args.reps)
        wall, dev_ms, n = profiled(torch, solve)
        row = dict(family=fam, path=what, iter=iters, ms=solve_ms, median_ms=med,
                   profiled_wall_ms=wall, device_ms=dev_ms, device_launches=n,
                   busy=dev_ms / wall, launches=launches)
        rows.append(row)
        print(f"{fam} {what}: iter {iters}, ms {[round(t, 2) for t in solve_ms]}, median of "
              f"{args.reps} more {med:.2f} ms; profiled: wall {wall:.2f} ms, device "
              f"{dev_ms:.3f} ms in {n} launches, busy {100 * row['busy']:.1f}%; wrapper "
              f"launches {launches} on {card}", flush=True)

    for fam in args.families.split(","):
        model = family_model(fam)
        ms_cpu = tm.split_multistage(model.qp)
        qp, ms = model.qp.to(dev), ms_cpu.to(dev)
        m = ms.meta
        print(f"{fam}: {qp.topo.Nn} nodes, S={m.S} L={m.L} "
              f"nx={m.nx} nu={m.nu}, crown {m.crown_topo.Nn} nodes", flush=True)
        loop, launches = counted(lambda: family_ms_loop(
            torch, model, qp, ms, optsb, FAMILY_STEPS, f"{fam} tdunes_ms"))
        cold, last = loop[0], loop[-1]
        report(fam, "tdunes_ms cold + closed loop",
               [(r["iter_f32"], r["iter"]) for r in loop], [r["ms"] for r in loop], launches,
               lambda: tm.tdunes_ms_solve(ms, None, None, optsb))
        report(fam, "tdunes_ms last warm step", [(last["iter_f32"], last["iter"])],
               [last["ms"]], {}, lambda: tm.tdunes_ms_solve(*last["args"], optsb))
        (out_i, it_i, kkt_i, t_i), launches = counted(
            lambda: family_ipm(torch, qp, ms, opts_ipm, f"{fam} ipm_ms"))
        report(fam, "ipm_ms", [it_i], [t_i], launches, lambda: ims.ipm_ms_solve(ms, opts_ipm))
        (out_s, it_s, kkt_s, t_s), launches = counted(
            lambda: family_sdunes(torch, qp, out_i, opts_sd, f"{fam} sdunes"))
        sqp = sd.scenario_data(qp)
        lam0, mu0 = sd.scenario_duals_from_tree(sqp, out_i.lam, out_i)
        report(fam, "sdunes warm from the IPM", [it_s], [t_s], launches,
               lambda: sd.sdunes_solve(sqp, lam0, mu0, opts_sd))
        gaps = {f"{a}-{b} {f}": float((getattr(oa, f) - getattr(ob, f)).abs().max())
                for (a, oa), (b, ob) in ((("tdunes_ms", cold["out"]), ("ipm_ms", out_i)),
                                         (("tdunes_ms", cold["out"]), ("sdunes", out_s)))
                for f in ("x", "u")}
        kkts = ", ".join(f"{r['kkt']:.2e}" for r in loop)
        print(f"{fam}: KKT tdunes_ms {kkts}, ipm_ms {kkt_i:.2e}, "
              f"sdunes {kkt_s:.2e}; " + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()),
              flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The port's solvers at the JAX package's default options, on one card.

    python3 scripts/prof_torch_default_opts.py [--reps 3] [--paths G,B,P,K]

Times each path of ``chip_smoke.py``'s section 11 and, for comparison, the
kernel path of the same solve:

* G: ``tdunes_solve`` on the general C/D trees of general_cd_bench
  (spring_mass_chain(4,4,Nr,20) with a row on every node, stage solver
  qpgen, or on every third node, mixed; Nr = --cd-nr, 3 by default: 1173
  nodes, as chip_smoke.py's G path) at its CPU options
  (``models.GENERAL_CD_CPU_OPTS``: f64 factors, the plain tree Cholesky
  with the on-the-fly shift), cold and warm (b + 1e-6 from the cold duals
  and working sets);
* B: ``tdunes_ms_solve`` on quadcopter(4,4,20) at bench.py's options with
  ``reg_type="on_the_fly"``, cold and warm (the root's bound rows scaled
  by 1.02 from the cold duals);
* P: the portable backend (``chain_backend="xla"``, no kernel):
  ``tdunes_solve`` on quadcopter(4,4,20) pruned to 128 scenarios at
  generic_bench.speed_opts(on_tpu=False), ``tdunes_ms_solve`` on
  spring_mass_chain(4,4,5,20) at scen1024_bench's CPU options, and
  ``sdunes_solve`` on the box-only spring_mass_chain(4,4,4,20) at
  sdunes_bench._sdunes_opts(on_tpu=False), cold;
* K: the kernel paths of the same solves: G at ``models.GENERAL_CD_OPTS``,
  B at bench.py's options (``reg_type="always"``), and P's three at their
  benches' card options (``models.GENERIC_SPEED_OPTS``, scen1024_bench's
  and ``models.SDUNES_OPTS``).

For each solve: its iterations (coarse), the port's KKT residual, the
median host-clock time of --reps synchronized solves after a warm-up, and
a torch.profiler trace of one solve (device kernel time, launches and the
device-busy share: kernel time over wall time, profiler on). The last
line is a JSON list of the rows. Needs CUDA; imports nothing of JAX.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (BENCH_OPTS, CD_DEF_NR, GENERIC_CPU_OPTS,  # noqa: E402
                        SCEN1024, SCEN1024_CPU_OPTS, SDUNES_CPU_OPTS, TOL)
from prof_common import card as card_name, timed  # noqa: E402


def profiled(torch, fn):
    """(wall ms, device kernel ms, kernel launches) of one synchronized fn()
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, sum(e.time_range.elapsed_us() for e in kern) / 1e3, len(kern)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--paths", default="G,B,P,K")
    ap.add_argument("--cd-nr", type=int, default=CD_DEF_NR,
                    help="the general C/D trees' Nr (4: general_cd_bench's 4437 nodes)")
    args = ap.parse_args()
    want = set(args.paths.split(","))

    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_default_opts: needs a CUDA device")
    import treeqp_tpu_torch  # noqa: F401
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.models import (GENERAL_CD_CPU_OPTS, GENERAL_CD_OPTS,
                                         GENERIC_SPEED_OPTS, SDUNES_OPTS, general_cd,
                                         pruned, quadcopter, spring_mass_chain)
    from treeqp_tpu_torch.solvers import sdunes as sd
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm

    card = card_name()
    dev = torch.device("cuda", 0)
    scen1024_tpu = {**BENCH_OPTS, "max_iter": 150}  # scen1024_bench.py:43-50, on_tpu=True
    rows = []

    def run(path, what, solve, certify):
        """Warm-up and certification (a solve that misses status 0 or KKT
        < 1e-8 is reported, with its status, and timed all the same), the
        median time and one profiled solve."""
        info, kkt = certify(solve())
        ms = timed(torch, solve, args.reps)
        wall, dev_ms, launches = profiled(torch, solve)
        row = dict(path=path, what=what, status=info["status"], iter=info["iter"],
                   iter_f32=info.get("iter_f32", 0), kkt=kkt, ms=ms, profiled_wall_ms=wall,
                   device_ms=dev_ms, launches=launches, busy=dev_ms / wall)
        rows.append(row)
        if info["status"] != td.TDUNES_OPTIMAL or not kkt < TOL:
            print(f"{path} {what}: NOT CERTIFIED, status {info['status']}, kkt {kkt:.3e}")
        print(f"{path} {what}: iter {row['iter']} ({row['iter_f32']} coarse), kkt {kkt:.2e}, "
              f"{ms:.2f} ms (median of {args.reps}); profiled: wall {wall:.2f} ms, device "
              f"{dev_ms:.3f} ms in {launches} launches, busy {100 * row['busy']:.1f}% on "
              f"{card}", flush=True)

    def tree(q):
        return lambda out: (out.info, max_kkt_residual(q, out))

    def multistage(ms, q):
        def certify(res):
            return res[2], max_kkt_residual(q, tm.merge_output(ms, *res))
        return certify

    # B and the bench path
    qh = quadcopter(4, 4, 20, device="cpu").qp
    msh = tm.split_multistage(qh).to(dev)
    qh = qh.to(dev)
    qhw = qh.replace(xmin=qh.xmin.clone(), xmax=qh.xmax.clone())
    qhw.xmin[0] *= 1.02
    qhw.xmax[0] *= 1.02
    mshw = dataclasses.replace(msh, crown=msh.crown.replace(xmin=qhw.xmin[:msh.crown.topo.Nn],
                                                            xmax=qhw.xmax[:msh.crown.topo.Nn]))
    for path, reg in (("B", "on_the_fly"), ("K", "always")):
        if path not in want:
            continue
        o = td.TdunesOpts(**{**BENCH_OPTS, "reg_type": reg})
        run(path, f"bench path reg_type {reg} cold",
            lambda: tm.tdunes_ms_solve(msh, None, None, o), multistage(msh, qh))
        cro, cho, _ = tm.tdunes_ms_solve(msh, None, None, o)
        run(path, f"bench path reg_type {reg} warm",
            lambda: tm.tdunes_ms_solve(mshw, cro["lam"], cho["lam"], o), multistage(mshw, qhw))
    # P and the kernel paths of the same solves
    qg = pruned(quadcopter(4, 4, 20, device="cpu").qp, 128).to(dev)
    q1k_cpu = spring_mass_chain(*SCEN1024, device="cpu")[0]
    q1k, ms1k = q1k_cpu.to(dev), tm.split_multistage(q1k_cpu).to(dev)
    qb = spring_mass_chain(4, 4, 4, 20, device=dev)[0]
    sqp = sd.scenario_data(qb)

    def sdunes(res):
        sol, lam, mu, info = res
        return info, max_kkt_residual(qb, sd.scenario_output(sqp, sol, lam, mu, info))

    for path, og, o1k, osd in (("P", GENERIC_CPU_OPTS, SCEN1024_CPU_OPTS, SDUNES_CPU_OPTS),
                               ("K", GENERIC_SPEED_OPTS, scen1024_tpu, SDUNES_OPTS)):
        if path not in want:
            continue
        og, o1k, osd = td.TdunesOpts(**og), td.TdunesOpts(**o1k), sd.SdunesOpts(**osd)
        run(path, "tdunes_solve pruned quadcopter cold", lambda: td.tdunes_solve(qg, None, og),
            tree(qg))
        run(path, "tdunes_ms_solve scen1024 cold",
            lambda: tm.tdunes_ms_solve(ms1k, None, None, o1k), multistage(ms1k, q1k))
        run(path, "sdunes_solve box-only cold", lambda: sd.sdunes_solve(sqp, None, None, osd),
            sdunes)
    # G and its kernel path
    for mode in ("qpgen", "mixed"):
        q = general_cd(mode, Nr=args.cd_nr, device=dev)
        for path, base in (("G", GENERAL_CD_CPU_OPTS), ("K", GENERAL_CD_OPTS)):
            if path not in want:
                continue
            o = td.TdunesOpts(**{**base, "stage_solver": mode})
            run(path, f"general C/D {mode} cold", lambda: td.tdunes_solve(q, None, o), tree(q))
            cold = td.tdunes_solve(q, None, o)
            qw = q.replace(b=q.b + 1e-6)
            run(path, f"general C/D {mode} warm",
                lambda: td.tdunes_solve(qw, cold.lam, o, stage_ws=cold.info["qpgen_ws"]),
                tree(qw))
    print(json.dumps(dict(card=card, rows=rows)))


if __name__ == "__main__":
    main()

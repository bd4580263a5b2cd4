#!/usr/bin/env python3
"""The crane's multistage dual Newton at the one- and two-phase options,
in both packages, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/depth_parity_crane.py [--shapes 3,2,20 4,2,20 4,2,12]
        [--max-iter 30]

Builds ``crane(md, Nr, Nh)`` in each package and solves it with
``tdunes_ms_solve`` from zero duals at the one-phase options
(``chip_smoke.SLICE_OPTS``: an f64 loop with f32 factors, two refinement
steps, reg_type "always" 1e-6) and at the two-phase options
(``chip_smoke.TWO_PHASE_OPTS``: a coarse f32 phase to 1e-4 first), the
JAX side on its XLA chain backend and the port on its plain twins; and the
port also at bench.py's options (``chip_smoke.BENCH_OPTS``: the
high-precision phase after the coarse one). Prints each solve's status,
iterations (coarse) and stationarity, and the port's largest crown dual.
On some of these trees the two-phase solve of both packages stops at
max_iter after a coarse step lands on a point where the regularized dual
Hessian is nearly singular (huge directions and crown duals, line
searches that accept nothing), while the one-phase solve converges.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

from benchmarks import models as jmodels  # noqa: E402
from chip_smoke import BENCH_OPTS, SLICE_OPTS, TWO_PHASE_OPTS  # noqa: E402
from treeqp_tpu.solvers import tdunes as jtd  # noqa: E402
from treeqp_tpu.solvers import tdunes_multistage as jtm  # noqa: E402
from treeqp_tpu_torch import models  # noqa: E402
from treeqp_tpu_torch.solvers import tdunes as td  # noqa: E402
from treeqp_tpu_torch.solvers import tdunes_multistage as tm  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+", default=["3,2,20", "4,2,20", "4,2,12"])
    ap.add_argument("--max-iter", type=int, default=30)
    args = ap.parse_args()
    torch.set_num_threads(4)
    for shape in args.shapes:
        md, Nr, Nh = map(int, shape.split(","))
        ms = tm.split_multistage(models.crane(md, Nr, Nh, device="cpu").qp)
        msj = jtm.split_multistage(jmodels.crane(md, Nr, Nh).qp)
        for name, o in (("one-phase", SLICE_OPTS), ("two-phase", TWO_PHASE_OPTS),
                        ("bench", BENCH_OPTS)):
            o = {**o, "max_iter": args.max_iter}
            t0 = time.perf_counter()
            cro, _, info = tm.tdunes_ms_solve(ms, None, None, td.TdunesOpts(**o))
            line = (f"crane({md},{Nr},{Nh}) {name}: port status {info['status']} iter "
                    f"{info['iter']} ({info['iter_f32']} coarse) error {info['error']:.3e} "
                    f"max|lam_crown| {float(cro['lam'].abs().max()):.3e} "
                    f"({time.perf_counter() - t0:.1f} s)")
            if name != "bench":
                t0 = time.perf_counter()
                ij = jtm.tdunes_ms_solve(msj, None, None,
                                         jtd.TdunesOpts(**{**o, "chain_backend": "xla"}))[2]
                line += (f"; JAX status {int(ij['status'])} iter {int(ij['iter'])} "
                         f"({int(ij['iter_f32'])} coarse) error {float(ij['error']):.3e} "
                         f"({time.perf_counter() - t0:.1f} s)")
            print(line, flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Iteration counts of the JAX package's own cold ``sdunes_solve`` with its
two chain backends, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/depth_parity_sdunes.py [--nr 4] [--backends xla pallas]

Solves the box-only ``spring_mass_chain(4, 4, Nr, 20)`` (sdunes_bench's
tree at Nr = 4: 256 scenarios) cold at sdunes_bench's options
(``treeqp_tpu_torch.models.SDUNES_OPTS``, copied here so that this script
does not import the port), once per backend: ``chain_backend="pallas"``
(the Pallas kernels in interpret mode: the banded per-scenario factor and
solve and the Jay cyclic reduction with floored pivots) and ``"xla"`` (the
scan sweeps, the banded blocks shifted a second time, the Jay blocks
factored by ``jnp.linalg.cholesky``). Prints each run's iterations (both
phases), status, stationarity error and time. If the two backends part the
way the port (which follows the Pallas path) and JAX's XLA path do, the
spread is the backend split and not the port's.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from benchmarks import models as jmodels  # noqa: E402
from treeqp_tpu.solvers import sdunes as jsd  # noqa: E402

SDUNES_OPTS = dict(tol=1e-8, max_iter=150, factor_dtype="float32", refine_steps=2,
                   f32_phase_tol=1e-4, chain_backend="pallas", reg_type="always",
                   reg_value=1e-6)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nr", type=int, default=4)
    ap.add_argument("--backends", nargs="+", default=("xla", "pallas"),
                    choices=("xla", "pallas"))
    a = ap.parse_args()
    qp = jmodels.spring_mass_chain(nm=4, md=4, Nr=a.nr, Nh=20)[0]
    sqp = jsd.scenario_data(qp)
    print(f"spring_mass_chain(4,4,{a.nr},20): {qp.topo.Nn} nodes, "
          f"{sqp.meta.Ns} scenarios", flush=True)
    for backend in a.backends:
        opts = jsd.SdunesOpts(**{**SDUNES_OPTS, "chain_backend": backend})
        t0 = time.perf_counter()
        _, lam, _, info = jsd.sdunes_solve(sqp, None, None, opts)
        jax.block_until_ready(lam)
        t = time.perf_counter() - t0
        print(f"chain_backend={backend}: iter {int(info['iter'])} (both phases), "
              f"status {int(info['status'])}, error {float(info['error']):.3e}, "
              f"{t:.1f} s on the CPU", flush=True)


if __name__ == "__main__":
    main()

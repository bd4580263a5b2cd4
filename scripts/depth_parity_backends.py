#!/usr/bin/env python3
"""Iteration counts of the JAX package's own ``tdunes_solve`` on a general
C/D tree with its two chain backends, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/depth_parity_backends.py [--dims 2 3 3 12]

Solves ``general_cd("qpgen", nm, md, Nr, Nh)`` (general_cd_bench's tree
with a row on every node) at general_cd_bench's two-phase tdunes options
(``treeqp_tpu_torch.models.GENERAL_CD_OPTS``, copied here so that this
script does not import the port) twice: with ``chain_backend="pallas"``
(the Pallas kernels in interpret mode) and with ``"xla"``. Prints each
run's iterations (coarse + final), status, stationarity, KKT and time.
If the two backends part by a count like the port's against JAX's XLA
path, the spread belongs to the algorithm under f32 factors.
"""

import argparse
import os
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from benchmarks import general_cd_bench as gcb  # noqa: E402
from treeqp_tpu.core.kkt import max_kkt_residual  # noqa: E402
from treeqp_tpu.solvers import tdunes as jtd  # noqa: E402

GENERAL_CD_OPTS = dict(stage_solver="qpgen", tol=2.5e-9, max_iter=150,
                       factor_dtype="float32", refine_steps=1, refine_safeguard=False,
                       qpgen_factor_dtype="float32", qpgen_iters=100,
                       chain_backend="pallas", reg_type="always", reg_value=1e-6,
                       f32_phase_tol=1e-4, f32_patience=3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, nargs=4, default=(2, 3, 3, 12),
                    metavar=("NM", "MD", "NR", "NH"))
    a = ap.parse_args()
    nm, md, Nr, Nh = a.dims
    with mock.patch.multiple(gcb, NM=nm, MD=md, NR=Nr, NH=Nh):
        qp = gcb.build("tdunes_qpgen")
    print(f"general_cd('qpgen', {nm}, {md}, {Nr}, {Nh}): {qp.topo.Nn} nodes", flush=True)
    for backend in ("pallas", "xla"):
        opts = jtd.TdunesOpts(**{**GENERAL_CD_OPTS, "chain_backend": backend})
        t0 = time.perf_counter()
        out = jtd.tdunes_solve(qp, None, opts)
        t = time.perf_counter() - t0
        info = out.info
        print(f"chain_backend={backend}: iter {int(info['iter'])} (both phases), "
              f"status {int(info['status'])}, error {float(info['error']):.3e}, "
              f"kkt {float(max_kkt_residual(qp, out)):.3e}, {t:.1f} s on the CPU", flush=True)


if __name__ == "__main__":
    main()

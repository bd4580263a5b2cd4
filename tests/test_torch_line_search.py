"""PyTorch port, the two-phase solve where the Armijo search rejects steps:
quadcopter(2,2,6) with its initial state scaled up, so that the coarse
phase's batched search (ls_batch forced to 4) and its sequential fallback
and the f64 phase's sequential search all backtrack. The port's plain path
against the JAX package (Pallas in interpret mode), same options, same
data."""

import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.solvers import tdunes_multistage as jtm

from test_torch_tdunes_ms import LAM_TOL, SLICE, U_TOL, X_TOL
from treeqp_tpu_torch import convert
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)


# scale 2.0: the coarse phase's second step is accepted only after the
# batch and 36 sequential trials; scale 1.5: its third step at the batch's
# last candidate (the per-kernel loop, with two-norm termination)
@pytest.mark.parametrize("scale,termination", [(2.0, "infnorm"), (1.5, "twonorm")])
def test_two_phase_with_backtracking_matches_jax(scale, termination):
    opts = dict(SLICE, f32_phase_tol=1e-4, termination=termination)
    qp_j = jmodels.quadcopter(2, 2, 6).qp
    qp_j = qp_j.replace(xmin=qp_j.xmin.at[0].multiply(scale),
                        xmax=qp_j.xmax.at[0].multiply(scale))
    ms_j = jtm.split_multistage(qp_j)
    cro, cho, info_j = jtm.tdunes_ms_solve(ms_j, None, None, jtd.TdunesOpts(**opts))
    out_j = jtm.merge_output(ms_j, cro, cho, info_j)
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    ms = tm.split_multistage(qp)
    cro, cho, info = tm.tdunes_ms_solve(ms, None, None, td.TdunesOpts(**opts))
    out = tm.merge_output(ms, cro, cho, info)
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert abs(int(info_j["iter"]) - info["iter"]) <= 1
    assert abs(int(info_j["iter_f32"]) - info["iter_f32"]) <= 1
    assert float(jax_kkt(qp_j, out_j)) < 1e-8 and max_kkt_residual(qp, out) < 1e-8
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    assert np.max(np.abs(a["x"] - b["x"])) <= X_TOL
    assert np.max(np.abs(a["u"] - b["u"])) <= U_TOL
    assert np.max(np.abs(a["lam"] - b["lam"])) <= LAM_TOL

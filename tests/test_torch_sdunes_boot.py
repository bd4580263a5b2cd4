"""PyTorch port, sdunes whole solves against the JAX package's
``chain_backend="xla"`` path on spring_mass_chain(2, 2, 3, 8): the
high-precision final phase (``df64_phase=True``: native f64 in the port,
double-float in JAX) cold, and sdunes_bench's sdunes_boot chain (a
``tdunes_ms_solve`` bootstrap at tol 1e-4, ``merge_output``,
``scenario_duals_from_tree`` with the full tree solution, then
``sdunes_solve``) on the bench's first perturbed request, with and
without the high-precision phase. Each JAX solve takes 5-20 s on the CPU.

The band: JAX's XLA path adds the Levenberg-Marquardt shift to the
equilibrated banded blocks a second time (``reg_type="always"``), where
its Pallas path and the port add none, and its Jay solve factors with
``jnp.linalg.cholesky`` instead of the floored pivots. So the f32 factors
differ and the trajectories are not the same: iterations within one, x
and u within 1e-7, lam within 1e-6 and KKT below 1e-8 at the end; the
bootstrap (tol 1e-4) within one iteration and 1e-4 in x and u.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.solvers import sdunes as jsd
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.solvers import tdunes_multistage as jtm

from treeqp_tpu_torch import convert, models
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.solvers import sdunes as sd
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

KKT = 1e-8
GAP = dict(x=1e-7, u=1e-7, lam=1e-6)
BOOT_GAP = 1e-4
FAC = 1.0 + 0.02 * math.sin(0.0 + 1.7 * 1.0)  # sdunes_bench's request k = 0, seed 0


def gaps(out, out_j):
    return {f: float(np.abs(getattr(out, f).numpy() - np.asarray(getattr(out_j, f))).max())
            for f in GAP}


@functools.lru_cache(maxsize=None)
def instance(fac=1.0):
    """The tree QP with its root's state bounds scaled by ``fac``, in both
    packages, with its scenario data and crown + chains split."""
    qp_j, _ = jmodels.spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    arrays = {f: np.array(v) for f, v in convert.qp_arrays(qp_j).items()}
    for f in ("xmin", "xmax"):
        arrays[f][0] *= fac
    qp_j = qp_j.replace(xmin=jnp.asarray(arrays["xmin"]), xmax=jnp.asarray(arrays["xmax"]))
    qp = convert.qp_from_numpy(arrays, convert.topo_from(qp_j.topo), device="cpu")
    return (qp_j, qp, jsd.scenario_data(qp_j), sd.scenario_data(qp),
            jtm.split_multistage(qp_j), tm.split_multistage(qp))


def check_end(qp_j, qp, got, ref):
    """Both solves OPTIMAL below tol, their ends within the band, KKT below
    1e-8 from both oracles."""
    (out, info), (out_j, info_j) = got, ref
    assert info["status"] == 0 and int(info_j["status"]) == 0
    assert info["error"] < KKT and float(info_j["error"]) < KKT
    assert abs(info["iter"] - int(info_j["iter"])) <= 1, (info, info_j)
    for f, gap in gaps(out, out_j).items():
        assert gap <= GAP[f], (f, gap)
    assert max_kkt_residual(qp, out) < KKT and float(jax_kkt(qp_j, out_j)) < KKT


def test_df64_phase_matches_jax():
    """The cold solve with the coarse f32 phase, then the high-precision
    phase."""
    qp_j, qp, sqp_j, sqp, _, _ = instance()
    opts = {**models.SDUNES_OPTS, "df64_phase": True}
    sol_j, lam_j, mu_j, info_j = jsd.sdunes_solve(
        sqp_j, None, None, jsd.SdunesOpts(**{**opts, "chain_backend": "xla"}))
    sol, lam, mu, info = sd.sdunes_solve(sqp, None, None, sd.SdunesOpts(**opts))
    assert 0 < info["iter_f32"] < info["iter"]
    check_end(qp_j, qp, (sd.scenario_output(sqp, sol, lam, mu, info), info),
              (jsd.scenario_output(sqp_j, sol_j, lam_j, mu_j, info_j), info_j))


@functools.lru_cache(maxsize=None)
def bootstraps():
    """Both packages' bootstrap of the perturbed request: tdunes_ms_solve at
    tol 1e-4 (SDUNES_BOOT_OPTS), the tree solution, the scenario duals."""
    qp_j, qp, sqp_j, sqp, ms_j, ms = instance(FAC)
    bo = models.SDUNES_BOOT_OPTS
    cr_j, ch_j, info_j = jtm.tdunes_ms_solve(
        ms_j, None, None, jtd.TdunesOpts(**{**bo, "chain_backend": "xla"}))
    boot_j = jtm.merge_output(ms_j, cr_j, ch_j, info_j)
    cr, ch, info = tm.tdunes_ms_solve(ms, None, None, td.TdunesOpts(**bo))
    boot = tm.merge_output(ms, cr, ch, info)
    return ((boot, info, sd.scenario_duals_from_tree(sqp, None, boot)),
            (boot_j, info_j, jsd.scenario_duals_from_tree(sqp_j, None, boot_j)))


@pytest.mark.parametrize("df64_phase", [False, True])
def test_bootstrapped_solve_matches_jax(df64_phase):
    qp_j, qp, sqp_j, sqp, _, _ = instance(FAC)
    (boot, binfo, (lam0, mu0)), (boot_j, binfo_j, (lam0_j, mu0_j)) = bootstraps()
    assert binfo["status"] == 0 and binfo["error"] < 1e-4
    assert abs(binfo["iter"] - int(binfo_j["iter"])) <= 1
    for f in ("x", "u"):
        assert gaps(boot, boot_j)[f] <= BOOT_GAP
    opts = {**models.SDUNES_OPTS, "df64_phase": df64_phase}
    sol_j, lam_j, mu_j, info_j = jsd.sdunes_solve(
        sqp_j, lam0_j, mu0_j, jsd.SdunesOpts(**{**opts, "chain_backend": "xla"}))
    sol, lam, mu, info = sd.sdunes_solve(sqp, lam0, mu0, sd.SdunesOpts(**opts))
    assert info["iter"] <= 1 and int(info_j["iter"]) <= 1  # the bench's one-step handover
    check_end(qp_j, qp, (sd.scenario_output(sqp, sol, lam, mu, info), info),
              (jsd.scenario_output(sqp_j, sol_j, lam_j, mu_j, info_j), info_j))

"""PyTorch port, the generic-tree solver: ``tdunes_solve`` against the JAX
package's ``tdunes_solve`` at generic_bench's speed options on the
asymmetric thesis-class tree (the crown path) and on quadcopter(2,2,6)
pruned to 3 scenarios (the split path), two-phase and one-phase, cold and
warm, and with the options the slice also runs; the scenario-tree pruning;
the options outside the slice; the data entry points' device default.

The JAX side runs ``chain_backend="xla"`` (the same math with f32 factors,
without the interpret-mode Pallas kernels), as the kernels are held
against the Pallas kernels in test_torch_generic_kernels.py and
test_torch_generic_split.py."""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.utils.pruning import prune_scenario_tree as jprune

from test_torch_generic_kernels import SPEED, jax_qp, port_qp
from treeqp_tpu_torch import convert, models, tdunes_solve
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.core.qp_data import QP_FIELDS
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.utils.pruning import prune_scenario_tree

torch.set_num_threads(1)

X_TOL, U_TOL, LAM_TOL = 1e-7, 1e-7, 1e-6
PHASES = {"two_phase": {}, "one_phase": {"f32_phase_tol": 0.0}}
WARM_FAC = 1.02  # the warm request scales the root's bound rows


def perturbed(qp, fac):
    """The instance with the root's bound rows scaled by ``fac`` (the
    pinned initial state of the quadcopter): a next MPC step."""
    xmin, xmax = np.array(qp.xmin), np.array(qp.xmax)
    xmin[0] *= fac
    xmax[0] *= fac
    return xmin, xmax


def jax_instance(name, warm):
    qp_j = jax_qp(name)
    if not warm:
        return qp_j
    xmin, xmax = perturbed(qp_j, WARM_FAC)
    return qp_j.replace(xmin=jnp.asarray(xmin), xmax=jnp.asarray(xmax))


def port_instance(name, warm):
    qp = port_qp(name)
    if not warm:
        return qp
    xmin, xmax = perturbed(qp, WARM_FAC)
    return qp.replace(xmin=torch.tensor(xmin), xmax=torch.tensor(xmax))


@functools.lru_cache(maxsize=None)
def solve_both(name, phase, warm=False, **over):
    """JAX (XLA tree Cholesky) and port solves of one request; the warm
    request starts both from JAX's cold solution."""
    opts = {**SPEED, **PHASES[phase], **over}
    lam0 = solve_both(name, phase)[1].lam if warm else None
    qp_j = jax_instance(name, warm)
    out_j = jtd.tdunes_solve(qp_j, lam0, jtd.TdunesOpts(**{**opts, "chain_backend": "xla"}))
    qp = port_instance(name, warm)
    lam0_t = None if lam0 is None else torch.tensor(np.asarray(lam0))
    out = tdunes_solve(qp, lam0_t, td.TdunesOpts(**opts))
    return qp_j, out_j, qp, out


def check_agree(name, phase, warm=False, **over):
    qp_j, out_j, qp, out = solve_both(name, phase, warm, **over)
    info_j, info = out_j.info, out.info
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert abs(int(info_j["iter"]) - info["iter"]) <= 1
    assert info["error"] < SPEED["tol"]
    kkt_j = float(jax_kkt(qp_j, out_j))
    kkt = max_kkt_residual(qp, out)
    assert kkt_j < 1e-8 and kkt < 1e-8
    # the two oracles agree on the same solution
    out_jt = out.replace(**{f: torch.tensor(v) for f, v in
                            convert.out_to_numpy(out_j).items()})
    assert abs(max_kkt_residual(qp, out_jt) - kkt_j) <= 1e-12
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    assert np.max(np.abs(a["x"] - b["x"])) <= X_TOL
    assert np.max(np.abs(a["u"] - b["u"])) <= U_TOL
    assert np.max(np.abs(a["lam"] - b["lam"])) <= LAM_TOL
    return info


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("phase", sorted(PHASES))
@pytest.mark.parametrize("name", ["asym", "pruned"])
def test_generic_solve_matches_jax(name, phase, warm):
    info = check_agree(name, phase, warm)
    if phase == "two_phase" and not warm:
        assert info["iter_f32"] >= 1
    if phase == "one_phase":
        assert info["iter_f32"] == 0


@pytest.mark.parametrize("over", [
    dict(refine_safeguard=True), dict(ls_batch=4), dict(termination="twonorm"),
    dict(termination="sumsquared")],
    ids=["safeguard", "ls_batch", "twonorm", "sumsquared"])
def test_generic_options_match_jax(over):
    """The options the slice also runs, on the split path."""
    check_agree("pruned", "two_phase", **over)


def test_warm_start_from_the_solution_takes_no_step():
    qp = port_qp("pruned")
    opts = td.TdunesOpts(**{**SPEED, **PHASES["one_phase"]})
    out = tdunes_solve(qp, None, opts)
    out2 = tdunes_solve(qp, out.lam, opts)
    assert out2.info["status"] == 0 and out2.info["iter"] == 0
    assert torch.equal(out2.lam, out.lam)


# ---------------------------------------------------------------------------
# pruning


@pytest.mark.parametrize("kw", [
    dict(nscenmax=3), dict(dirichlet=True, nscenmax=3), dict(dirichlet=True, pcov=0.5)],
    ids=["uniform", "dirichlet", "pcov"])
def test_pruning_matches_jax(kw):
    """prune_scenario_tree: the same topology, kept nodes and data as the
    JAX package's, with uniform and Dirichlet leaf probabilities."""
    kw = dict(kw)
    if kw.pop("dirichlet", False):
        kw["leaf_probs"] = np.random.default_rng(0).dirichlet(np.ones(4))
    qp_j = jmodels.quadcopter(2, 2, 6).qp
    pj, kept_j = jprune(qp_j, **kw)
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    pt, kept = prune_scenario_tree(qp, **kw)
    np.testing.assert_array_equal(kept, kept_j)
    assert pt.topo == convert.topo_from(pj.topo)
    a, b = convert.qp_arrays(pt), convert.qp_arrays(pj)
    for f in QP_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


# ---------------------------------------------------------------------------
# options outside the slice, and the device default


@pytest.mark.parametrize("over", [
    dict(chain_backend="xla"), dict(reg_type="on_the_fly"), dict(factor_dtype="same"),
    dict(record_history=True), dict(axis_name="scen"),
    pytest.param(dict(stage_solver="qpgen"), id="stage_solver")])
def test_options_outside_the_slice_raise(over):
    """The options outside slice 4. axis_name is not read by the generic
    solver, as in the JAX package: the solve with it is the solve without
    it, bit for bit. chain_backend="xla", reg_type="on_the_fly" and factor_dtype="same" (the
    JAX package's defaults) take the plain tree Cholesky, record_history
    the kernels: each solves the two-phase request and agrees with the JAX
    package's solve in iterations, x, u and lambda, certified by both
    oracles; the history records the same iterations and line searches as
    JAX's. stage_solver, outside slice 4, is ported since slice 5 and
    solves (the general stage QPs on a tree with bounds only, certified by
    the oracle)."""
    qp = port_qp("pruned")
    opts = td.TdunesOpts(**{**SPEED, **over})
    if "axis_name" in over:
        out = tdunes_solve(qp, None, opts)
        ref = tdunes_solve(qp, None, td.TdunesOpts(**SPEED))
        assert out.info["status"] == 0 and out.info["iter"] == ref.info["iter"]
        assert torch.equal(out.x, ref.x) and torch.equal(out.lam, ref.lam)
        return
    if "stage_solver" in over:
        out = tdunes_solve(qp, None, opts)
        assert out.info["status"] == 0 and max_kkt_residual(qp, out) < 1e-8
        return
    info = check_agree("pruned", "two_phase", **over)
    info_j = solve_both("pruned", "two_phase", **over)[1].info
    assert info["iter"] == int(info_j["iter"])
    if "record_history" in over:
        err, ls = info["err_hist"].numpy(), info["ls_hist"].numpy()
        err_j, ls_j = np.asarray(info_j["err_hist"]), np.asarray(info_j["ls_hist"])
        assert err.shape == ls.shape == (SPEED["max_iter"],)
        np.testing.assert_array_equal(np.isnan(err), np.isnan(err_j))
        np.testing.assert_array_equal(ls, ls_j)
        # the coarse phase records nothing; the last entry is the converged error
        last = info["iter"]
        assert np.isnan(err[:info["iter_f32"]]).all() and np.isnan(err[last + 1:]).all()
        assert err[last] == info["error"] < SPEED["tol"]


def test_stage_ws_and_non_diagonal_weights_raise():
    """stage_ws, outside slice 4, is accepted since slice 5: a qpgen solve
    warm-started from a previous solve's duals and working sets takes no
    step. Non-diagonal weights still rule out the clipping stage solver."""
    qp = port_qp("pruned")
    opts = td.TdunesOpts(**{**SPEED, **PHASES["one_phase"], "stage_solver": "qpgen"})
    out = tdunes_solve(qp, None, opts)
    out2 = tdunes_solve(qp, out.lam, opts, stage_ws=out.info["qpgen_ws"])
    assert out2.info["status"] == 0 and out2.info["iter"] == 0
    Q = qp.Q.clone()
    Q[1, 0, 1] = Q[1, 1, 0] = 0.1
    with pytest.raises(ValueError, match="clipping"):
        tdunes_solve(qp.replace(Q=Q), None, td.TdunesOpts(**SPEED))
    assert td.clipping_applicable(qp) and not td.clipping_applicable(qp.replace(Q=Q))


def test_data_entry_points_default_to_the_card():
    """models.quadcopter, convert.qp_from_numpy and convert.ms_from_numpy
    build on "cuda" unless the caller passes device="cpu"; without a card
    the default fails loudly instead of falling back to the CPU."""
    for fn in (models.quadcopter, convert.qp_from_numpy, convert.ms_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            models.quadcopter(2, 2, 6)


def test_chip_smoke_builds_the_generic_bench_asymmetric_tree():
    """models.asym_tree, which chip_smoke.py and the profiling script
    solve, builds generic_bench's asymmetric tree from numpy (it imports
    nothing of JAX): the same topology and data."""
    qp = models.asym_tree(device="cpu")
    qp_j = jax_qp("asym")
    assert qp.topo == convert.topo_from(qp_j.topo)
    a, b = convert.qp_arrays(qp), convert.qp_arrays(qp_j)
    for f in QP_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_generic_speed_opts_are_generic_bench_speed_opts():
    """models.GENERIC_SPEED_OPTS, the options chip_smoke.py and the
    profiling script solve with, are generic_bench.speed_opts(on_tpu=True)."""
    assert td.TdunesOpts(**models.GENERIC_SPEED_OPTS) == td.TdunesOpts(**SPEED)

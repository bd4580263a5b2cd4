"""PyTorch port: the LTV setters, set_x0, eliminate_x0 and EliminatedTreeQP
(``core/qp_data.py``) against the JAX package's, and the generic solver
on x0-eliminated trees.

The same numpy inputs go through both packages on spring_mass_chain(2, 3,
2, 6) with general rows and a root S, and on quadcopter(2, 2, 6) (its
leaves have no controls): every field equal within 1e-15. The solves run
``models.GENERIC_SPEED_OPTS`` on both sides (the options of the chip
smoke's MPC path), the JAX side on its XLA chain backend, and are held to
the ROADMAP bars (iterations within one, x and u within 1e-7)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from benchmarks.closed_loop import closed_loop_mpc
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.utils.pruning import prune_scenario_tree as jprune

from treeqp_tpu_torch import EliminatedTreeQP, convert, ipm_solve, models, tdunes_solve
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.core.qp_data import QP_FIELDS
from treeqp_tpu_torch.solvers import ipm, tdunes as td

torch.set_num_threads(1)

FIELD_TOL = 1e-15
X_TOL = U_TOL = 1e-7
OPTS = models.GENERIC_SPEED_OPTS


@functools.lru_cache(maxsize=None)
def instances(name):
    """(JAX QP, port QP) of the same data."""
    if name == "spring_rows":
        qj = jmodels.with_general_rows(jmodels.spring_mass_chain(2, 3, 2, 6)[0])
        qp = models.with_general_rows(models.spring_mass_chain(2, 3, 2, 6, device="cpu")[0])
        # a root S, so that eliminate_x0 folds S_0 x0 into r_0
        S = np.zeros(qj.S.shape)
        S[0] = np.random.default_rng(7).standard_normal(S.shape[1:])
        return qj.replace(S=jnp.asarray(S)), qp.replace(S=torch.tensor(S))
    return jmodels.quadcopter(2, 2, 6).qp, models.quadcopter(2, 2, 6, device="cpu").qp


def assert_same(qp, qj, what):
    """Every field of the port's QP within FIELD_TOL of the JAX one, and the
    same topology."""
    assert qp.topo == convert.topo_from(qj.topo), what
    a, b = convert.qp_arrays(qp), convert.qp_arrays(qj)
    for f in QP_FIELDS:
        assert a[f].shape == b[f].shape, (what, f)
        assert np.max(np.abs(a[f] - b[f]), initial=0.0) <= FIELD_TOL, (what, f)


def flats(topo, seed):
    """Seeded flat inputs of the three LTV setters for ``topo``."""
    rng = np.random.default_rng(seed)
    nx, nu, par = topo.nx, topo.nu, topo.parent
    ne = range(1, topo.Nn)
    n_x, n_u = sum(nx), sum(nu)
    lo_x, lo_u = -1.0 - rng.random(n_x), -1.0 - rng.random(n_u)
    return dict(
        dynamics=(rng.standard_normal(sum(nx[c] * nx[par[c]] for c in ne)),
                  rng.standard_normal(sum(nx[c] * nu[par[c]] for c in ne)),
                  rng.standard_normal(sum(nx[c] for c in ne))),
        objective=(1.0 + rng.random(n_x), 1.0 + rng.random(n_u), rng.standard_normal(n_x),
                   rng.standard_normal(n_u)),
        bounds=(lo_x, -lo_x, lo_u, -lo_u))


@pytest.mark.parametrize("name", ["spring_rows", "quadcopter"])
def test_ltv_setters_match_jax(name):
    qj, qp = instances(name)
    f = flats(qp.topo, 3)
    for setter in ("dynamics", "objective", "bounds"):
        meth = {"dynamics": "set_ltv_dynamics", "objective": "set_ltv_objective_diag",
                "bounds": "set_ltv_bounds"}[setter]
        out = getattr(qp, meth)(*f[setter])
        assert_same(out, getattr(qj, meth)(*f[setter]), setter)
        # tensors on the QP's device give the same data as numpy arrays
        again = getattr(qp, meth)(*(torch.tensor(v) for v in f[setter]))
        assert all(torch.equal(getattr(out, k), getattr(again, k)) for k in QP_FIELDS)
    with pytest.raises(ValueError):
        qp.set_ltv_dynamics(f["dynamics"][0][:-1], *f["dynamics"][1:])


@pytest.mark.parametrize("name", ["spring_rows", "quadcopter"])
def test_x0_elimination_matches_jax(name):
    """set_x0, eliminate_x0 (both forms) and EliminatedTreeQP.set_x0."""
    qj, qp = instances(name)
    rng = np.random.default_rng(11)
    nx0 = qp.topo.nx[0]
    x1, x2 = 0.1 * rng.standard_normal(nx0), 0.1 * rng.standard_normal(nx0)
    assert_same(qp.set_x0(x1), qj.set_x0(x1), "set_x0")
    e, ej = qp.set_x0(x1).eliminate_x0(), qj.set_x0(x1).eliminate_x0()
    assert_same(e, ej, "eliminate_x0")
    assert e.topo.nx[0] == 0 and e.topo.nx[1:] == qp.topo.nx[1:]
    k, kj = (q.set_x0(x1).eliminate_x0(keep_originals=True) for q in (qp, qj))
    assert isinstance(k, EliminatedTreeQP) and k.kids0 == kj.kids0 == qp.topo.kids[0]
    for f in ("A0", "b0", "S0", "r0", "C0", "dmin0", "dmax0"):
        np.testing.assert_allclose(getattr(k, f).numpy(), np.asarray(getattr(kj, f)),
                                   rtol=0, atol=FIELD_TOL, err_msg=f)
    k2, kj2 = k.set_x0(x2), kj.set_x0(x2)
    assert_same(k2.qp, kj2.qp, "EliminatedTreeQP.set_x0")
    # re-embedding is elimination from scratch, but for the root's x bounds
    # (outside the nx[0] = 0 topology, they keep the first state)
    scratch = qp.set_x0(x2).eliminate_x0()
    for f in QP_FIELDS:
        a, b = getattr(k2.qp, f), getattr(scratch, f)
        if f in ("xmin", "xmax"):
            a, b = a[1:], b[1:]
        assert torch.equal(a, b), f
    if name == "spring_rows":
        assert float((k2.qp.r[0] - qp.r[0]).abs().max()) > 0  # S_0 x0 folded in
        assert float((k2.qp.dmin[0] - qp.dmin[0]).abs().max()) > 0  # C_0 x0 too


def solve_both(qj, qp, lam0=None):
    out_j = jtd.tdunes_solve(qj, lam0, jtd.TdunesOpts(**{**OPTS, "chain_backend": "xla"}))
    out = tdunes_solve(qp, None if lam0 is None else torch.tensor(np.asarray(lam0)),
                       td.TdunesOpts(**OPTS))
    return out_j, out


def quadcopter_pruned():
    """quadcopter(2, 2, 6) pruned to 3 scenarios (Dirichlet seed 0) in both
    packages: the MPC tree of the chip smoke's re-embedding path, small."""
    qj = jmodels.quadcopter(2, 2, 6)
    probs = np.random.default_rng(0).dirichlet(np.ones(4))
    return (jprune(qj.qp, leaf_probs=probs, nscenmax=3)[0],
            models.pruned(models.quadcopter(2, 2, 6, device="cpu").qp, 3), qj.x0)


@pytest.mark.parametrize("name", ["spring", "quadcopter_pruned"])
def test_eliminated_solve_matches_jax(name):
    if name == "spring":
        qj, x0 = jmodels.spring_mass_chain(2, 3, 2, 6)
        qp = models.spring_mass_chain(2, 3, 2, 6, device="cpu")[0]
    else:
        qj, qp, x0 = quadcopter_pruned()
    qj, qp = qj.set_x0(x0).eliminate_x0(), qp.set_x0(x0).eliminate_x0()
    out_j, out = solve_both(qj, qp)
    assert int(out_j.info["status"]) == 0 and out.info["status"] == 0
    assert abs(int(out_j.info["iter"]) - out.info["iter"]) <= 1
    assert float(jax_kkt(qj, out_j)) < 1e-8 and max_kkt_residual(qp, out) < 1e-8
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    assert np.max(np.abs(a["x"] - b["x"])) <= X_TOL
    assert np.max(np.abs(a["u"] - b["u"])) <= U_TOL


def test_eliminate_x0_matches():
    """x0 elimination (tree_qp_common.c:404-525) does not change the
    solution: the port's counterpart of tests/test_tdunes.py's test of the
    same name, on the generated spring_mass_chain(2, 3, 2, 6)."""
    qp, x0 = models.spring_mass_chain(2, 3, 2, 6, device="cpu")
    opts = td.TdunesOpts(**{**OPTS, "tol": 1e-10})
    out_full = tdunes_solve(qp, None, opts)
    qp_e = qp.set_x0(x0).eliminate_x0()
    out_e = tdunes_solve(qp_e, None, opts)
    assert out_full.info["status"] == 0 and out_e.info["status"] == 0
    assert max_kkt_residual(qp_e, out_e) < 1e-10
    assert float((out_full.x[1:] - out_e.x[1:]).abs().max()) < 1e-8
    assert float((out_full.u - out_e.u).abs().max()) < 1e-8


def test_eliminated_x0_reembedding():
    """tests/test_tdunes.py's test_eliminated_x0_reembedding through both
    packages: three re-embeddings into the eliminated problem (path A)
    against elimination from scratch (path B), and the port's path A
    against JAX's."""
    qj, _ = jmodels.spring_mass_chain(nm=2, md=3, Nr=2, Nh=6)
    qp, _ = models.spring_mass_chain(2, 3, 2, 6, device="cpu")
    opts = td.TdunesOpts(**OPTS)
    elim, elim_j = qp.eliminate_x0(keep_originals=True), qj.eliminate_x0(keep_originals=True)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x_new = 0.1 * rng.standard_normal(qp.topo.nx[0])
        elim, elim_j = elim.set_x0(x_new), elim_j.set_x0(x_new)
        out_a = tdunes_solve(elim.qp, None, opts)
        out_b = tdunes_solve(qp.set_x0(x_new).eliminate_x0(), None, opts)
        assert out_a.info["status"] == 0
        assert float((out_a.x - out_b.x).abs().max()) < 1e-9
        assert float((out_a.u - out_b.u).abs().max()) < 1e-9
        assert max_kkt_residual(elim.qp, out_a) < 1e-8
        out_j = solve_both(elim_j.qp, elim.qp)[0]
        assert abs(int(out_j.info["iter"]) - out_a.info["iter"]) <= 1
        assert float(np.max(np.abs(np.asarray(out_j.x) - out_a.x.numpy()))) <= X_TOL
        assert float(np.max(np.abs(np.asarray(out_j.u) - out_a.u.numpy()))) <= U_TOL


def test_large_attitude_jumps_stall_in_both_packages():
    """Why the chip smoke's MPC requests follow the closed loop and are not
    random jumps of the state: on the pruned quadcopter, x0 + 0.05 N(0, I)
    (seed 0, second draw) saturates the rate bounds over the horizon and
    the generic dual Newton stalls at max_iter in both packages alike,
    though the QP is feasible (the port's IPM solves it)."""
    qj, qp, x0 = quadcopter_pruned()
    rng = np.random.default_rng(0)
    x = [x0 + 0.05 * rng.standard_normal(x0.shape) for _ in range(2)][1]
    out_j, out = solve_both(qj.set_x0(x), qp.set_x0(x))
    assert int(out_j.info["status"]) == out.info["status"] == td.TDUNES_MAX_ITER
    assert int(out_j.info["iter"]) == out.info["iter"] == OPTS["max_iter"]
    assert max_kkt_residual(qp.set_x0(x), out) > 1.0
    out_i = ipm_solve(qp.set_x0(x), ipm.IpmOpts(**{**models.IPM_OPTS["cd"], "max_iter": 100}))
    assert out_i.info["status"] == 0 and max_kkt_residual(qp.set_x0(x), out_i) < 1e-8


def test_large_attitude_jumps_stall_with_the_on_the_fly_shift_too():
    """The same state with the JAX package's default regularization,
    reg_type "on_the_fly" (the Levenberg-Marquardt shift escalated on the
    blocks whose pivots fall to reg_tol): both packages still stall at
    max_iter with the same KKT residual (> 1), and their iterates agree
    within 1e-4 (f32 factors on both sides: the JAX side's XLA tree
    Cholesky, the port's plain tree Cholesky). The shift does not reach the
    random jump states either."""
    qj, qp, x0 = quadcopter_pruned()
    rng = np.random.default_rng(0)
    x = [x0 + 0.05 * rng.standard_normal(x0.shape) for _ in range(2)][1]
    opts = {**OPTS, "reg_type": "on_the_fly"}
    out_j = jtd.tdunes_solve(qj.set_x0(x), None,
                             jtd.TdunesOpts(**{**opts, "chain_backend": "xla"}))
    out = tdunes_solve(qp.set_x0(x), None, td.TdunesOpts(**opts))
    assert int(out_j.info["status"]) == out.info["status"] == td.TDUNES_MAX_ITER
    assert int(out_j.info["iter"]) == out.info["iter"] == OPTS["max_iter"]
    kkt, kkt_j = max_kkt_residual(qp.set_x0(x), out), float(jax_kkt(qj.set_x0(x), out_j))
    assert kkt > 1.0 and abs(kkt - kkt_j) <= 1e-6 * kkt_j
    assert float(np.max(np.abs(np.asarray(out_j.x) - out.x.numpy()))) <= 1e-4
    assert float(np.max(np.abs(np.asarray(out_j.u) - out.u.numpy()))) <= 1e-4


def test_quadcopter_plant_matches_jax():
    """The port's plant simulator (RK4 at the true mass) against JAX's, at
    seeded states and controls: within 1e-12."""
    sim, sim_j = models.quadcopter(2, 2, 6, device="cpu").simulate, \
        jmodels.quadcopter(2, 2, 6).simulate
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = np.concatenate([0.05 * rng.standard_normal(3), 0.3 * rng.standard_normal(3)])
        u = rng.uniform(-4.0, 4.0, 4)
        np.testing.assert_allclose(sim(x, u), np.asarray(sim_j(x, u)), rtol=0, atol=1e-12)


def test_closed_loop_reembedding_matches_jax():
    """The chip smoke's MPC path, small: on the pruned quadcopter, the
    port's closed loop through EliminatedTreeQP.set_x0 (each solution's
    first control to the plant, the duals kept) against JAX's
    closed_loop_mpc on the same tree without elimination (tdunes, warm
    starts, no IPM bootstrap): every step status 0 with KKT < 1e-8 on the
    eliminated problem, iterations within one, the applied controls within
    U_TOL and the states within X_TOL."""
    nsim = 5
    qj, qp, _ = quadcopter_pruned()
    model, model_j = models.quadcopter(2, 2, 6, device="cpu"), jmodels.quadcopter(2, 2, 6)
    log = closed_loop_mpc(dataclasses.replace(model_j, qp=qj), "tdunes", nsim=nsim,
                          opts=jtd.TdunesOpts(**{**OPTS, "chain_backend": "xla"}),
                          ipm_bootstrap=False)
    assert list(log.status) == [0] * nsim
    opts, nu = td.TdunesOpts(**OPTS), qp.topo.nu[0]
    x, lam = model.x0, None
    el = qp.set_x0(x).eliminate_x0(keep_originals=True)
    for k in range(nsim):
        if k:
            el = el.set_x0(x)
        out = tdunes_solve(el.qp, lam, opts)
        assert out.info["status"] == 0 and max_kkt_residual(el.qp, out) < 1e-8, k
        assert abs(out.info["iter"] - int(log.iters[k])) <= 1, k
        u0 = out.u[0, :nu].numpy()
        assert np.max(np.abs(u0 - log.u[k])) <= U_TOL, k
        x, lam = model.simulate(x, u0), out.lam
        assert np.max(np.abs(x - log.x[k + 1])) <= X_TOL, k

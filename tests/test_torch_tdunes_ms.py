"""PyTorch port, the whole slice: ``tdunes_ms_solve`` of the port (plain
twins on the CPU) against the JAX package's ``tdunes_ms_solve`` (Pallas
kernels in interpret mode) with the same options on the same data."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.solvers import tdunes_multistage as jtm

from treeqp_tpu_torch import convert
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

SLICE = dict(stage_solver="clipping", tol=1e-8, max_iter=120,
             factor_dtype="float32", refine_steps=2, refine_safeguard=False,
             chain_backend="pallas", reg_type="always", reg_value=1e-6,
             f32_phase_tol=0.0, df64_phase=False)
CASES = {
    "quadcopter": lambda: jmodels.quadcopter(2, 2, 6).qp,
    "spring_mass_chain": lambda: jmodels.spring_mass_chain(nm=2, md=3, Nr=2, Nh=8)[0],
}
# Both solvers stop at stationarity 1e-8 with f32-factored, refined
# directions: the duals agree to ~1e-7 (the JAX slice sits 1.9e-7 in
# lambda from the f64 reference on the full-size tree), primal to ~1e-9.
X_TOL, U_TOL, LAM_TOL = 1e-7, 1e-7, 1e-6


def port_ms(name):
    qp_j = CASES[name]()
    return tm.split_multistage(convert.qp_from_numpy(
        convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo), device="cpu"))


@functools.lru_cache(maxsize=None)
def solve_both_cached(name, **overrides):
    """solve_both, once per file for each case (the JAX two-phase solve
    takes ~45 s on the CPU with its Pallas kernels interpreted)."""
    return solve_both(name, **overrides)


def solve_both(name, jax_overrides=None, **overrides):
    """The JAX and port solves of one case with SLICE and ``overrides``;
    ``jax_overrides`` change the JAX side's options only."""
    qp_j = CASES[name]()
    ms_j = jtm.split_multistage(qp_j)
    cro, cho, info_j = jtm.tdunes_ms_solve(
        ms_j, None, None, jtd.TdunesOpts(**{**SLICE, **overrides, **(jax_overrides or {})}))
    out_j = jtm.merge_output(ms_j, cro, cho, info_j)
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    ms = tm.split_multistage(qp)
    cro, cho, info = tm.tdunes_ms_solve(ms, None, None,
                                        td.TdunesOpts(**{**SLICE, **overrides}))
    out = tm.merge_output(ms, cro, cho, info)
    return qp_j, out_j, info_j, qp, out, info


@pytest.mark.parametrize("name", sorted(CASES))
def test_slice_matches_jax(name):
    qp_j, out_j, info_j, qp, out, info = solve_both(name)
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert abs(int(info_j["iter"]) - info["iter"]) <= 1
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


def test_safeguarded_refinement_matches_jax():
    """The other refinement branch (keep the best of the refined
    directions by Newton-system residual)."""
    qp_j, out_j, info_j, qp, out, info = solve_both(
        "spring_mass_chain", refine_safeguard=True)
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert abs(int(info_j["iter"]) - info["iter"]) <= 1
    assert max_kkt_residual(qp, out) < 1e-8
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    assert np.max(np.abs(a["lam"] - b["lam"])) <= LAM_TOL


def test_warm_start_from_solution_takes_no_step():
    ms = port_ms("quadcopter")
    opts = td.TdunesOpts(**SLICE)
    cro, cho, _ = tm.tdunes_ms_solve(ms, None, None, opts)
    cro2, cho2, info2 = tm.tdunes_ms_solve(ms, cro["lam"], cho["lam"], opts)
    assert info2["status"] == 0 and info2["iter"] == 0
    assert torch.equal(cho2["lam"], cho["lam"])


@pytest.mark.parametrize("termination", ["infnorm", "twonorm"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_two_phase_matches_jax(name, termination):
    """The coarse f32 phase then the f64 phase: with inf-norm termination
    the coarse phase runs on newton_iter, with two-norm on chain_eval /
    crown_eval; both refactorize with chain_blocks_factor_lanes."""
    over = dict(f32_phase_tol=1e-4, termination=termination)
    qp_j, out_j, info_j, qp, out, info = solve_both_cached(name, **over)
    opts32 = dataclasses.replace(td.TdunesOpts(**{**SLICE, **over}), refine_steps=0)
    meta = tm.split_multistage(qp).meta
    assert tm._mega_applicable(td._get_prep(meta.crown_topo), meta, opts32) == \
        (termination == "infnorm")
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert info["iter_f32"] >= 1
    assert abs(int(info_j["iter"]) - info["iter"]) <= 1
    assert abs(int(info_j["iter_f32"]) - info["iter_f32"]) <= 1
    kkt_j = float(jax_kkt(qp_j, out_j))
    kkt = max_kkt_residual(qp, out)
    assert kkt_j < 1e-8 and kkt < 1e-8
    out_jt = out.replace(**{f: torch.tensor(v) for f, v in
                            convert.out_to_numpy(out_j).items()})
    assert abs(max_kkt_residual(qp, out_jt) - kkt_j) <= 1e-12
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    assert np.max(np.abs(a["x"] - b["x"])) <= X_TOL
    assert np.max(np.abs(a["u"] - b["u"])) <= U_TOL
    assert np.max(np.abs(a["lam"] - b["lam"])) <= LAM_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_line_search_on_the_one_phase_path(name):
    """ls_batch = 4 on the f64 path takes the same steps as the sequential
    search."""
    ms = port_ms(name)
    _, cho0, info0 = tm.tdunes_ms_solve(ms, None, None, td.TdunesOpts(**SLICE))
    _, cho4, info4 = tm.tdunes_ms_solve(ms, None, None,
                                        td.TdunesOpts(**{**SLICE, "ls_batch": 4}))
    assert info4["status"] == 0 and info4["iter"] == info0["iter"]
    assert torch.equal(cho4["lam"], cho0["lam"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("accept_at", [1.0, 0.6**3, 0.6**6, None])
def test_armijo_batch_takes_the_first_accepted_step(accept_at, dtype):
    """The batched search on a model dual f(tau) = -tau: candidates beta^k
    (k = 1..4) as powers in the data dtype, then sequential steps from
    beta^4 by repeated multiplication, as the JAX package's search."""
    opts = td.TdunesOpts(ls_batch=4, ls_max_iter=8)
    tried = []

    def f_at(tau):
        tried.append(tau)
        ok = accept_at is not None and float(tau) <= accept_at * (1 + 1e-6)
        return torch.full((), -1.0 if ok else 1.0, dtype=dtype), float(tau)

    f0, dot = torch.zeros((), dtype=dtype), torch.full((), -1.0, dtype=dtype)
    f1, rest1 = f_at(torch.ones((), dtype=dtype))
    tau, _, rest, ls_it, acc = tm._armijo(f_at, f0, dot, f1, rest1, opts)
    beta = torch.full((), 0.6, dtype=dtype)
    taus = torch.pow(beta, torch.arange(1, 5, dtype=dtype))
    if accept_at == 1.0:
        assert (ls_it, acc, len(tried)) == (1, True, 1)
    elif accept_at == 0.6**3:
        assert (ls_it, acc, rest) == (4, True, float(taus[2]))
        assert torch.equal(tau, taus[2])
    elif accept_at == 0.6**6:
        assert (ls_it, acc) == (7, True)
        assert torch.equal(tau, 0.6 * (0.6 * taus[3]))
    else:
        assert (ls_it, acc, len(tried)) == (8, False, 8)


@pytest.mark.parametrize("override", [
    dict(axis_name="scen"), dict(chain_backend="xla"),
    dict(factor_dtype="same", chain_backend="xla"), dict(reg_type="on_the_fly"),
    pytest.param(dict(stage_solver="qpgen"), id="stage_solver"),
    pytest.param(dict(stage_solver="dense"), id="stage_solver_dense"),
    pytest.param(dict(stage_solver="boxqp"), id="stage_solver_boxqp")],
    ids=lambda o: next(iter(o)))
def test_options_outside_the_slice_raise(override, monkeypatch):
    """The options outside slice 1. axis_name with no process group
    registered under it raises LookupError (the sharded solve is
    tests/test_torch_shard_solver.py's), and a stage solver other than clipping the
    ValueError of the JAX package's own assert. chain_backend="xla",
    factor_dtype="same" (on the portable backend: with the chain kernels
    both packages refuse f64 factors, test_torch_default_opts.py) and
    reg_type="on_the_fly" (the chain kernels, the crown's plain tree
    Cholesky between their sweeps) solve, and agree with the JAX package's
    solve in iterations, x, u and lambda, certified by both oracles. The
    on-the-fly case is held against JAX's portable backend: the chain
    kernels do not shift their pivots, the portable chain factor shifts
    those at or below reg_tol, so the two agree where no chain pivot falls
    there, which the case asserts."""
    ms = port_ms("quadcopter")
    opts = dataclasses.replace(td.TdunesOpts(**SLICE), **override)
    if "axis_name" in override:
        with pytest.raises(LookupError, match="no process group"):
            tm.tdunes_ms_solve(ms, None, None, opts)
        return
    if "stage_solver" in override:
        with pytest.raises(ValueError, match="supports only the clipping"):
            tm.tdunes_ms_solve(ms, None, None, opts)
        return
    pivots = []
    real = ck.chain_blocks_factor

    def recorded(*args):
        out = real(*args)
        pivots.append(float(torch.diagonal(out[0], dim1=-2, dim2=-1).min()))
        return out

    monkeypatch.setattr(ck, "chain_blocks_factor", recorded)
    jax_over = dict(chain_backend="xla") if "reg_type" in override else None
    qp_j, out_j, info_j, qp, out, info = solve_both("quadcopter", jax_over, **override)
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert int(info_j["iter"]) == info["iter"]
    kkt_j, kkt = float(jax_kkt(qp_j, out_j)), max_kkt_residual(qp, out)
    assert kkt_j < 1e-8 and kkt < 1e-8
    out_jt = out.replace(**{f: torch.tensor(v) for f, v in
                            convert.out_to_numpy(out_j).items()})
    assert abs(max_kkt_residual(qp, out_jt) - kkt_j) <= 1e-12
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    assert np.max(np.abs(a["x"] - b["x"])) <= X_TOL
    assert np.max(np.abs(a["u"] - b["u"])) <= U_TOL
    assert np.max(np.abs(a["lam"] - b["lam"])) <= LAM_TOL
    if "reg_type" in override:
        assert pivots and min(pivots) > opts.reg_tol
    else:
        assert not pivots

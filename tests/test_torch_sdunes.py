"""PyTorch port, sdunes at module level: the scenario decomposition, the
stage solves, residuals, dual value, exact Hessian action, the duals
recovered from a tree solution and the export back onto the tree against
the JAX package's functions at one numpy-seeded dual point (f64, within
1e-12); the reference's dual-dimension formula; exact convergence on a
quadratic dual; warm starts. The JAX side here runs no solve (~5 s)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.qp_data import TreeQPOut as JTreeQPOut
from treeqp_tpu.solvers import sdunes as jsd

from treeqp_tpu_torch import convert, models
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.core.qp_data import OUT_FIELDS, TreeQPOut
from treeqp_tpu_torch.solvers import sdunes as sd

torch.set_num_threads(1)

MODULE_TOL = 1e-12  # f64 on both sides, sums in another order


def close(got, ref, what, tol=MODULE_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max() if ref.size else 0.0), (what, err)


@functools.lru_cache(maxsize=None)
def instance():
    """spring_mass_chain(2, 2, 3, 8) in both packages: 8 scenarios, nx = 4,
    nu = 1, state bounds active."""
    qp_j, _ = jmodels.spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    return qp_j, qp, jsd.scenario_data(qp_j), sd.scenario_data(qp)


@functools.lru_cache(maxsize=None)
def dual_point():
    """A seeded dual point (lam, mu), a direction (dmu, dlam) and a tree
    solution (TreeQPOut fields) of the instance's shapes, numpy f64."""
    _, qp, _, sqp = instance()
    meta = sqp.meta
    rng = np.random.default_rng(7)
    nx, nu = sqp.b.shape[-1], sqp.r.shape[-1]
    lam = rng.standard_normal((meta.Ns - 1, meta.Nr, nu))
    mu = 3.0 * rng.standard_normal((meta.Ns, meta.Nh, nx))
    dmu = rng.standard_normal(mu.shape)
    dlam = rng.standard_normal((meta.Ns - 1, meta.Nr * nu))
    t = qp.topo
    out = dict(x=rng.standard_normal((t.Nn, t.nxm)), u=rng.standard_normal((t.Nn, t.num)),
               lam=rng.standard_normal((t.Nn, t.nxm)), mu_x=rng.standard_normal((t.Nn, t.nxm)),
               mu_u=rng.standard_normal((t.Nn, t.num)), mu_d=np.zeros((t.Nn, t.ncm)))
    return lam, mu, dmu, dlam, out


def both_solutions():
    """The stage solutions of both packages at the seeded dual point."""
    _, _, sqp_j, sqp = instance()
    lam, mu, *_ = dual_point()
    cm_j = jsd._coupling_masks(sqp_j.meta, jnp.float64)
    cm = sd._coupling_masks(sqp.meta, torch.float64, "cpu")
    sol_j = jsd._stage_solve(sqp_j, jnp.asarray(mu), jnp.asarray(lam), cm_j)
    sol = sd._stage_solve(sqp, torch.tensor(mu), torch.tensor(lam), cm)
    return sol_j, sol, cm_j, cm


def test_scenario_data_matches_jax():
    _, _, sqp_j, sqp = instance()
    for f in sd.SQP_FIELDS:
        close(getattr(sqp, f), getattr(sqp_j, f), f, tol=0.0)
    assert sqp.meta.common == sqp_j.meta.common
    np.testing.assert_array_equal(sqp.meta.paths, np.asarray(sqp_j.meta.path_ids))
    # the converters carry the same numbers
    back = convert.sqp_from_numpy(convert.sqp_arrays(sqp_j), sqp.meta.topo, device="cpu")
    for f in sd.SQP_FIELDS:
        assert torch.equal(getattr(back, f), getattr(sqp, f)), f


def test_stage_solve_residuals_and_dual_value_match_jax():
    _, _, sqp_j, sqp = instance()
    lam, mu, *_ = dual_point()
    sol_j, sol, cm_j, cm = both_solutions()
    for k in ("qmod", "rmod", "x", "u", "xUnc", "uUnc", "qt", "rt"):
        close(sol[k], sol_j[k], k)
    assert 0 < int((sol["qt"] == 0).sum()) < sol["qt"].numel()  # bounds active
    for got, ref, k in zip(sd._residuals(sqp, sol, cm), jsd._residuals(sqp_j, sol_j, cm_j),
                           ("r_mu", "r_lam")):
        close(got, ref, k)
    close(sd._dual_value(sqp, sol, torch.tensor(mu)),
          jsd._dual_value(sqp_j, sol_j, jnp.asarray(mu), jnp.asarray(lam), cm_j), "f")


def test_apply_M_matches_jax():
    _, _, sqp_j, sqp = instance()
    *_, dmu, dlam, _ = dual_point()
    sol_j, sol, cm_j, cm = both_solutions()
    nu = sqp.r.shape[-1]
    dm_j = cm_j[..., None].repeat(nu, axis=-1).reshape(sqp.meta.Ns - 1, -1)
    dm = sd._dmask(cm, sqp.meta, nu)
    close(dm, dm_j, "dm", tol=0.0)
    got = sd._sd_apply_M(sqp, sol, cm, dm, torch.tensor(dmu), torch.tensor(dlam))
    ref = jsd._sd_apply_M(sqp_j, sol_j, cm_j, dm_j, jnp.asarray(dmu), jnp.asarray(dlam))
    for g, r, k in zip(got, ref, ("Amu", "Al")):
        close(g, r, k)


def test_apply_M_is_the_hessian_of_the_blocks():
    """The factored Hessian action equals the dense assembly of the banded
    blocks, the coupling columns and the Jay's Mll part (f64)."""
    _, _, _, sqp = instance()
    *_, dmu, dlam, _ = dual_point()
    _, sol, _, cm = both_solutions()
    meta, nu = sqp.meta, sqp.r.shape[-1]
    dm = sd._dmask(cm, meta, nu)
    Amu, Al = sd._sd_apply_M(sqp, sol, cm, dm, torch.tensor(dmu), torch.tensor(dlam))
    D, Ssub = sd._banded_blocks(sqp.A, sqp.B, sol["qt"], sol["rt"])
    U = sd._coupling_columns(sqp.B, sol["rt"], meta)
    x = torch.tensor(dmu)
    ref = torch.einsum("skij,skj->ski", D, x)
    ref[:, 1:] += torch.einsum("skij,skj->ski", Ssub, x[:, :-1])
    ref[:, :-1] += torch.einsum("skji,skj->ski", Ssub, x[:, 1:])
    dl = torch.tensor(dlam) * dm
    ref += torch.einsum("skxl,sl->skx", U, sd._coef_of(dl, meta.Ns))
    close(Amu, ref, "Amu")
    Kv = torch.einsum("skxl,skx->sl", U, x)
    rt_l = sol["rt"][:, :meta.Nr].reshape(meta.Ns, -1)
    ref_l = (rt_l[:-1] + rt_l[1:]) * dl
    ref_l[1:] -= rt_l[1:-1] * dl[:-1]
    ref_l[:-1] -= rt_l[1:-1] * dl[1:]
    close(Al, (ref_l + Kv[:-1] - Kv[1:]) * dm, "Al")


def test_scenario_duals_from_tree_matches_jax():
    """Both forms: the equal split of lam_tree, and the exact recovery from
    a full tree solution."""
    _, _, sqp_j, sqp = instance()
    *_, out = dual_point()
    out_j = JTreeQPOut(**{k: jnp.asarray(v) for k, v in out.items()}, info={})
    out_t = TreeQPOut(**{k: torch.tensor(v) for k, v in out.items()}, info={})
    for args_j, args in (((out_j.lam,), (out_t.lam,)), ((out_j.lam, out_j), (out_t.lam, out_t))):
        lam_j, mu_j = jsd.scenario_duals_from_tree(sqp_j, *args_j)
        lam, mu = sd.scenario_duals_from_tree(sqp, *args)
        close(lam, lam_j, "lam0")
        close(mu, mu_j, "mu0")
    assert float(lam.abs().max()) > 0.0


def test_scenario_output_matches_jax():
    _, qp, sqp_j, sqp = instance()
    lam, mu, *_ = dual_point()
    sol_j, sol, *_ = both_solutions()
    info = dict(iter=0, status=0)
    ref = jsd.scenario_output(sqp_j, sol_j, jnp.asarray(lam), jnp.asarray(mu), info)
    got = sd.scenario_output(sqp, sol, torch.tensor(lam), torch.tensor(mu), info)
    for f in OUT_FIELDS:
        close(getattr(got, f), getattr(ref, f), f)


def test_dual_dimension_formula():
    """The pairwise common-node couplings sum to the reference's closed form
    (Nr Ns - (Ns-1)/(md-1)) (treeqp_sdunes_calculate_dual_dimension,
    dual_Newton_scenarios.c:99-108; tests/test_sdunes.py)."""
    for md, Nr in [(2, 2), (3, 2), (2, 3)]:
        qp, _ = models.spring_mass_chain(nm=1, md=md, Nr=Nr, Nh=Nr + 2, device="cpu")
        meta = sd.scenario_data(qp).meta
        Ns = md**Nr
        assert sum(meta.common) == Nr * Ns - (Ns - 1) // (md - 1)


def _loose_bounds(qp):
    xmin = torch.full_like(qp.xmin, -1e12)
    xmax = -xmin
    xmin[0], xmax[0] = qp.xmin[0], qp.xmax[0]
    return qp.replace(xmin=xmin, xmax=xmax, umin=torch.full_like(qp.umin, -1e12),
                      umax=torch.full_like(qp.umax, 1e12))


# the sdunes options of the card (f32 factors, two refinement steps, the
# kernels), one phase, at the JAX test's tolerance
LOOSE_OPTS = dict(models.SDUNES_OPTS, tol=1e-9, max_iter=30, f32_phase_tol=0.0)


@functools.lru_cache(maxsize=None)
def loose_solve():
    qp = _loose_bounds(models.spring_mass_chain(nm=2, md=2, Nr=2, Nh=6, device="cpu")[0])
    sqp = sd.scenario_data(qp)
    return qp, sqp, sd.sdunes_solve(sqp, None, None, sd.SdunesOpts(**LOOSE_OPTS))


def test_quadratic_dual_converges_in_two_iters():
    """No active bound: the dual is quadratic and the refined f32 Newton
    steps converge in two iterations (tests/test_sdunes.py's bar), to the
    exact solution (KKT < 1e-12)."""
    qp, sqp, (sol, lam, mu, info) = loose_solve()
    assert info["status"] == 0 and info["iter"] <= 2
    out = sd.scenario_output(sqp, sol, lam, mu, info)
    assert max_kkt_residual(qp, out) < 1e-12


@pytest.mark.parametrize("f32_phase_tol", [0.0, 1e-4])
def test_warm_start_resumes(f32_phase_tol):
    """From its own solution a solve takes at most one iteration (none in
    one phase; one with the coarse phase, whose f32 round trip of the duals
    moves them by ~1e-7)."""
    _, sqp, (_, lam, mu, _) = loose_solve()
    opts = sd.SdunesOpts(**{**LOOSE_OPTS, "f32_phase_tol": f32_phase_tol})
    _, _, _, info = sd.sdunes_solve(sqp, lam, mu, opts)
    assert info["status"] == 0 and info["iter"] <= 1


@pytest.mark.parametrize("field,value", [("chain_backend", "xla"), ("factor_dtype", "same"),
                                         ("axis_name", "scen")])
def test_unported_options_raise(field, value):
    """axis_name with no process group registered under it raises
    (LookupError; the sharded solve is tests/test_torch_shard_solver.py's).
    chain_backend="xla" and
    factor_dtype="same" (the JAX package's defaults; the latter on the
    portable backend, as with the chain kernels both packages refuse f64
    factors, test_torch_default_opts.py) solve the instance cold, in the
    JAX package's iterations, with the same trajectories and tree duals
    (within 1e-7 / 1e-6), certified by the oracle."""
    qp_j, qp, sqp_j, sqp = instance()
    over = {field: value}
    if field == "factor_dtype":
        over["chain_backend"] = "xla"
    opts = {**models.SDUNES_OPTS, **over}
    if field == "axis_name":
        with pytest.raises(LookupError, match="no process group"):
            sd.sdunes_solve(sqp, None, None, sd.SdunesOpts(**opts))
        return
    sol_j, lam_j, mu_j, info_j = jsd.sdunes_solve(sqp_j, None, None, jsd.SdunesOpts(**opts))
    sol, lam, mu, info = sd.sdunes_solve(sqp, None, None, sd.SdunesOpts(**opts))
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert int(info_j["iter"]) == info["iter"]
    out = sd.scenario_output(sqp, sol, lam, mu, info)
    assert max_kkt_residual(qp, out) < 1e-8
    out_j = jsd.scenario_output(sqp_j, sol_j, lam_j, mu_j, info_j)
    for f, tol in (("x", 1e-7), ("u", 1e-7), ("lam", 1e-6)):
        assert np.abs(getattr(out, f).numpy() - np.asarray(getattr(out_j, f))).max() <= tol, f

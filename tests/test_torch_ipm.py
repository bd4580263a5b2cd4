"""PyTorch port, slice 6: the tree IPM ``ipm_solve`` and the soft
constraints of ``core/soft.py``, against the JAX package on identical
numpy-built instances.

The instance is spring_mass_chain(nm=2, md=3, Nr=2, Nh=8) (JAX's
tests/test_ipm.py warm-start tree). The JAX side runs its XLA Riccati
(``chain_backend="xla"``: its crown-Riccati kernel path is never taken by
``ipm_solve``); the port runs its plain recursion, and with
``chain_backend="pallas"`` the f32 phase through the twins of the
crown_ric_factor / crown_ric_solve kernels. Tolerances: f64 factors, the
same iterations and status and every output within 1e-9; f32 factors,
iterations within one, x and u within 1e-7, lam within 1e-6; both KKT
oracles below 1e-8."""

import dataclasses
import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.core import soft as jsoft
from treeqp_tpu.solvers import ipm as jipm

from treeqp_tpu_torch import convert, ipm_solve, IpmOpts, soften_bounds, recover_soft
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.core.qp_data import QP_FIELDS
from treeqp_tpu_torch.ops import crown_riccati as crk
from treeqp_tpu_torch.solvers import ipm

torch.set_num_threads(1)

BASE = dict(tol=1e-10, max_iter=40)
MODES = {"f64": {}, "f32": dict(factor_dtype="float32", refine_steps=1)}
TOL = {"f64": dict(iters=0, x=1e-9, u=1e-9, lam=1e-9, mu=1e-9),
       "f32": dict(iters=1, x=1e-7, u=1e-7, lam=1e-6, mu=1e-5)}
WARM_DB = 1e-3  # the next request's shift of b (JAX's warm-start test)


def port_qp(qp_j):
    return convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                                 device="cpu")


@functools.lru_cache(maxsize=None)
def instance():
    qp_j, _ = jmodels.spring_mass_chain(nm=2, md=3, Nr=2, Nh=8)
    return qp_j, port_qp(qp_j)


@functools.lru_cache(maxsize=None)
def solve_both(mode, backend, warm=False):
    qp_j, qp = instance()
    opts = {**BASE, **MODES[mode]}
    ws_j = ws = None
    if warm:
        _, out_j, _, out = solve_both(mode, backend)
        ws_j, ws = out_j, out
        qp_j = dataclasses.replace(qp_j, b=qp_j.b + WARM_DB)
        qp = qp.replace(b=qp.b + WARM_DB)
    out_j = jipm.ipm_solve(qp_j, jipm.IpmOpts(**opts), ws=ws_j)
    out = ipm_solve(qp, IpmOpts(**opts, chain_backend=backend), ws=ws)
    return qp_j, out_j, qp, out


def check_agree(qp_j, out_j, qp, out, tol):
    info_j, info = out_j.info, out.info
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert abs(int(info_j["iter"]) - info["iter"]) <= tol["iters"]
    assert float(info["res4"].max()) < BASE["tol"]
    kkt_j, kkt = float(jax_kkt(qp_j, out_j)), max_kkt_residual(qp, out)
    assert kkt_j < 1e-8 and kkt < 1e-8
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    for f, key in (("x", "x"), ("u", "u"), ("lam", "lam"), ("mu_x", "mu"), ("mu_u", "mu")):
        assert np.abs(a[f] - b[f]).max() <= tol[key], f


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_ipm_solve_matches_jax(mode, backend):
    qp_j, out_j, qp, out = solve_both(mode, backend)
    check_agree(qp_j, out_j, qp, out, TOL[mode])
    assert (out.info["iter_f32"] > 0) == (mode == "f32")
    assert out.info["iter_f32"] < out.info["iter"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ipm_warm_start_matches_jax(mode):
    qp_j, out_j, qp, out = solve_both(mode, "pallas", warm=True)
    check_agree(qp_j, out_j, qp, out, TOL[mode])
    cold = ipm_solve(qp, IpmOpts(**BASE, **MODES[mode]))
    assert out.info["iter"] * 2 <= cold.info["iter"]


def test_f32_phase_runs_the_crown_riccati_kernels():
    """On a diagonal box-only tree the f32 phase sends the whole tree
    through crown_ric_factor (once an iteration) and crown_ric_solve
    (2 (1 + refine_steps) times); the f64 phase and chain_backend="xla"
    through neither."""
    _, qp = instance()
    counts = []
    for backend in ("pallas", "xla"):
        calls = {"f": 0, "s": 0}
        real_f, real_s = crk.crown_ric_factor, crk.crown_ric_solve

        def f(*a, **k):
            calls["f"] += 1
            return real_f(*a, **k)

        def s(*a, **k):
            calls["s"] += 1
            return real_s(*a, **k)
        with mock.patch.object(crk, "crown_ric_factor", f), \
                mock.patch.object(crk, "crown_ric_solve", s):
            out = ipm_solve(qp, IpmOpts(**BASE, **MODES["f32"], chain_backend=backend))
        counts.append((calls["f"], calls["s"], out.info["iter_f32"]))
    (nf, ns, it32), xla = counts
    assert it32 > 0 and nf == it32 and ns == 4 * it32
    assert xla[:2] == (0, 0)


def test_record_history_matches_jax():
    qp_j, qp = instance()
    opts = dict(BASE, record_history=True)
    out_j = jipm.ipm_solve(qp_j, jipm.IpmOpts(**opts))
    out = ipm_solve(qp, IpmOpts(**opts))
    hj, h = np.asarray(out_j.info["hist"]), out.info["hist"].numpy()
    assert h.shape == hj.shape == (BASE["max_iter"], 7)
    it = out.info["iter"]
    assert np.isnan(h[it:]).all() and np.isfinite(h[:it]).all()
    np.testing.assert_allclose(h[:it], hj[:it], rtol=1e-6, atol=1e-12)


def test_nan_direction_exits_as_min_step():
    """A failing factorization (an indefinite control Hessian) gives a NaN
    direction: both packages stop after one iteration with MIN_STEP and
    the starting point, never OPTIMAL."""
    qp_j, qp = instance()
    R = np.asarray(qp_j.R).copy()
    R[:] = -10.0 * np.eye(R.shape[-1])
    qp_j = dataclasses.replace(qp_j, R=jnp.asarray(R))
    qp = qp.replace(R=torch.tensor(R))
    out_j = jipm.ipm_solve(qp_j, jipm.IpmOpts(**BASE))
    out = ipm_solve(qp, IpmOpts(**BASE))
    assert int(out_j.info["status"]) == ipm.IPM_MIN_STEP == out.info["status"]
    assert int(out_j.info["iter"]) == 1 == out.info["iter"]
    assert torch.isfinite(out.x).all() and not out.x.abs().max() > 0
    np.testing.assert_allclose(out.info["res4"].numpy(), np.asarray(out_j.info["res4"]),
                               rtol=1e-12)


def test_axis_name_is_not_ported():
    """The generic IPM does not read axis_name, as in the JAX package (the
    sharded IPM is ipm_ms_solve's): the solve with it is the solve without
    it, bit for bit."""
    _, qp = instance()
    out = ipm_solve(qp, IpmOpts(axis_name="scen"))
    ref = ipm_solve(qp, IpmOpts())
    assert out.info["status"] == 0 and out.info["iter"] == ref.info["iter"]
    assert torch.equal(out.x, ref.x) and torch.equal(out.u, ref.u)


# ---------------------------------------------------------------------------
# soft constraints (JAX's tests/test_soft.py instance)


def _tight_problem():
    qp = jmodels.linear_chain(md=2, Nr=1, Nh=6, nm=2, nu_count=1).qp
    xmax = np.asarray(qp.xmax).copy()
    xmax[1:, 0] = 0.02
    return qp.replace(xmax=jnp.asarray(xmax, qp.dtype))


@functools.lru_cache(maxsize=None)
def soft_both(Z):
    qp_j = _tight_problem()
    qp = port_qp(qp_j)
    soft_idx = [[0] if n > 0 else [] for n in range(qp.topo.Nn)]
    qs_j, m_j = jsoft.soften_bounds(qp_j, soft_idx, Zl=Z, Zu=Z, zl=0.5, zu=0.25)
    qs, m = soften_bounds(qp, soft_idx, Zl=Z, Zu=Z, zl=0.5, zu=0.25)
    return qs_j, m_j, qs, m


def test_soften_bounds_matches_jax():
    qs_j, m_j, qs, m = soft_both(10.0)
    assert qs.topo == convert.topo_from(qs_j.topo)
    assert m.soft_x == m_j.soft_x and m.nu_orig == m_j.nu_orig
    a, b = convert.qp_arrays(qs), convert.qp_arrays(qs_j)
    for f in QP_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("Z", [10.0, 1e8])
def test_softened_solve_and_recovery_match_jax(Z):
    qs_j, m_j, qs, m = soft_both(Z)
    opts = dict(tol=1e-10, max_iter=60)
    aug_j = jipm.ipm_solve(qs_j, jipm.IpmOpts(**opts))
    aug = ipm_solve(qs, IpmOpts(**opts))
    check_agree(qs_j, aug_j, qs, aug, TOL["f64"])
    # the general rows' multipliers too (the soft rows live there)
    assert np.abs(aug.mu_d.numpy() - np.asarray(aug_j.mu_d)).max() <= 1e-9
    out_j, sl_j = jsoft.recover_soft(aug_j, m_j)
    out, sl = recover_soft(aug, m)
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    for f in ("x", "u", "mu_x", "mu_u", "mu_d"):
        assert a[f].shape == b[f].shape
        assert np.abs(a[f] - b[f]).max() <= 1e-9, f
    flat = lambda s_: np.array([v for ns in s_ for pair in ns for v in pair])
    assert [len(ns) for ns in sl] == [len(ns) for ns in sl_j]
    np.testing.assert_allclose(flat(sl), flat(sl_j), rtol=0, atol=1e-9)
    if Z == 10.0:  # the finite penalty is used: the soft bound is violated
        assert max(su for ns in sl for (_, su) in ns) > 1e-6


def test_ipm_opts_match_jax():
    """IpmOpts has every field of the JAX package's, with its defaults."""
    port = {f.name: f.default for f in dataclasses.fields(IpmOpts)}
    ref = {f.name: f.default for f in dataclasses.fields(jipm.IpmOpts)}
    assert port == ref


def test_ipm_path_opts_are_the_bench_modes():
    """models.IPM_OPTS: "box" is ipm_bench's ms_f32_pallas mode, "cd"
    general_cd_bench's ipm_ms options on the TPU."""
    from benchmarks import general_cd_bench as gcb
    from benchmarks import ipm_bench
    from treeqp_tpu_torch.models import IPM_OPTS
    cfg = {k: v for k, v in ipm_bench.MODES["ms_f32_pallas"].items() if not k.startswith("_")}
    assert IpmOpts(**IPM_OPTS["box"]) == IpmOpts(tol=1e-8, max_iter=40, **cfg)
    assert IpmOpts(**IPM_OPTS["cd"]) == IpmOpts(
        tol=gcb.TOL, max_iter=60, factor_dtype="float32", refine_steps=1,
        chain_backend="pallas")

"""PyTorch port, slice 6: the multistage IPM ``ipm_ms_solve`` and the C/D
rows of the crown + chains layout, against the JAX package.

The instances are JAX's tests/test_ipm_multistage.py fixtures:
spring_mass_chain(nm=2, md=3, Nr=2, Nh=10) (85 nodes, 9 chains of 8),
box-only and with one general row -0.3 <= sum x + 0.5 u <= 0.3 on every
node. The JAX side runs ``chain_backend="xla"``; the port runs its plain
sweeps (f64) and, with f32 factors and one refinement step,
``chain_backend="pallas"``: the twins of the chain and crown Riccati
kernels. Tolerances: f64, the same iterations and status and every
output within 1e-9; f32, iterations within one, x and u within 1e-7, lam
within 1e-6; both KKT oracles below 1e-8."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.solvers import ipm as jipm
from treeqp_tpu.solvers import ipm_multistage as jims
from treeqp_tpu.solvers import tdunes_multistage as jtm

from treeqp_tpu_torch import (IpmOpts, convert, ipm_ms_solve, merge_output,
                              split_multistage, tdunes_ms_solve)
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

BASE = dict(tol=1e-9, max_iter=40)
MODES = {"f64": {}, "f32": dict(factor_dtype="float32", refine_steps=1)}
TOL = {"f64": dict(iters=0, x=1e-9, u=1e-9, lam=1e-9, mu=1e-9),
       "f32": dict(iters=1, x=1e-7, u=1e-7, lam=1e-6, mu=1e-5)}
WARM_DB = 1e-4  # the next request's shift of b (JAX's warm-start test)


@functools.lru_cache(maxsize=None)
def instance(rows):
    qp_j, _ = jmodels.spring_mass_chain(nm=2, md=3, Nr=2, Nh=10)
    if rows:
        qp_j = jmodels.with_general_rows(qp_j, cmax=0.3)
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    return qp_j, jtm.split_multistage(qp_j), qp, split_multistage(qp)


def shifted(qp, ms, db):
    """The next MPC request: b + db on every edge, in both layouts."""
    return (dataclasses.replace(qp, b=qp.b + db),
            dataclasses.replace(ms, b=ms.b + db,
                                crown=dataclasses.replace(ms.crown, b=ms.crown.b + db)))


@functools.lru_cache(maxsize=None)
def solve_both(rows, mode, warm=False):
    qp_j, ms_j, qp, ms = instance(rows)
    opts = {**BASE, **MODES[mode]}
    ws_j = ws = None
    if warm:
        _, out_j, _, out, ws_j, ws = solve_both(rows, mode)
        qp_j, ms_j = shifted(qp_j, ms_j, WARM_DB)
        qp, ms = shifted(qp, ms, WARM_DB)
    cro_j, cho_j, info_j = jims.ipm_ms_solve(ms_j, jipm.IpmOpts(**opts), ws=ws_j)
    cro, cho, info = ipm_ms_solve(
        ms, IpmOpts(**opts, chain_backend="pallas" if mode == "f32" else "xla"), ws=ws)
    return (qp_j, jtm.merge_output(ms_j, cro_j, cho_j, info_j), qp,
            merge_output(ms, cro, cho, info), (cro_j, cho_j), (cro, cho))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("rows", [False, True], ids=["box", "rows"])
def test_ipm_ms_solve_matches_jax(rows, mode, warm):
    qp_j, out_j, qp, out, _, ws = solve_both(rows, mode, warm)
    tol = TOL[mode]
    info_j, info = out_j.info, out.info
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert abs(int(info_j["iter"]) - info["iter"]) <= tol["iters"]
    assert float(info["res4"].max()) < BASE["tol"]
    assert (info["iter_f32"] > 0) == (mode == "f32")
    kkt_j, kkt = float(jax_kkt(qp_j, out_j)), max_kkt_residual(qp, out)
    assert kkt_j < 1e-8 and kkt < 1e-8
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    for f, key in (("x", "x"), ("u", "u"), ("lam", "lam"), ("mu_x", "mu"),
                   ("mu_u", "mu"), ("mu_d", "mu")):
        assert np.abs(a[f] - b[f]).max() <= tol[key], f
    if rows:  # the general rows bind somewhere and carry mu_d in both dicts
        assert float(out.mu_d.abs().max()) > 1e-6 and "mu_d" in ws[1]
    if warm:
        cold = solve_both(rows, mode)[3]
        assert info["iter"] < cold.info["iter"]


def test_split_carries_the_general_rows():
    """split_multistage keeps each chain node's C/D rows, in JAX's layout;
    the box-only split carries none; .to() moves them."""
    qp_j, ms_j, qp, ms = instance(True)
    assert ms.C is not None
    arrays, arrays_j = convert.ms_arrays(ms), convert.ms_arrays(ms_j)
    for f in tm.GENERAL_FIELDS:
        np.testing.assert_array_equal(arrays[f], arrays_j[f], err_msg=f)
    for f in ("C", "D", "dmin", "dmax"):
        np.testing.assert_array_equal(arrays["crown"][f], arrays_j["crown"][f])
    assert instance(False)[3].C is None and "C" not in convert.ms_arrays(instance(False)[3])
    ms32 = ms.to(dtype=torch.float32)
    assert ms32.C.dtype == torch.float32 and ms32.dmax.dtype == torch.float32
    back = convert.ms_from_numpy(arrays_j, qp.topo, device="cpu")
    for f in tm.GENERAL_FIELDS:
        assert torch.equal(getattr(back, f), getattr(ms, f))


def test_merge_output_assembles_mu_d():
    """merge_output places the general-row multipliers of the crown and the
    chains at their nodes, as JAX's does, and zeros without them."""
    _, ms_j, _, ms = instance(True)
    rng = np.random.default_rng(0)
    ncm = ms.meta.full_topo.ncm
    Nc, S, L = ms.meta.crown_topo.Nn, ms.meta.S, ms.meta.L
    nx, nu = ms.meta.nx, ms.meta.nu
    parts = lambda *s: rng.standard_normal(s)
    cro = dict(x=parts(Nc, nx), u=parts(Nc, nu), lam=parts(Nc, nx), mu_x=parts(Nc, nx),
               mu_u=parts(Nc, nu), mu_d=parts(Nc, ncm))
    cho = dict(x=parts(S, L, nx), u=parts(S, L, nu), lam=parts(S, L, nx),
               mu_x=parts(S, L, nx), mu_u=parts(S, L, nu), mu_d=parts(S, L, ncm))
    t = lambda d: {k: torch.tensor(v) for k, v in d.items()}
    out = merge_output(ms, t(cro), t(cho), {})
    out_j = jtm.merge_output(ms_j, cro, cho, {})
    np.testing.assert_array_equal(out.mu_d.numpy(), np.asarray(out_j.mu_d))
    assert float(out.mu_d.abs().max()) > 0
    del cro["mu_d"], cho["mu_d"]
    assert not merge_output(ms, t(cro), t(cho), {}).mu_d.any()


def test_tdunes_ms_solve_refuses_general_rows():
    ms = instance(True)[3]
    with pytest.raises(ValueError, match="ipm_ms_solve"):
        tdunes_ms_solve(ms, None, None, td.TdunesOpts(
            stage_solver="clipping", factor_dtype="float32", chain_backend="pallas",
            reg_type="always", refine_steps=2))


def test_f32_phase_launch_counts():
    """Per f32 iteration: one chain factorization, and 2 (1 + refine_steps)
    chain sweeps each way; the box-only tree's crown through the crown
    kernels as often, the general-row tree's crown through none."""
    from unittest import mock
    from treeqp_tpu_torch.ops import crown_riccati as crk
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    for rows in (False, True):
        ms = instance(rows)[3]
        calls = dict.fromkeys(("ric_chain_factor", "ric_chain_bwd", "ric_chain_fwd",
                               "crown_ric_factor", "crown_ric_solve"), 0)
        patches = []
        for mod, name in [(rk, n) for n in calls if n.startswith("ric")] + \
                         [(crk, n) for n in calls if n.startswith("crown")]:
            real = getattr(mod, name)

            def counting(*a, _real=real, _name=name, **k):
                calls[_name] += 1
                return _real(*a, **k)
            patches.append(mock.patch.object(mod, name, counting))
        for p in patches:
            p.start()
        try:
            _, _, info = ipm_ms_solve(ms, IpmOpts(**BASE, **MODES["f32"],
                                                  chain_backend="pallas"))
        finally:
            for p in patches:
                p.stop()
        n = info["iter_f32"]
        assert n > 0 and calls["ric_chain_factor"] == n
        assert calls["ric_chain_bwd"] == calls["ric_chain_fwd"] == 4 * n
        crown = (calls["crown_ric_factor"], calls["crown_ric_solve"])
        assert crown == ((0, 0) if rows else (n, 4 * n))


# ---------------------------------------------------------------------------
# the general C/D headline at full size: how far one step past convergence
# moves the iterates


@pytest.mark.slow
def test_general_cd_headline_ends_one_step_apart():
    """general_cd("qpgen") (4437 nodes, a row on every node) at the
    headline options (tol 1e-8, f32 factors, one refinement step): the
    port's plain twins and JAX (``chain_backend="xla"``) both reach status
    0 with both KKT oracles below 1e-8, within one iteration of each other;
    stopped at the same iteration count, x and u agree within 1e-7. Their
    ends may lie one iteration apart, and on this tree one more iteration
    past tol still moves the iterates: JAX's own step past its end (tol
    tightened, one more iteration) bounds the port's distance from JAX at
    the two ends."""
    from benchmarks import general_cd_bench as gcb
    from treeqp_tpu_torch import models
    qp_j = gcb.build("tdunes_qpgen")
    ms_j = jtm.split_multistage(qp_j)
    qp = models.general_cd("qpgen", device="cpu")
    ms = split_multistage(qp)
    base = dict(tol=1e-8, max_iter=60, factor_dtype="float32", refine_steps=1)

    def jax_solve(**kw):
        cro, cho, info = jims.ipm_ms_solve(
            ms_j, jipm.IpmOpts(**{**base, **kw}, chain_backend="xla"))
        return jtm.merge_output(ms_j, cro, cho, info)

    def port_solve(**kw):
        pair = ipm_ms_solve(ms, IpmOpts(**{**base, **kw}, chain_backend="pallas"))
        return merge_output(ms, *pair)

    def gap(a, b):
        a, b = convert.out_to_numpy(a), convert.out_to_numpy(b)
        return {f: float(np.abs(a[f] - b[f]).max()) for f in ("x", "u", "lam", "mu_d")}
    out_j, out = jax_solve(), port_solve()
    n_j, n = int(out_j.info["iter"]), out.info["iter"]
    past_j = jax_solve(tol=1e-12, max_iter=n_j + 1)  # JAX, one step past its end
    n_eq = min(n, n_j)
    at_j = out_j if n_j == n_eq else jax_solve(max_iter=n_eq)
    at = out if n == n_eq else port_solve(max_iter=n_eq)
    step_j, ends, same = gap(past_j, out_j), gap(out, out_j), gap(at, at_j)
    fmt = lambda g: ", ".join(f"|d{k}| {v:.2e}" for k, v in g.items())
    print(f"general_cd qpgen ({qp.topo.Nn} nodes): iterations JAX {n_j}, port {n}; "
          f"JAX's step past its end: {fmt(step_j)}; port vs JAX at their ends: "
          f"{fmt(ends)}; both stopped at {n_eq}: {fmt(same)}")
    assert int(out_j.info["status"]) == 0 and out.info["status"] == 0
    assert float(jax_kkt(qp_j, out_j)) < 1e-8 and max_kkt_residual(qp, out) < 1e-8
    assert abs(n - n_j) <= 1
    assert same["x"] <= 1e-7 and same["u"] <= 1e-7
    assert ends["x"] <= max(1e-7, step_j["x"]) and ends["u"] <= max(1e-7, step_j["u"])

"""PyTorch port, slice 5: ``tdunes_solve`` on general C/D trees and with the
other stage solvers, against the JAX package's ``tdunes_solve``.

The general C/D trees are general_cd_bench's tdunes instances at
spring_mass_chain(nm=2, md=2, Nr=2, Nh=8) (31 nodes, the split path): a
row -0.6 <= sum x + 0.5 u <= 0.6 on every node (qpgen) or on every third
non-root node (mixed), solved at the bench's options
(``models.GENERAL_CD_OPTS``), two-phase and one-phase, cold and warm (the
next MPC request: b + 1e-6, from the cold solve's duals and working sets).
boxqp and dense run on tests/test_boxqp_stage.py's dense-weights tree
(the crown path). The JAX side runs ``chain_backend="xla"`` (the same
math with f32 factors, without the interpret-mode Pallas kernels). Also
the builders and options the chip smoke run uses, bit for bit."""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import general_cd_bench as gcb
from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.solvers import tdunes as jtd

from test_torch_qpgen_stage import box_qp
from treeqp_tpu_torch import convert, models, tdunes_solve
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.core.qp_data import QP_FIELDS
from treeqp_tpu_torch.ops import qpgen_lanes as ql
from treeqp_tpu_torch.solvers import tdunes as td

torch.set_num_threads(1)

DIMS = (2, 2, 2, 8)  # nm, md, Nr, Nh
X_TOL, U_TOL, LAM_TOL = 1e-7, 1e-7, 1e-6
PHASES = {"two_phase": {}, "one_phase": {"f32_phase_tol": 0.0}}
WARM_DB = 1e-6  # the warm request's shift of b (general_cd_bench's chain)
# boxqp / dense: the speed options of the general C/D trees with the JAX
# package's tolerance of tests/test_boxqp_stage.py
BOX_OPTS = {**models.GENERAL_CD_OPTS, "tol": 1e-9, "max_iter": 100}


@functools.lru_cache(maxsize=None)
def jax_instance(mode):
    if mode in ("qpgen", "mixed"):
        nm, md, Nr, Nh = DIMS
        with mock.patch.multiple(gcb, NM=nm, MD=md, NR=Nr, NH=Nh):
            return gcb.build("tdunes_" + mode)
    return box_qp(free=mode == "dense")


def port_instance(mode):
    if mode in ("qpgen", "mixed"):
        return models.general_cd(mode, *DIMS, device="cpu")
    qp_j = jax_instance(mode)
    return convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                                 device="cpu")


def options(mode, phase):
    base = BOX_OPTS if mode in ("boxqp", "dense") else models.GENERAL_CD_OPTS
    return {**base, **PHASES[phase], "stage_solver": mode}


@functools.lru_cache(maxsize=None)
def solve_both(mode, phase, warm=False):
    """JAX (XLA tree Cholesky) and port solves of one request; the warm
    request starts both from JAX's cold duals and working sets."""
    opts = options(mode, phase)
    lam0 = ws0 = None
    qp_j, qp = jax_instance(mode), port_instance(mode)
    if warm:
        cold = solve_both(mode, phase)[1]
        lam0, ws0 = cold.lam, cold.info.get("qpgen_ws")
        qp_j = qp_j.replace(b=qp_j.b + WARM_DB)
        qp = qp.replace(b=qp.b + WARM_DB)
    out_j = jtd.tdunes_solve(qp_j, lam0, jtd.TdunesOpts(**{**opts, "chain_backend": "xla"}),
                             stage_ws=ws0)
    tt = lambda v: None if v is None else torch.tensor(np.asarray(v))
    out = tdunes_solve(qp, tt(lam0), td.TdunesOpts(**opts),
                       stage_ws=None if ws0 is None else tuple(tt(w) for w in ws0))
    return qp_j, out_j, qp, out


def check_agree(mode, phase, warm=False):
    qp_j, out_j, qp, out = solve_both(mode, phase, warm)
    info_j, info = out_j.info, out.info
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert abs(int(info_j["iter"]) - info["iter"]) <= 1
    assert info["error"] < options(mode, phase)["tol"]
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
    return out_j, out


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("phase", sorted(PHASES))
@pytest.mark.parametrize("mode", ["qpgen", "mixed"])
def test_general_cd_solve_matches_jax(mode, phase, warm):
    out_j, out = check_agree(mode, phase, warm)
    info = out.info
    assert (info["iter_f32"] >= 1) == (phase == "two_phase" and not warm)
    # the general rows' multipliers: certified by the oracle above; on the
    # every-node instance a general row binds at the solution
    assert float(out.mu_d.abs().max()) > 0 or mode == "mixed"
    np.testing.assert_allclose(out.mu_d.numpy(), np.asarray(out_j.mu_d), rtol=0, atol=1e-6)
    assert info["qpgen_res"] < 1e-9
    n_ws = qp_gen_nodes(mode)
    for w, wj in zip(info["qpgen_ws"], out_j.info["qpgen_ws"]):
        t = port_instance(mode).topo
        assert tuple(w.shape) == (n_ws, t.nxm + t.num + t.ncm)
        np.testing.assert_array_equal(w.numpy(), np.asarray(wj))


def qp_gen_nodes(mode):
    qp = port_instance(mode)
    return qp.topo.Nn if mode == "qpgen" else \
        len(qp.topo.nc) - sum(td.clipping_applicable_nodes(qp))


@pytest.mark.parametrize("phase", sorted(PHASES))
@pytest.mark.parametrize("mode", ["boxqp", "dense"])
def test_box_and_dense_solve_match_jax(mode, phase):
    out_j, out = check_agree(mode, phase)
    if mode == "boxqp":
        assert out.info["boxqp_res"] <= 1e-12
        np.testing.assert_allclose(out.mu_x.numpy(), np.asarray(out_j.mu_x), rtol=0, atol=1e-7)
    else:
        assert not torch.any(out.mu_x != 0)


def test_hotstart_from_the_solution_skips_the_identification():
    """A one-phase solve started from a solution's duals and working sets
    takes no Newton step and runs no ADMM identification (the hotstart
    guard passes); from empty working sets the identification runs."""
    qp = port_instance("qpgen")
    opts = td.TdunesOpts(**options("qpgen", "one_phase"))
    out = tdunes_solve(qp, None, opts)
    calls = []
    real = ql.admm_identify

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)
    with mock.patch.object(ql, "admm_identify", counting):
        out2 = tdunes_solve(qp, out.lam, opts, stage_ws=out.info["qpgen_ws"])
        assert out2.info["status"] == 0 and out2.info["iter"] == 0 and calls == []
        assert torch.equal(out2.x, out.x)
        tdunes_solve(qp, out.lam, opts)
        assert calls and calls[0] == qp.topo.Nn


def test_mixed_without_general_rows_is_clipping():
    """On a tree without C/D rows every node takes the clipping closed form:
    the mixed solve is the clipping solve, with empty working sets."""
    qp = models.spring_mass_chain(*DIMS, device="cpu")[0]
    opts = options("mixed", "two_phase")
    out = tdunes_solve(qp, None, td.TdunesOpts(**opts))
    ref = tdunes_solve(qp, None, td.TdunesOpts(**{**opts, "stage_solver": "clipping"}))
    assert out.info["iter"] == ref.info["iter"]
    assert float((out.x - ref.x).abs().max()) <= 1e-12
    t = qp.topo
    assert out.info["qpgen_ws"][0].shape == (0, t.nxm + t.num + t.ncm)


# ---------------------------------------------------------------------------
# the builders and options of the chip smoke run


def test_general_cd_builders_match_jax():
    """spring_mass_chain, with_general_rows and the mixed builder give the
    JAX data bit for bit (general_cd_bench's build for both modes)."""
    qp0, x0 = models.spring_mass_chain(*DIMS, device="cpu")
    qj0, xj0 = jmodels.spring_mass_chain(*DIMS)
    np.testing.assert_array_equal(x0, np.asarray(xj0))
    pairs = [(qp0, qj0), (models.with_general_rows(qp0), jmodels.with_general_rows(qj0))]
    pairs += [(port_instance(m), jax_instance(m)) for m in ("qpgen", "mixed")]
    for qp, qp_j in pairs:
        assert qp.topo == convert.topo_from(qp_j.topo)
        a, b = convert.qp_arrays(qp), convert.qp_arrays(qp_j)
        for f in QP_FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_clipping_applicable_nodes_matches_jax():
    for mode in ("qpgen", "mixed"):
        assert td.clipping_applicable_nodes(port_instance(mode)) == \
            jtd.clipping_applicable_nodes(jax_instance(mode))
    assert td.clipping_applicable_nodes(port_instance("boxqp")) == \
        jtd.clipping_applicable_nodes(jax_instance("boxqp"))
    assert sum(td.clipping_applicable_nodes(port_instance("boxqp"))) == 0


def test_general_cd_opts_are_the_bench_tdunes_opts():
    """models.GENERAL_CD_OPTS is general_cd_bench's tdunes options on the
    TPU (general_cd_bench.py:94-125, on_tpu=True)."""
    bench = jtd.TdunesOpts(
        stage_solver="qpgen", tol=gcb.TOL / 4, max_iter=150, factor_dtype="float32",
        refine_steps=1, refine_safeguard=False, qpgen_factor_dtype="float32",
        chain_backend="pallas", reg_type="always", reg_value=1e-6, f32_phase_tol=1e-4,
        f32_patience=3)
    assert td.TdunesOpts(**models.GENERAL_CD_OPTS) == td.TdunesOpts(
        **{f: getattr(bench, f) for f in bench.__dataclass_fields__})

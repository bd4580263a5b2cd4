"""PyTorch port, the JAX package's default solver options: the regularized
block Cholesky ``_reg_cholesky`` (reg_type none / always / on_the_fly),
the plain level-synchronous tree Cholesky, ``ops/tridiag.tridiag_cr_solve``
and the whole solves of ``tdunes_solve``, ``tdunes_ms_solve`` and
``sdunes_solve`` on the portable backend (``chain_backend="xla"``, factors
in the data dtype) against the JAX package's functions on the same numpy
inputs, on the CPU.

Tolerances: f64 factors and solves within 1e-12 relative to max(1,
max|ref|) (LAPACK and PyTorch's CPU kernels sum in another order); f32
factors 1e-5 and f32 solves 1e-4 (ROADMAP); whole solves at ROADMAP's
bars, |dx|, |du| <= 1e-7 and |dlam| <= 1e-6, with equal iteration
counts."""

import dataclasses
import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import general_cd_bench as gcb
from benchmarks import generic_bench as gb
from benchmarks import models as jmodels
from benchmarks import scen1024_bench as s1b
from benchmarks import sdunes_bench as sb
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.ops import tridiag as jtri
from treeqp_tpu.solvers import sdunes as jsd
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.solvers import tdunes_multistage as jtm

from test_torch_generic_kernels import jax_qp, port_qp
from treeqp_tpu_torch import convert, models, tdunes_solve
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.ops import tridiag
from treeqp_tpu_torch.solvers import sdunes as sd
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

F64_RTOL = 1e-12
FACTOR_RTOL, SOLVE_RTOL = 1e-5, 1e-4
X_TOL, U_TOL, LAM_TOL = 1e-7, 1e-7, 1e-6
REG_TYPES = ("none", "always", "on_the_fly")


def assert_close(got, ref, rtol, what):
    """Equal NaN patterns, and the finite entries within rtol max(1,
    max|ref|)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    ok = ~np.isnan(ref)
    if ok.any():
        scale = max(1.0, np.abs(ref[ok]).max())
        err = np.abs(got[ok] - ref[ok]).max()
        assert err <= rtol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# the regularized block Cholesky


def reg_blocks(n=4, seed=0):
    """A batch of [n, n] blocks: SPD, indefinite (an eigenvalue -0.5, which
    only the x1e6 shift of the cascade lifts), singular (an exact zero
    row), one with a pivot (1e-7) under reg_tol = 1e-6, and one with a NaN
    on the diagonal; numpy f64 from a seed."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    spd = Q @ np.diag(rng.uniform(0.5, 2.0, n)) @ Q.T
    indef = Q @ np.diag([-0.5] + list(rng.uniform(0.5, 2.0, n - 1))) @ Q.T
    sing = spd.copy()
    sing[1, :] = sing[:, 1] = 0.0
    tiny = np.diag(rng.uniform(0.5, 2.0, n))
    tiny[2, 2] = 1e-14
    nan = spd.copy()
    nan[0, 0] = np.nan
    return np.stack([spd, indef, sing, tiny, nan])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("reg_type", REG_TYPES)
def test_reg_cholesky_matches_jax(reg_type, dtype):
    """``_reg_cholesky`` per block against JAX's: the factor, NaN where both
    fail; the on-the-fly cascade picks the same shift on every block."""
    W = reg_blocks().astype(dtype)
    o = dict(reg_type=reg_type, reg_tol=1e-6, reg_value=1e-6)
    ref = np.asarray(jtd._reg_cholesky(jnp.asarray(W), jtd.TdunesOpts(**o)))
    got = td._reg_cholesky(torch.tensor(W), td.TdunesOpts(**o)).numpy()
    assert got.dtype == W.dtype
    assert_close(got, ref, F64_RTOL if dtype == "float64" else FACTOR_RTOL, reg_type)
    bad = np.isnan(ref).any(axis=(1, 2))
    # NaN stays NaN; the indefinite block factors only on the shifted cascade
    assert bad[4] and bad[1] == (reg_type != "on_the_fly")
    assert not bad[0]


# ---------------------------------------------------------------------------
# the plain tree Cholesky


@functools.lru_cache(maxsize=None)
def dual_blocks(name):
    """The f64 dual-Hessian blocks of JAX's one-iteration solve at the CPU
    branch's options, equilibrated as ``_newton_factor`` does, and the
    equilibrated right-hand side — numpy arrays."""
    qp_j = jax_qp(name)
    o = jtd.TdunesOpts(**{**dataclasses.asdict(gb.speed_opts(False)), "max_iter": 1})
    lam = jtd.tdunes_solve(qp_j, None, o).lam
    prep = jtd._get_prep(qp_j.topo)
    data = jtd._stage_data(qp_j, o)
    sol = jtd._stage_solve(qp_j, lam, data, o, prep)
    W, Ut = jtd._build_dual_hessian(qp_j, sol, data, o, prep)
    sW = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(W, axis1=1, axis2=2), 1e-12))
    rows = prep.gslot[:, None] * prep.nxm + np.arange(prep.nxm)[None, :]
    sUt = sW[np.maximum(prep.gdad, 0)[:, None], rows]
    rg = jtd._nodes_to_group_mm(jtd._dual_residual(qp_j, sol, prep), prep) * sW
    return tuple(np.asarray(v) for v in (W * sW[:, :, None] * sW[:, None, :],
                                          Ut * sUt[:, :, None] * sW[:, None, :], rg))


@pytest.mark.parametrize("factor_dtype", ["same", "float32"])
@pytest.mark.parametrize("reg_type", REG_TYPES)
@pytest.mark.parametrize("name", ["asym", "pruned"])
def test_plain_tree_cholesky_matches_jax(name, reg_type, factor_dtype):
    """The port's ``_tree_chol_factor`` / ``_tree_chol_solve`` on the
    portable backend (the plain tree Cholesky) against JAX's with
    ``chain_backend="xla"`` on the asymmetric tree and the pruned
    quadcopter(2,2,6): the stored factors and the solve, f64 to 1e-12, f32
    factors to 1e-5 and solves to 1e-4. As in the kernels' parity tests
    (ROADMAP, Queue 3), the f32 factors are compared where the blocks are
    well conditioned, on the asymmetric tree: on the clipped quadcopter's
    blocks a 1-ulp rsqrt difference reaches ~2e-5 in them; the solves are
    compared everywhere."""
    Ws, Uts, rg = dual_blocks(name)
    o = dict(chain_backend="xla", reg_type=reg_type, factor_dtype=factor_dtype)
    fdt = np.float32 if factor_dtype == "float32" else np.float64
    jo, jprep = jtd.TdunesOpts(**o), jtd._get_prep(jax_qp(name).topo)
    fj = jtd._tree_chol_factor(jnp.asarray(Ws.astype(fdt)), jnp.asarray(Uts.astype(fdt)),
                               jo, jprep)
    dj = np.asarray(jtd._tree_chol_solve(fj, jnp.asarray(rg), jo, jprep))
    prep = td._get_prep(port_qp(name).topo)
    fact = td._tree_chol_factor(torch.tensor(Ws.astype(fdt)), torch.tensor(Uts.astype(fdt)),
                                td.TdunesOpts(**o), prep)
    d = td._tree_chol_solve(fact, torch.tensor(rg), prep)
    assert fact.get("kind") == "plain" and d.dtype == torch.float64
    ftol, stol = (F64_RTOL, F64_RTOL) if fdt == np.float64 else (FACTOR_RTOL, SOLVE_RTOL)
    NpG = prep.NpG
    if fdt == np.float64 or name == "asym":
        assert_close(fact["CholW"].numpy(), np.asarray(fj["CholW"])[:NpG], ftol, "CholW")
        assert_close(fact["CholUt"].numpy(), np.asarray(fj["CholUt"])[:NpG], ftol, "CholUt")
    assert_close(d.numpy(), dj, stol, "dlam")


# ---------------------------------------------------------------------------
# the Jay system's cyclic reduction


def jay_system(P, b=3, seed=1, singular=()):
    """An SPD block-tridiagonal system (diag [P, b, b], off [P-1, b, b],
    rhs [P, b]) from a seed; the blocks in ``singular`` get an exact zero
    row and column (a pivot the on-the-fly shift must lift)."""
    rng = np.random.default_rng(seed)
    off = 0.3 * rng.standard_normal((max(P - 1, 0), b, b))
    A = rng.standard_normal((P, b, b))
    diag = A @ A.transpose(0, 2, 1) + 3.0 * np.eye(b)
    for i in singular:
        diag[i, 0, :] = diag[i, :, 0] = 0.0
        if i > 0:
            off[i - 1, 0, :] = 0.0
        if i < P - 1:
            off[i, :, 0] = 0.0
    return diag, off, rng.standard_normal((P, b)), rng.uniform(1e-3, 1e-2, (P, b))


@pytest.mark.parametrize("mode", ["no_shift", "always", "on_the_fly"])
@pytest.mark.parametrize("P", [1, 7, 8])
def test_tridiag_cr_solve_matches_jax(P, mode):
    """``tridiag_cr_solve`` against JAX's in f64: without a shift
    (shift=None), with the shift added to every block (reg_tol < 0), and
    with the on-the-fly cascade on blocks with an exact zero pivot (the
    shifted factor there, the unshifted elsewhere); within 1e-12."""
    diag, off, rhs, shift = jay_system(P, singular=(0, P - 1) if mode == "on_the_fly" else ())
    kw = dict(no_shift=dict(shift=None), always=dict(shift=shift, reg_tol=-1.0),
              on_the_fly=dict(shift=shift, reg_tol=1e-6))[mode]
    ref = np.asarray(jtri.tridiag_cr_solve(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(rhs),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}))
    got = tridiag.tridiag_cr_solve(
        torch.tensor(diag), torch.tensor(off), torch.tensor(rhs),
        **{k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    assert np.isfinite(ref).all()
    assert_close(got.numpy(), ref, F64_RTOL, mode)


# ---------------------------------------------------------------------------
# whole solves


def check_out(qp_j, out_j, info_j, qp, out, info, tol):
    """Both status 0 in equal iterations, the port's error under tol, both
    oracles under 1e-8 and agreeing, x / u / lambda at ROADMAP's bars."""
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert int(info_j["iter"]) == info["iter"]
    assert info["error"] < tol
    kkt_j, kkt = float(jax_kkt(qp_j, out_j)), max_kkt_residual(qp, out)
    assert kkt_j < 1e-8 and kkt < 1e-8
    out_jt = out.replace(**{f: torch.tensor(v) for f, v in
                            convert.out_to_numpy(out_j).items()})
    assert abs(max_kkt_residual(qp, out_jt) - kkt_j) <= 1e-12
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    assert np.max(np.abs(a["x"] - b["x"])) <= X_TOL
    assert np.max(np.abs(a["u"] - b["u"])) <= U_TOL
    assert np.max(np.abs(a["lam"] - b["lam"])) <= LAM_TOL


GENERIC_OPTS = {"defaults": {}, "cpu_branch": dataclasses.asdict(gb.speed_opts(False))}


@pytest.mark.parametrize("opts", sorted(GENERIC_OPTS))
@pytest.mark.parametrize("name", ["asym", "pruned"])
def test_tdunes_solve_at_the_default_options(name, opts):
    """``tdunes_solve`` at ``TdunesOpts()`` and at generic_bench's CPU
    options (speed_opts(on_tpu=False)) against the JAX package's."""
    o = GENERIC_OPTS[opts]
    out_j = jtd.tdunes_solve(jax_qp(name), None, jtd.TdunesOpts(**o))
    qp = port_qp(name)
    out = tdunes_solve(qp, None, td.TdunesOpts(**o))
    check_out(jax_qp(name), out_j, out_j.info, qp, out, out.info, td.TdunesOpts(**o).tol)
    assert out.info["iter_f32"] == 0


def test_record_history_matches_jax():
    """``record_history`` at generic_bench's CPU options: err_hist and
    ls_hist of length max_iter, the same errors (within 1e-9 relative plus
    1e-12: f64 directions summed in another order, and the last error near
    the f64 floor) and line-search counts at the same iterations as JAX's,
    NaN / -1 elsewhere."""
    o = {**GENERIC_OPTS["cpu_branch"], "record_history": True}
    out_j = jtd.tdunes_solve(jax_qp("asym"), None, jtd.TdunesOpts(**o))
    out = tdunes_solve(port_qp("asym"), None, td.TdunesOpts(**o))
    err, ls = out.info["err_hist"].numpy(), out.info["ls_hist"].numpy()
    assert err.dtype == np.float64 and err.shape == ls.shape == (o["max_iter"],)
    np.testing.assert_array_equal(ls, np.asarray(out_j.info["ls_hist"]))
    np.testing.assert_allclose(err, np.asarray(out_j.info["err_hist"]), rtol=1e-9, atol=1e-12)
    n = out.info["iter"]
    assert np.isfinite(err[:n + 1]).all() and np.isnan(err[n + 1:]).all()
    assert (ls[n + 1:] == -1).all() and err[n] == out.info["error"]


DIMS = (2, 2, 2, 8)  # nm, md, Nr, Nh of the general C/D trees


@functools.lru_cache(maxsize=None)
def general_cd_instances(mode):
    """The general C/D tree of ``mode`` at spring_mass_chain(2,2,2,8) in
    both packages (general_cd_bench's builder, cut to DIMS)."""
    nm, md, Nr, Nh = DIMS
    with mock.patch.multiple(gcb, NM=nm, MD=md, NR=Nr, NH=Nh):
        qp_j = gcb.build("tdunes_" + mode)
    return qp_j, models.general_cd(mode, *DIMS, device="cpu")


@pytest.mark.parametrize("mode", ["qpgen", "mixed"])
def test_general_cd_at_the_cpu_branch_options(mode):
    """``tdunes_solve`` on the general C/D trees (spring_mass_chain(2,2,2,8)
    with rows on every node / every third node) at general_cd_bench's CPU
    options (``models.GENERAL_CD_CPU_OPTS``): a cold request, then a warm
    one (b + 1e-6, from the cold duals and working sets), each against the
    JAX package's with the same start; the final working sets equal."""
    qp_j, qp = general_cd_instances(mode)
    o = {**models.GENERAL_CD_CPU_OPTS, "stage_solver": mode}
    lam0 = ws0 = None
    for warm in (False, True):
        if warm:
            qp_j, qp = qp_j.replace(b=qp_j.b + 1e-6), qp.replace(b=qp.b + 1e-6)
        out_j = jtd.tdunes_solve(qp_j, lam0, jtd.TdunesOpts(**o), stage_ws=ws0)
        t = lambda v: None if v is None else torch.tensor(np.asarray(v))
        out = tdunes_solve(qp, t(lam0), td.TdunesOpts(**o),
                           stage_ws=None if ws0 is None else tuple(t(w) for w in ws0))
        check_out(qp_j, out_j, out_j.info, qp, out, out.info, o["tol"])
        assert out.info["qpgen_res"] < 1e-9
        for w, wj in zip(out.info["qpgen_ws"], out_j.info["qpgen_ws"]):
            np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
        lam0, ws0 = out_j.lam, out_j.info["qpgen_ws"]


def test_general_cd_cpu_opts_are_the_bench_tdunes_opts():
    """models.GENERAL_CD_CPU_OPTS is general_cd_bench's tdunes options off
    the TPU (general_cd_bench.py:94-125, on_tpu=False)."""
    bench = jtd.TdunesOpts(
        stage_solver="qpgen", tol=gcb.TOL / 4, max_iter=150, factor_dtype="same",
        refine_steps=0, refine_safeguard=False, qpgen_factor_dtype="same",
        chain_backend="xla", reg_type="on_the_fly", reg_value=1e-6, f32_phase_tol=0.0,
        f32_patience=3)
    assert td.TdunesOpts(**models.GENERAL_CD_CPU_OPTS) == td.TdunesOpts(
        **{f: getattr(bench, f) for f in bench.__dataclass_fields__})


SLICE = dict(stage_solver="clipping", tol=1e-8, max_iter=120, factor_dtype="float32",
             refine_steps=2, refine_safeguard=False, chain_backend="pallas",
             reg_type="always", reg_value=1e-6, f32_phase_tol=0.0, df64_phase=False)
MS_OPTS = {
    "defaults": ({}, None),
    # scen1024_bench's CPU options (scen1024_bench.py:43-50, on_tpu=False)
    "scen1024_cpu": (dict(stage_solver="clipping", tol=s1b.TOL, max_iter=150,
                          factor_dtype="same", refine_steps=0, refine_safeguard=False,
                          chain_backend="xla", reg_type="on_the_fly", reg_value=1e-6,
                          f32_phase_tol=0.0, df64_phase=False), None),
    # the bench path's coarse phase with the on-the-fly shift: the chain
    # kernels' twins, the crown's plain tree Cholesky, the per-kernel loop
    "two_phase_on_the_fly": ({**SLICE, "f32_phase_tol": 1e-4, "reg_type": "on_the_fly"},
                             dict(chain_backend="xla")),
}


@pytest.mark.parametrize("opts", sorted(MS_OPTS))
def test_tdunes_ms_solve_at_the_default_options(opts, monkeypatch):
    """``tdunes_ms_solve`` on quadcopter(2,2,6): at the JAX package's
    defaults and at scen1024_bench's CPU options (the portable backend: no
    kernel twin runs), and at the slice's options with the on-the-fly
    shift and the coarse phase (the coarse phase's per-kernel loop, the
    chain kernels' twins around the crown's plain tree Cholesky), the
    latter held against JAX's portable backend: the chain kernels do not
    shift their pivots, so the two routes agree where no chain pivot is at
    or below reg_tol, which the case asserts."""
    o, jax_over = MS_OPTS[opts]
    opts_t = td.TdunesOpts(**o)
    qp_j = jmodels.quadcopter(2, 2, 6).qp
    ms_j = jtm.split_multistage(qp_j)
    cro, cho, info_j = jtm.tdunes_ms_solve(ms_j, None, None,
                                           jtd.TdunesOpts(**{**o, **(jax_over or {})}))
    out_j = jtm.merge_output(ms_j, cro, cho, info_j)
    pivots = []
    for name in ("chain_blocks_factor", "chain_blocks_factor_lanes"):
        real = getattr(tm.ck, name)

        def recorded(*args, real=real):
            out = real(*args)
            pivots.append(float(torch.diagonal(out[0], dim1=-2, dim2=-1).min()))
            return out

        monkeypatch.setattr(tm.ck, name, recorded)
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    ms = tm.split_multistage(qp)
    cro, cho, info = tm.tdunes_ms_solve(ms, None, None, opts_t)
    check_out(qp_j, out_j, info_j, qp, tm.merge_output(ms, cro, cho, info), info,
              opts_t.tol)
    assert int(info_j["iter_f32"]) == info["iter_f32"]
    if opts_t.chain_backend == "xla":
        assert not pivots
    else:
        assert pivots and min(pivots) > opts_t.reg_tol


@pytest.mark.parametrize("solver", ["tdunes_ms_solve", "sdunes_solve"])
def test_chain_kernels_with_f64_factors_raise_in_both_packages(solver):
    """chain_backend="pallas" with factor_dtype="same": the JAX package's
    chain kernels refuse f64 operands (its Pallas chain_factor raises a
    ValueError), and the port, whose CUDA chain kernels are f32 too,
    raises a ValueError before any work."""
    if solver == "tdunes_ms_solve":
        qp_j = jmodels.quadcopter(2, 2, 6).qp
        o = {**SLICE, "factor_dtype": "same"}
        with pytest.raises(ValueError):
            jtm.tdunes_ms_solve(jtm.split_multistage(qp_j), None, None, jtd.TdunesOpts(**o))
        qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                                   device="cpu")
        with pytest.raises(ValueError, match="float32"):
            tm.tdunes_ms_solve(tm.split_multistage(qp), None, None, td.TdunesOpts(**o))
        return
    qp_j, _ = jmodels.spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    o = {**models.SDUNES_OPTS, "factor_dtype": "same"}
    with pytest.raises(ValueError):
        jsd.sdunes_solve(jsd.scenario_data(qp_j), None, None, jsd.SdunesOpts(**o))
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    with pytest.raises(ValueError, match="float32"):
        sd.sdunes_solve(sd.scenario_data(qp), None, None, sd.SdunesOpts(**o))


SD_OPTS = {"defaults": {}, "cpu_branch": dataclasses.asdict(sb._sdunes_opts(False))}


@pytest.mark.parametrize("opts", sorted(SD_OPTS))
def test_sdunes_solve_at_the_default_options(opts):
    """``sdunes_solve`` on spring_mass_chain(2,2,3,8) at ``SdunesOpts()`` and
    at sdunes_bench's CPU options (``_sdunes_opts(on_tpu=False)``): the
    JAX package's iterations, trajectories and tree duals (the scenario
    output: x, u within 1e-7, lambda within 1e-6), certified by the
    oracle."""
    o = SD_OPTS[opts]
    qp_j, _ = jmodels.spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    sqp_j, sqp = jsd.scenario_data(qp_j), sd.scenario_data(qp)
    sol_j, lam_j, mu_j, info_j = jsd.sdunes_solve(sqp_j, None, None, jsd.SdunesOpts(**o))
    sol, lam, mu, info = sd.sdunes_solve(sqp, None, None, sd.SdunesOpts(**o))
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert int(info_j["iter"]) == info["iter"]
    out = sd.scenario_output(sqp, sol, lam, mu, info)
    out_j = jsd.scenario_output(sqp_j, sol_j, lam_j, mu_j, info_j)
    assert max_kkt_residual(qp, out) < 1e-8
    for f, tol in (("x", X_TOL), ("u", U_TOL), ("lam", LAM_TOL)):
        assert np.abs(getattr(out, f).numpy() - np.asarray(getattr(out_j, f))).max() <= tol, f

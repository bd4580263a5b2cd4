"""PyTorch port, the general stage solvers of the generic-tree solver
against the JAX package on the same operands: ``_stage_data``'s general
keys, the general stage QPs ``_qpgen_batch`` (cold and hotstarted, at
qpgen_factor_dtype float32 and same, and at f32 data as in the coarse
phase), the mixed, boxqp and dense stage solves, the dual value, and the
general branches of ``_build_dual_hessian`` and ``_apply_M_nodes``.

Instances: the general C/D trees of test_torch_admm_kernel.py (a row on
every node, and general_cd_bench's every-third-node rows at the same dims)
and the dense-weights box QP of tests/test_boxqp_stage.py. Operands are
made with numpy and handed to both sides; the port's ADMM runs through
the kernel's plain twin (CPU tensors)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_boxqp_stage import _dense_bounded_qp
from treeqp_tpu.solvers import tdunes as jtd

from test_torch_admm_kernel import jax_cd, port_cd
from test_torch_chain_kernels import assert_close
from treeqp_tpu_torch import convert
from treeqp_tpu_torch.solvers import tdunes as td

torch.set_num_threads(1)

# _qpgen_batch's outputs: z and mu to 1e-9, P to 1e-8 (the lanes-vs-node
# bounds of tests/test_qpgen_lanes.py), working sets exactly
Z_TOL, MU_TOL, P_TOL = 1e-9, 1e-8, 1e-8
# at f32 data (the coarse phase): f32 rounding in another order
F32_RTOL = 1e-5
# f64 quantities computed in another order (stage data, M d, dual value)
F64_RTOL = 1e-12
# the dual-Hessian blocks, built in f32 from P's that agree to 1e-8
BLOCK_RTOL = 1e-6
GEN_KEYS = ("H", "Hd", "Hinv", "G", "lo", "hi", "m_lo", "m_hi", "rho_row", "L_admm",
            "GH", "GHG")


def t(v, dtype=torch.float64):
    return torch.tensor(np.asarray(v), dtype=dtype)


def opts_pair(mode, **over):
    """TdunesOpts of both packages for a stage solver (the node split of
    mixed derived from the data, as tdunes_solve does)."""
    kw = dict(stage_solver=mode, **over)
    if mode == "mixed":
        kw["node_solver"] = jtd.clipping_applicable_nodes(jax_cd(mode))
    return jtd.TdunesOpts(**kw), td.TdunesOpts(**kw)


@functools.lru_cache(maxsize=None)
def box_qp(free=False):
    """tests/test_boxqp_stage.py's dense-weights tree QP (boxqp), or the
    same without bounds (dense)."""
    qp_j = _dense_bounded_qp()
    if free:
        inf = 1e12
        qp_j = qp_j.replace(xmin=qp_j.xmin * 0 - inf, xmax=qp_j.xmax * 0 + inf,
                            umin=qp_j.umin * 0 - inf, umax=qp_j.umax * 0 + inf)
    return qp_j


def instance(mode):
    """(JAX qp, port qp) of a stage solver's instance."""
    if mode in ("qpgen", "mixed"):
        return jax_cd(mode), port_cd(mode)
    qp_j = box_qp(free=mode == "dense")
    return qp_j, convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                                       device="cpu")


def lam_at(qp_j, scale=1.0):
    return scale * np.random.default_rng(1).standard_normal((qp_j.topo.Nn, qp_j.topo.nxm))


@functools.lru_cache(maxsize=None)
def qpgen_operands(fdtype, scale=1.0):
    """hmod at a seeded dual point and the JAX stage data of the every-node
    instance, numpy."""
    qp_j = jax_cd("qpgen")
    jo, _ = opts_pair("qpgen", qpgen_factor_dtype=fdtype)
    qmod, rmod = jtd._modified_gradient(qp_j, jnp.asarray(lam_at(qp_j, scale)),
                                        jtd._get_prep(qp_j.topo))
    data = jtd._stage_data(qp_j, jo)
    return (np.concatenate([np.asarray(qmod), np.asarray(rmod)], axis=1),
            {k: np.asarray(data[k]) for k in td._QPGEN_KEYS + ("GH", "GHG")})


def both_batches(fdtype, ws=None, scale=1.0, dtype=np.float64):
    """JAX and port _qpgen_batch on the same operands (cast to ``dtype``)."""
    hmod, data = qpgen_operands(fdtype, scale)
    cast = lambda v: v.astype(dtype) if v.dtype != np.float32 else v
    hmod, data = cast(hmod), {k: cast(v) for k, v in data.items()}
    jo, o = opts_pair("qpgen", qpgen_factor_dtype=fdtype)
    keys = td._QPGEN_KEYS
    ref = jtd._qpgen_batch(jnp.asarray(hmod), *(jnp.asarray(data[k]) for k in keys), jo,
                           ws=None if ws is None else tuple(jnp.asarray(w) for w in ws),
                           GH=jnp.asarray(data["GH"]), GHG=jnp.asarray(data["GHG"]))
    got = td._qpgen_batch(torch.tensor(hmod), *(torch.tensor(data[k]) for k in keys),
                          o, ws=None if ws is None else tuple(torch.tensor(w) for w in ws),
                          GH=torch.tensor(data["GH"]), GHG=torch.tensor(data["GHG"]))
    return ref, got


def check_batch(ref, got, rtol=None):
    (z0, P0, mu0, res0, ws0), (z1, P1, mu1, res1, ws1) = ref, got
    if rtol is None:
        assert float(np.abs(np.asarray(z0) - z1.numpy()).max()) <= Z_TOL
        assert float(np.abs(np.asarray(mu0) - mu1.numpy()).max()) <= MU_TOL
        assert float(np.abs(np.asarray(P0) - P1.numpy()).max()) <= P_TOL
        assert float(res1) < 1e-9 and float(res0) < 1e-9
    else:
        for a, b in ((z1, z0), (mu1, mu0), (P1, P0)):
            assert_close(a.numpy(), b, rtol, "f32 batch")
    for a, b in zip(ws0, ws1):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("fdtype", ["float32", "same"])
def test_qpgen_batch_cold_matches_jax(fdtype):
    ref, got = both_batches(fdtype)
    check_batch(ref, got)
    # general rows are active at this point
    assert float(got[4][0][:, -1].sum() + got[4][1][:, -1].sum()) > 0


@pytest.mark.parametrize("start", ["solution_set", "empty_set"])
@pytest.mark.parametrize("fdtype", ["float32", "same"])
def test_qpgen_batch_hotstart_matches_jax(fdtype, start):
    """Hotstart from the working sets of a nearby point's cold solve (the
    guard passes: no ADMM), and from empty sets (the guard fails: the cold
    identification runs)."""
    _, cold = both_batches(fdtype, scale=1.001)
    ws = tuple(w.numpy() for w in cold[4])
    if start == "empty_set":
        ws = tuple(np.zeros_like(w) for w in ws)
    ref, got = both_batches(fdtype, ws=ws)
    check_batch(ref, got)
    np.testing.assert_array_equal(got[4][0].numpy(), both_batches(fdtype)[1][4][0].numpy())


def test_qpgen_batch_at_f32_data_matches_jax():
    """The coarse phase: f32 data, so no f32 factor split and one
    refinement pass, everything in f32."""
    check_batch(*both_batches("float32", dtype=np.float32), rtol=F32_RTOL)


@pytest.mark.parametrize("fdtype", ["float32", "same"])
@pytest.mark.parametrize("mode", ["qpgen", "mixed"])
def test_stage_data_general_keys_match_jax(mode, fdtype):
    qp_j, qp = instance(mode)
    jo, o = opts_pair(mode, qpgen_factor_dtype=fdtype)
    dj = jtd._stage_data(qp_j, jo)
    d = td._stage_data(qp, o, td._get_prep(qp.topo))
    for k in GEN_KEYS:
        assert d[k].dtype == (torch.float32 if k == "L_admm" and fdtype == "float32"
                              else torch.float64), k
        assert_close(d[k].numpy(), dj[k], 1e-6 if k == "L_admm" else F64_RTOL, k)
    for k in ("G", "lo", "hi", "m_lo", "m_hi"):
        np.testing.assert_array_equal(d[k].numpy(), np.asarray(dj[k]), err_msg=k)
    if mode == "mixed":
        idx = np.nonzero(np.asarray(o.node_solver) == 0)[0]
        np.testing.assert_array_equal(d["gen"]["idx"].numpy(), idx)
        assert 0 < len(idx) < qp.topo.Nn
        for k in td._QPGEN_KEYS:
            assert torch.equal(d["gen"][k], d[k][d["gen"]["idx"]]), k


@functools.lru_cache(maxsize=None)
def both_stage_solves(mode):
    """Each package's stage data and stage solve at the same dual point."""
    qp_j, qp = instance(mode)
    jo, o = opts_pair(mode, qpgen_factor_dtype="float32")
    lam = lam_at(qp_j, 0.3)
    dj = jtd._stage_data(qp_j, jo)
    sj = jtd._stage_solve(qp_j, jnp.asarray(lam), dj, jo, jtd._get_prep(qp_j.topo))
    prep = td._get_prep(qp.topo)
    d = td._stage_data(qp, o, prep)
    s = td._stage_solve(qp, t(lam), d, o, prep)
    return qp_j, qp, jo, o, lam, dj, sj, d, s, prep


@pytest.mark.parametrize("mode", ["qpgen", "mixed", "boxqp", "dense"])
def test_stage_solve_matches_jax(mode):
    *_, sj, d, s, prep = both_stage_solves(mode)
    for k in ("x", "u"):
        assert_close(s[k].numpy(), sj[k], Z_TOL, k)
    if mode == "dense":
        return
    assert_close(s["P"].numpy(), sj["P"], P_TOL, "P")
    if mode == "boxqp":
        assert_close(s["mu"].numpy(), sj["mu"], MU_TOL, "mu")
        np.testing.assert_array_equal(s["free"].numpy(), np.asarray(sj["free"]))
        assert float(s["boxqp_res"]) <= 1e-12
        # bounds are active at this point
        assert float(s["free"].sum()) < s["free"].numel()
        return
    for k in ("mu_x", "mu_u", "mu_d"):
        assert_close(s[k].numpy(), sj[k], MU_TOL, k)
    for a, b in zip(s["qpgen_ws"], sj["qpgen_ws"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(s["qpgen_res"]) < 1e-9


def test_mixed_stage_solve_keeps_the_clipping_nodes():
    """The mixed stage solve writes the qpgen results into the general
    nodes' rows only: the clipping nodes keep the clipping closed form and
    their diagonal elimination matrices."""
    qp_j, qp, jo, o, lam, dj, sj, d, s, prep = both_stage_solves("mixed")
    clip = np.asarray(o.node_solver) == 1
    xm, um, _ = td._masks(qp, prep)
    qmod, rmod = td._modified_gradient(qp, t(lam), prep)
    c = td._clip_solve(qp, qmod, rmod, d, xm, um)
    assert torch.equal(s["x"][clip], c["x"][clip])
    assert torch.equal(s["u"][clip], c["u"][clip])
    P_clip = s["P"][clip]
    assert torch.equal(P_clip, torch.diag_embed(torch.diagonal(P_clip, dim1=1, dim2=2)))
    assert s["qpgen_ws"][0].shape == (int((~clip).sum()), d["G"].shape[1])


@pytest.mark.parametrize("mode, h_diag", [
    ("qpgen", False), ("qpgen", True), ("mixed", False), ("mixed", True), ("boxqp", False),
    ("dense", False)])
def test_dual_value_matches_jax(mode, h_diag):
    """The general dual value, with the dense and (diagonal Hessians only,
    as tdunes_solve sets it) the elementwise quadratic form."""
    qp_j, qp, jo, o, lam, dj, sj, d, s, prep = both_stage_solves(mode)
    assert td.diag_weights_applicable(qp) == (mode in ("qpgen", "mixed"))
    jo, o = (jtd.dataclasses.replace(jo, h_diag=h_diag),
             td.dataclasses.replace(o, h_diag=h_diag))
    f = float(td._dual_value(qp, t(lam), s, d, o))
    fj = float(jtd._dual_value(qp_j, jnp.asarray(lam), sj, dj, jo))
    assert abs(f - fj) <= F64_RTOL * max(1.0, abs(fj))


@pytest.mark.parametrize("mode", ["qpgen", "mixed", "boxqp", "dense"])
def test_dual_hessian_general_matches_jax(mode):
    """W = Cf P Cf' + the kids' E P E' blocks and Ut = -E P Cf', built in
    f32 from each side's own stage solve."""
    qp_j, qp, jo, o, lam, dj, sj, d, s, prep = both_stage_solves(mode)
    Wj, Utj = jtd._build_dual_hessian(qp_j, sj, dj, jo, jtd._get_prep(qp_j.topo),
                                      dtype=jnp.float32)
    W, Ut = td._build_dual_hessian(qp, s, d, o, prep)
    assert W.dtype == Ut.dtype == torch.float32
    assert_close(W.numpy(), Wj, BLOCK_RTOL, "W")
    assert_close(Ut.numpy(), Utj, BLOCK_RTOL, "Ut")


@pytest.mark.parametrize("mode", ["qpgen", "mixed", "boxqp", "dense"])
def test_apply_M_general_matches_jax(mode):
    """The exact Hessian action of the refinement, zl = P hl, in f64."""
    qp_j, qp, jo, o, lam, dj, sj, d, s, prep = both_stage_solves(mode)
    dn = np.random.default_rng(2).standard_normal(lam.shape) * qp.topo.nonroot_x_mask
    ref = jtd._apply_M_nodes(qp_j, sj, dj, jnp.asarray(dn), jo, jtd._get_prep(qp_j.topo))
    got = td._apply_M_nodes(qp, s, d, t(dn), o, prep)
    assert_close(got.numpy(), ref, 1e-9, "M d")

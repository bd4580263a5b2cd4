"""PyTorch port, the high-precision phase's kernels: the plain twins of
chain_eval_df, crown_eval_df, chain_apply_df and crown_apply_df (what their
wrappers run on CPU tensors), and the phase functions of
``solvers/ms_df64.py`` built on them, against the JAX package's plain
double-float reference (``ms_df64.df_stage_solve``, ``df_residuals``,
``df_dual_value``, ``df_apply_M``: what the JAX tests pin its Pallas
kernels to), on the same inputs at dual points on the solver's path."""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import crown_kernels as jckr
from treeqp_tpu.ops import df64 as jdf
from treeqp_tpu.ops import df_eval_kernels as jdek
from treeqp_tpu.solvers import ms_df64 as jmd
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.solvers import tdunes_multistage as jtm

import chip_smoke
from test_torch_chain_kernels import CASES, POINTS
from test_torch_eval_kernels import EVAL_RTOL, assert_margin
from treeqp_tpu_torch import convert
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import crown_kernels as ckr
from treeqp_tpu_torch.ops import df_eval_kernels as dek
from treeqp_tpu_torch.solvers import ms_df64 as md
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

# bench.py's options (bench_opts(on_tpu=True))
BENCH = dict(stage_solver="clipping", tol=1e-8, max_iter=120, factor_dtype="float32",
             refine_steps=2, refine_safeguard=False, chain_backend="pallas",
             reg_type="always", reg_value=1e-6, f32_phase_tol=1e-4, f32_patience=3,
             df64_phase=True)
# native f64 against double-float (~48 bits): x, u, res and M d to
# RTOL * max(1, max|ref|), the dual value to RTOL relative
RTOL = 1e-12
# an active-set bit is compared exactly only where no clipping input sits
# this close to its bound (relative to max(1, |bound|)), unless both sides
# computed it identically
MARGIN = 1e-9
f32, f64 = torch.float32, torch.float64


def df_round(v):
    """v rounded to the double-float values the JAX side carries."""
    return torch.tensor(np.array(jdf.to_f64(jdf.from_f64(jnp.asarray(v.numpy())))))


@functools.lru_cache(maxsize=None)
def path_case(name, point):
    """Both sides' phase data at the dual point w * (the bench-option
    solution of the port), and an f32 direction: that solution's duals
    scaled to a largest entry of 1."""
    qp_j = CASES[name]()
    ms = tm.split_multistage(convert.qp_from_numpy(convert.qp_arrays(qp_j),
                                                   convert.topo_from(qp_j.topo),
                                                   device="cpu"))
    cro, cho, info = tm.tdunes_ms_solve(ms, None, None, td.TdunesOpts(**BENCH))
    assert info["status"] == 0 and info["iter_f32"] >= 1
    prep = td._get_prep(ms.meta.crown_topo)
    dd = md.make_dd(ms, prep)
    nrxm = dd["cr"]["nrxm"]
    w = POINTS[point]
    lam_cr = df_round(w * cro["lam"]) * nrxm
    lam_ch = df_round(w * cho["lam"])
    ms_j = jtm.split_multistage(qp_j)
    jprep = jtd._get_prep(ms_j.meta.crown_topo)
    jdd, jmeta = jmd.make_dd(ms_j, jtd.TdunesOpts(**BENCH), jprep)
    jlam_cr = jmd._mask(jdf.from_f64(jnp.asarray(lam_cr.numpy())), jdd["nrxm"])
    jlam_ch = jdf.from_f64(jnp.asarray(lam_ch.numpy()))
    jcr, jch = jmd.df_stage_solve(jdd, jmeta, jprep, jlam_cr, jlam_ch)
    scale = 1.0 / max(float(cro["lam"].abs().max()), float(cho["lam"].abs().max()))
    return dict(ms=ms, prep=prep, dd=dd, lam_cr=lam_cr, lam_ch=lam_ch,
                dcr=(scale * cro["lam"] * nrxm).to(f32), dch=(scale * cho["lam"]).to(f32),
                jprep=jprep, jdd=jdd, jmeta=jmeta, jlam_cr=jlam_cr, jlam_ch=jlam_ch,
                jcr=jcr, jch=jch)


def j64(v):
    """A double-float value of the JAX side as one f64 array."""
    return np.asarray(jdf.to_f64(v))


def assert_close(got, ref, what, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    bound = rtol * max(1.0, float(np.max(np.abs(ref))))
    assert float(np.max(np.abs(got - ref))) <= bound, what


def assert_sets(vU, vU_ref, lo, hi, mask, sets, sets_ref, what):
    """The active sets (Qinv or 0) agree in pattern and value, after
    asserting that no real clipping input lies within MARGIN of a bound
    unless both sides computed it identically (the pinned initial state
    gives exact ties)."""
    vU_ref = torch.tensor(np.array(vU_ref))
    for b in (lo, hi):
        gap = (vU - b).abs()
        near = (gap < MARGIN * b.abs().clamp(min=1.0)) & (mask > 0) & (vU != vU_ref)
        assert not near.any(), f"{what}: {int(near.sum())} inputs on a bound"
    np.testing.assert_array_equal(sets.numpy() != 0, np.asarray(sets_ref) != 0, what)
    assert_close(sets, sets_ref, what)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("point", sorted(POINTS))
def test_chain_eval_df_matches_jax(name, point):
    c = path_case(name, point)
    d, jch = c["dd"]["ch"], c["jch"]
    ch = dek.chain_eval_df_ref(d, c["lam_ch"])
    ones = torch.ones_like
    assert_sets(ch["xUnc"], j64(jch["xUnc"]), d["xmin"], d["xmax"], ones(d["xmin"]),
                ch["qt"], j64(jch["qt"]), "qt")
    assert_sets(ch["uUnc"], j64(jch["uUnc"]), d["umin"], d["umax"], ones(d["umin"]),
                ch["rt"], j64(jch["rt"]), "rt")
    for k in ("x", "u", "xUnc", "uUnc"):
        assert_close(ch[k], j64(jch[k]), k)
    jcqr = jmd._contract(c["jdd"]["ABp"][:, 0], c["jlam_ch"][:, 0], axis=1)
    assert_close(ch["cqr"], j64(jcqr), "cqr")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("point", sorted(POINTS))
def test_crown_eval_df_and_residuals_match_jax(name, point):
    """crown_eval_df after chain_eval_df (the roots' contributions at their
    crown nodes), the residuals with the chain row 0 completed, and the
    dual value from the kernels' partials through df_reduce_flat."""
    c = path_case(name, point)
    d, jcr = c["dd"]["cr"], c["jcr"]
    cr, ch = md.df_stage_solve(c["dd"], c["prep"], c["lam_cr"], c["lam_ch"])
    assert_sets(cr["xUnc"], j64(jcr["xUnc"]), d["xmin"], d["xmax"], d["xm"],
                cr["qtilde"], j64(jcr["qtilde"]), "qtilde")
    assert_sets(cr["uUnc"], j64(jcr["uUnc"]), d["umin"], d["umax"], d["um"],
                cr["rtilde"], j64(jcr["rtilde"]), "rtilde")
    for k in ("x", "u", "xUnc", "uUnc"):
        assert_close(cr[k], j64(jcr[k]), k)
    res_cr, res_ch = md.df_residuals(c["dd"], cr, ch)
    jres_cr, jres_ch = jmd.df_residuals(c["jdd"], c["jmeta"], c["jprep"], jcr, c["jch"])
    assert_close(res_cr, j64(jres_cr), "res_cr")
    assert_close(res_ch, j64(jres_ch), "res_ch")
    f = float(md.df_dual_value(cr, ch))
    jf = float(j64(jmd.df_dual_value(c["jdd"], c["jlam_cr"], c["jlam_ch"], jcr, c["jch"])))
    assert abs(f - jf) <= RTOL * abs(jf), (f, jf)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("point", sorted(POINTS))
def test_apply_df_matches_jax(name, point):
    """M d from chain_apply_df + crown_apply_df (the chains' root
    contributions of d at their crown nodes, row 0 completed) against the
    JAX df_apply_M, for the same f32 direction."""
    c = path_case(name, point)
    cr, ch = md.df_stage_solve(c["dd"], c["prep"], c["lam_cr"], c["lam_ch"])
    mcr, mch = md.df_apply_M(c["dd"], c["prep"], cr, ch, c["dcr"], c["dch"])
    jmcr, jmch = jmd.df_apply_M(c["jdd"], c["jmeta"], c["jprep"], c["jcr"], c["jch"],
                                jnp.asarray(c["dcr"].numpy()),
                                jnp.asarray(c["dch"].numpy()))
    assert float(np.max(np.abs(j64(jmcr)))) > 1e-3  # a direction that moves things
    assert_close(mcr, j64(jmcr), "M d crown")
    assert_close(mch, j64(jmch), "M d chains")


@pytest.mark.parametrize("name", sorted(CASES))
def test_index_lists_match_one_hot_schedule(name):
    """The kid lists and parents the crown kernels read against the JAX df
    kernels' one-hot parent matrix P_par and per-slot kid matrices P_kid:
    the same parent, and the same kid in each slot."""
    c = path_case(name, "zero")
    t = ckr.eval_sched(c["prep"], "cpu")
    NPc, K, P_par, P_kid = jdek._get_df_sched(c["jprep"])
    par, ptr, idx = (t[k].numpy() for k in ("par", "kid_ptr", "kid_idx"))
    Nn = len(par)
    assert par[0] == 0 and all(P_par[par[n], n] == 1.0 for n in range(1, Nn))
    assert int(P_par.sum()) == Nn - 1
    for n in range(Nn):
        kids = idx[ptr[n]:ptr[n + 1]]
        assert len(kids) <= K
        for k in range(K):
            col = np.nonzero(P_kid[k, :, n])[0]
            np.testing.assert_array_equal(col, kids[k:k + 1], f"node {n} slot {k}")
    assert int(P_kid.sum()) == len(idx) == Nn - 1


def test_cpu_wrappers_run_plain_twins():
    c = path_case("quadcopter", "half")
    dd, prep = c["dd"], c["prep"]
    ch = dek.chain_eval_df(dd["ch"], c["lam_ch"])
    for k, v in dek.chain_eval_df_ref(dd["ch"], c["lam_ch"]).items():
        assert v.dtype == f64 and torch.equal(ch[k], v), k
    extra = torch.zeros_like(dd["cr"]["ABt"][:, 0])
    extra[dd["rid"]] = ch["cqr"]
    cr = dek.crown_eval_df(dd["cr"], c["lam_cr"], extra, prep)
    for k, v in dek.crown_eval_df_ref(dd["cr"], c["lam_cr"], extra, prep).items():
        assert v.dtype == f64 and torch.equal(cr[k], v), k
    cha = dek.chain_apply_df(dd["ch"], ch["qt"], ch["rt"], c["dch"])
    for k, v in dek.chain_apply_df_ref(dd["ch"], ch["qt"], ch["rt"], c["dch"]).items():
        assert v.dtype == f64 and torch.equal(cha[k], v), k
    cargs = (dd["cr"], cr["qtilde"], cr["rtilde"], c["dcr"], extra, prep)
    cra = dek.crown_apply_df(*cargs)
    for k, v in dek.crown_apply_df_ref(*cargs).items():
        assert v.dtype == f64 and torch.equal(cra[k], v), k
    assert (dek.chain_eval_df.launches, dek.crown_eval_df.launches,
            dek.chain_apply_df.launches, dek.crown_apply_df.launches) == (0, 0, 0, 0)
    meta = lambda d: {k: v.to("meta") for k, v in d.items()}
    with pytest.raises(ValueError, match="expected"):
        dek.chain_eval_df(meta(dd["ch"]), c["lam_ch"].to("meta"))
    with pytest.raises(ValueError, match="expected"):
        dek.crown_eval_df(meta(dd["cr"]), c["lam_cr"].to("meta"), extra.to("meta"), prep)
    with pytest.raises(ValueError, match="expected"):
        dek.chain_apply_df(meta(dd["ch"]), ch["qt"].to("meta"), ch["rt"].to("meta"),
                           c["dch"].to("meta"))
    with pytest.raises(ValueError, match="expected"):
        dek.crown_apply_df(meta(dd["cr"]), cr["qtilde"].to("meta"),
                           cr["rtilde"].to("meta"), c["dcr"].to("meta"),
                           extra.to("meta"), prep)


def test_chain_df_launch():
    """The chain evaluation kernels' and chain_apply_df's launch
    (``chain_kernels.chain_node_launch``): at the bench path's S = 256
    chains of L = 16, one chain a block in 256 blocks of 16 threads, staged,
    in f64 and f32 (half the bytes), and at the f32 paths' captured shapes;
    at every edge of the card's smoke, in both element sizes, every chain
    whole in one block, S covered, and the staged tiles within a block's 227
    KB or the shape read from global memory."""
    launch = ck.chain_node_launch
    assert launch(256, 16, 6, 4, 8) == (1, 256, 16, True, 8736)
    assert launch(256, 16, 6, 4, 8, apply=True) == (1, 256, 16, True, 8096)
    assert launch(256, 16, 6, 4, 8, chains=8) == (8, 32, 128, True, 69664)
    # f32: the two-norm path's, tdunes_ms_f32's and the 1024-scenario path's
    assert launch(256, 16, 6, 4, 4) == (1, 256, 16, True, 4384)
    assert launch(256, 16, 8, 1, 4) == (1, 256, 16, True, 5280)
    assert launch(1024, 15, 6, 4, 4) == (1, 1024, 15, True, 4128)
    assert launch(256, 16, 6, 4, 4, chains=8) == (8, 32, 128, True, 34848)
    for S, L, nx, nu in chip_smoke.EVAL_DF_EDGES:
        for elem, apply in ((8, False), (8, True), (4, False)):
            C, blocks, threads, staged, smem = launch(S, L, nx, nu, elem, apply)
            assert C >= 1 and (C * L <= ck._NODE_THREADS or C == 1)
            assert (blocks - 1) * C < S <= blocks * C
            assert threads == min(C * L, ck._NODE_THREADS)
            assert smem <= ck._BLOCK_SMEM and smem % 16 == 0
            assert staged == (ck._node_smem(C, L, nx, nu, elem, apply, True) <= ck._BLOCK_SMEM)
    # nz = 32 (4 KB a node in f64, 2 KB in f32): 7 nodes are staged, 130
    # read from global memory in either
    assert launch(5, 7, 16, 16, 8)[3]
    assert not launch(2, 130, 16, 16, 8)[3]
    assert not launch(2, 130, 16, 16, 4)[3]
    assert not launch(5, 7, 16, 16, 8, chains=8)[3]
    assert launch(3, 130, 6, 4, 8)[:3] == (1, 3, 128)


# Pallas interpret mode on the CPU contracts the double-float error-free
# transforms (tests/test_df_eval_kernels.py): its kernels agree with native
# f64 to ~f32 ulps there
INTERPRET_TOL = 1e-6


def test_chain_twins_match_jax_kernels():
    """The plain twins of chain_eval_df and chain_apply_df against the JAX
    Pallas kernels (interpret mode) on seeded data at a tree of one-node
    chains with nu = 1 (one case: interpret mode takes seconds a shape):
    the same outputs to INTERPRET_TOL, the same active sets."""
    S, L, nx, nu = 3, 1, 3, 1
    data, lam, d = chip_smoke.eval_df_operands(torch, S, L, nx, nu, 7, "cpu")
    AB = data["ABt"].numpy()
    jdata = jdek.chain_eval_df_data(*(jnp.asarray(v) for v in (
        AB[..., :nx], AB[..., nx:], *(data[k].numpy() for k in (
            "q", "r", "Qd", "Rd", "xmin", "xmax", "umin", "umax", "b")))))
    jch = jdek.chain_eval_df(jdata, jdf.from_f64(jnp.asarray(lam.numpy())))
    ch = dek.chain_eval_df_ref(data, lam)
    nodes = lambda v: np.transpose(j64(v)[..., :S], (2, 0, 1))  # lane layout -> [S, L, n]
    for k in ("x", "u", "res_part", "cqr", "fch"):
        assert_close(ch[k], j64(jch[k]), k, INTERPRET_TOL)
    for k in ("xUnc", "uUnc", "qt", "rt"):
        assert_close(ch[k], nodes(jch[k]), k, INTERPRET_TOL)
    for k in ("qt", "rt"):
        np.testing.assert_array_equal(ch[k].numpy() != 0, nodes(jch[k]) != 0, k)
    ja = jdek.chain_apply_df(jdata, jch["qt"], jch["rt"], jnp.asarray(d.numpy()))
    a = dek.chain_apply_df_ref(data, ch["qt"], ch["rt"], d)
    for k in ("res_part", "cqr"):
        assert_close(a[k], j64(ja[k]), k, INTERPRET_TOL)
    for k in ("xl", "ul"):
        assert_close(a[k], nodes(ja[k]), k, INTERPRET_TOL)


# interpret mode on the CPU takes ~3 / ~6 s for crown_eval and ~11 / ~63 s
# for crown_apply_df at these two crowns, so crown_apply_df runs at the first
@pytest.mark.parametrize("edge, apply", [((40, 1, 6, 4), True), ((3, 2, 16, 16), False)])
def test_crown_twins_match_jax_kernels(edge, apply):
    """The plain twins of crown_eval (f32) and crown_apply_df against the
    JAX Pallas kernels (interpret mode) on two seeded crowns of
    chip_smoke.CROWN_EVAL_EDGES that the path cases lack: one node with 40
    kids, and nz = 32 (two columns a lane of the card's kernels).
    crown_eval to EVAL_RTOL with the same active sets, crown_apply_df to
    RTOL."""
    nx, nu = edge[2:]
    data, lam, extra, prep = chip_smoke.crown_eval_operands(torch, *edge, 11, "cpu")
    _, qt, rt, d, _, _ = chip_smoke.crown_apply_operands(torch, *edge, 11, "cpu")
    Nn = len(prep.par)
    AB = data["ABt"]
    qp = SimpleNamespace(A=AB[..., :nx], B=AB[..., nx:], Q=torch.diag_embed(data["Qd"]),
                         R=torch.diag_embed(data["Rd"]),
                         **{k: data[k] for k in ("q", "r", "b", "xmin", "xmax", "umin", "umax")})
    masks = (data["xm"], data["um"], data["nrxm"])
    jqp = SimpleNamespace(**{k: jnp.asarray(v.numpy()) for k, v in vars(qp).items()})
    jmasks = [jnp.asarray(m.numpy()) for m in masks]
    jprep = SimpleNamespace(Nn=Nn, par=np.asarray(prep.par))
    # crown_eval in f32, as the coarse phase runs it
    d32 = ckr.crown_eval_data(qp, prep, *masks)
    lam32, extra32 = lam.float(), extra.float()
    out = ckr.crown_eval_ref(d32, lam32, extra32, prep)
    jdata = jckr.crown_eval_data(jqp, jprep, *jmasks)
    NPc = jdata["ABt"].shape[-1]
    jextra = np.zeros((nx + nu, NPc), np.float32)
    jextra[:, :Nn] = extra32.numpy().T
    jout = jckr.crown_eval(jdata, jnp.asarray(lam32.numpy()), jnp.asarray(jextra))
    node = lambda v: np.asarray(v)[:, :Nn].T
    assert_margin(out["xUnc"], node(jout["xUnc"]), d32["xmin"], d32["xmax"], d32["xm"], "x")
    assert_margin(out["uUnc"], node(jout["uUnc"]), d32["umin"], d32["umax"], d32["um"], "u")
    for k in ("x", "u", "res"):
        assert_close(out[k], jout[k], k, EVAL_RTOL)
    for k in ("xUnc", "uUnc"):
        assert_close(out[k], node(jout[k]), k, EVAL_RTOL)
    for k in ("qtilde", "rtilde"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), k)
    assert_close(out["fcr"].sum().reshape(1), np.asarray(jout["fcr"]).reshape(1), "fcr",
                 EVAL_RTOL)
    if not apply:
        return
    # crown_apply_df: the f64 masked inverses and extra as double-float lanes
    jdd = jdek.crown_eval_df_data(jqp, jprep, *jmasks)
    lanes = lambda v: jdf.from_f64(jnp.asarray(np.pad(v.numpy().T, ((0, 0), (0, NPc - Nn)))))
    ja = jdek.crown_apply_df(jdd, lanes(qt), lanes(rt), jnp.asarray(d.numpy()), lanes(extra))
    a = dek.crown_apply_df_ref(data, qt, rt, d, extra, prep)
    assert float(a["res"].abs().max()) > 1e-3  # a direction that moves things
    for k in ("xl", "ul", "res"):
        assert_close(a[k], j64(ja[k]), k)

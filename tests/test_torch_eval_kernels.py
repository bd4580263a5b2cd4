"""PyTorch port, the coarse phase's evaluation kernels: the plain twins of
chain_eval, crown_eval and chain_blocks_factor_lanes (what their wrappers
run on CPU tensors) against the JAX Pallas kernels (interpret mode), on the
same f32 operands at dual points on the two-phase solver's path."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import chain_kernels as jck
from treeqp_tpu.ops import crown_kernels as jckr
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.solvers import tdunes_multistage as jtm

from test_torch_chain_kernels import CASES, POINTS, assert_close, jax_ref
from treeqp_tpu_torch import convert
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import crown_kernels as ckr
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

TWO_PHASE = td.TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=120,
                          factor_dtype="float32", refine_steps=2,
                          refine_safeguard=False, chain_backend="pallas",
                          reg_type="always", reg_value=1e-6, f32_phase_tol=1e-4)
# f32 evaluations on both sides; the sums differ only where XLA contracts
# a product into an FMA or orders a one-hot matmul's sum otherwise
EVAL_RTOL = 1e-5
# factors of the same blocks (tests/test_torch_chain_kernels.py)
FACTOR_RTOL = 1e-5
# an active-set bit is compared exactly only where no clipping input sits
# this close to its bound (relative to max(1, |bound|))
MARGIN = 1e-6
f32 = torch.float32


def split_case(qp_j):
    """The port's multistage split of the JAX package's tree QP ``qp_j``."""
    return tm.split_multistage(convert.qp_from_numpy(convert.qp_arrays(qp_j),
                                                     convert.topo_from(qp_j.topo),
                                                     device="cpu"))


@functools.lru_cache(maxsize=None)
def path_case(name, point):
    """Both sides' f32 evaluation data, and a dual point w * (the two-phase
    solution) of the port, masked as the solver carries it."""
    qp_j = CASES[name]()
    ms = split_case(qp_j)
    cro, cho, info = tm.tdunes_ms_solve(ms, None, None, TWO_PHASE)
    assert info["status"] == 0 and info["iter_f32"] >= 1
    w = POINTS[point]
    return eval_case(qp_j, ms, w * cro["lam"], w * cho["lam"])


def eval_case(qp_j, ms, lam_cr, lam_ch):
    """Both sides' f32 evaluation data of ``qp_j`` (``ms`` the port's split
    of it) and the dual point (lam_cr, lam_ch), masked as the solver
    carries it."""
    ms32 = ms.to(dtype=f32)
    prep = td._get_prep(ms.meta.crown_topo)
    data_ch, data_cr = tm._eval_data(ms32, prep)
    lam_cr = lam_cr.to(f32) * data_cr["nrxm"]
    lam_ch = lam_ch.to(f32)
    ms_j = jtm._cast_ms(jtm.split_multistage(qp_j), jnp.float32)
    jprep = jtd._get_prep(ms_j.meta.crown_topo)
    jdata_ch = jck.chain_eval_data(ms_j.A, ms_j.B, ms_j.q, ms_j.r, ms_j.Qd, ms_j.Rd,
                                   ms_j.xmin, ms_j.xmax, ms_j.umin, ms_j.umax, ms_j.b)
    jdata_cr = jckr.crown_eval_data(ms_j.crown, jprep, *jtd._masks(ms_j.crown))
    return dict(ms=ms32, prep=prep, data_ch=data_ch, data_cr=data_cr,
                lam_cr=lam_cr, lam_ch=lam_ch, ms_j=ms_j, jprep=jprep,
                jdata_ch=jdata_ch, jdata_cr=jdata_cr)


def assert_margin(vU, vU_ref, lo, hi, mask, what):
    """No real clipping input within MARGIN of a bound unless both sides
    computed it bit for bit alike (an exact tie, e.g. 0 against the pinned
    initial state's bound 0): elsewhere near a bound the active set is
    decided by rounding, and the exact comparison below would test the
    summation order, not the kernel."""
    vU_ref = torch.as_tensor(np.array(vU_ref))
    for b in (lo, hi):
        gap = (vU - b).abs()
        near = (gap < MARGIN * b.abs().clamp(min=1.0)) & (mask > 0) & (vU != vU_ref)
        assert not near.any(), f"{what}: {int(near.sum())} inputs on a bound"


def lanes_to_chains(v, S):
    """JAX lane layout [L, n, S_pad] -> [S, L, n]."""
    return np.transpose(np.asarray(v)[..., :S], (2, 0, 1))


def crown_extra(case, cqr):
    """The chain-root contributions at their crown nodes, [Nn, nz]."""
    extra = torch.zeros_like(case["data_cr"]["ABt"][:, 0])
    extra[torch.as_tensor(case["ms"].meta.root_ids)] = cqr
    return extra


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("point", sorted(POINTS))
def test_chain_eval_matches_pallas(name, point):
    c = path_case(name, point)
    d = c["data_ch"]
    out = ck.chain_eval_ref(d, c["lam_ch"])
    jout = jax_ref(jck.chain_eval, c["jdata_ch"], jnp.asarray(c["lam_ch"].numpy()))
    S = c["ms"].meta.S
    ones = torch.ones_like
    assert_margin(out["xUnc"], lanes_to_chains(jout["xUnc"], S), d["xmin"],
                  d["xmax"], ones(d["xmin"]), "x")
    assert_margin(out["uUnc"], lanes_to_chains(jout["uUnc"], S), d["umin"],
                  d["umax"], ones(d["umin"]), "u")
    for k in ("x", "u", "res_part", "cqr"):
        assert_close(out[k], jout[k], EVAL_RTOL, k)
    for k in ("xUnc", "uUnc"):
        assert_close(out[k], lanes_to_chains(jout[k], S), EVAL_RTOL, k)
    for k in ("qt", "rt"):
        np.testing.assert_array_equal(out[k].numpy(), lanes_to_chains(jout[k], S), k)
    assert_close(out["fch"].sum().reshape(1), np.asarray(jout["fch"]).reshape(1),
                 EVAL_RTOL, "fch")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("point", sorted(POINTS))
def test_crown_eval_matches_pallas(name, point):
    c = path_case(name, point)
    d = c["data_cr"]
    extra = crown_extra(c, ck.chain_eval_ref(c["data_ch"], c["lam_ch"])["cqr"])
    out = ckr.crown_eval_ref(d, c["lam_cr"], extra, c["prep"])
    Nn = d["ABt"].shape[0]
    NPc = c["jdata_cr"]["ABt"].shape[-1]
    jextra = np.zeros((extra.shape[1], NPc), np.float32)
    jextra[:, :Nn] = extra.numpy().T
    jout = jax_ref(jckr.crown_eval, c["jdata_cr"], jnp.asarray(c["lam_cr"].numpy()),
                   jnp.asarray(jextra))
    node = lambda v: np.asarray(v)[:, :Nn].T
    assert_margin(out["xUnc"], node(jout["xUnc"]), d["xmin"], d["xmax"], d["xm"], "x")
    assert_margin(out["uUnc"], node(jout["uUnc"]), d["umin"], d["umax"], d["um"], "u")
    for k in ("x", "u", "res"):
        assert_close(out[k], jout[k], EVAL_RTOL, k)
    for k in ("xUnc", "uUnc"):
        assert_close(out[k], node(jout[k]), EVAL_RTOL, k)
    for k in ("qtilde", "rtilde"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), k)
    assert_close(out["fcr"].sum().reshape(1), np.asarray(jout["fcr"]).reshape(1),
                 EVAL_RTOL, "fcr")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("point", sorted(POINTS))
def test_chain_blocks_factor_lanes_matches_pallas(name, point):
    """The factorize fed from the chain evaluation: each side's own
    evaluation outputs (whose active sets the test above holds equal) and
    the same crown-root operands."""
    c = path_case(name, point)
    ch = ck.chain_eval_ref(c["data_ch"], c["lam_ch"])
    extra = crown_extra(c, ch["cqr"])
    cr = ckr.crown_eval_ref(c["data_cr"], c["lam_cr"], extra, c["prep"])
    ctx = tm._solve_ctx(c["ms"], c["prep"])
    args = tm._factor_inputs(cr["qtilde"], cr["rtilde"], ch["qt"], ch["rt"],
                             c["prep"], ctx, lanes=True)["chain"]
    Ls, CUs, schur0, sc = ck.chain_blocks_factor_lanes_ref(*args)
    jch = jax_ref(jck.chain_eval, c["jdata_ch"], jnp.asarray(c["lam_ch"].numpy()))
    jLs, jCUs, jschur0, jsc = jax_ref(
        jck.chain_blocks_factor_lanes, c["jdata_ch"]["ABt"], jch["qt"], jch["rt"],
        jnp.asarray(args[3].numpy()), jnp.asarray(args[4].numpy()))
    S = c["ms"].meta.S
    lanes4 = lambda v: np.transpose(np.asarray(v)[..., :S], (3, 0, 1, 2))
    assert_close(Ls, lanes4(jLs), FACTOR_RTOL, "Ls")
    assert_close(CUs, lanes4(jCUs), FACTOR_RTOL, "CUs")
    assert_close(schur0, jschur0, FACTOR_RTOL, "schur0")
    assert_close(sc, jsc, FACTOR_RTOL, "sc")


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_sched_matches_parent_matrix(name):
    """The kid lists and parents of the crown evaluation against the JAX
    kernel's one-hot parent matrix."""
    c = path_case(name, "zero")
    t = ckr.eval_sched(c["prep"], "cpu")
    NPc, P = jckr._get_eval_sched(c["jprep"])
    par, ptr, idx = (t[k].numpy() for k in ("par", "kid_ptr", "kid_idx"))
    Nn = len(par)
    assert par[0] == 0 and all(P[par[n], n] == 1.0 for n in range(1, Nn))
    for n in range(Nn):
        np.testing.assert_array_equal(np.sort(idx[ptr[n]:ptr[n + 1]]),
                                      np.nonzero(P[n, :Nn])[0])
    assert int(P.sum()) == len(idx) == Nn - 1


def test_eval_cpu_wrappers_run_plain_twins():
    c = path_case("quadcopter", "half")
    ch = ck.chain_eval(c["data_ch"], c["lam_ch"])
    for k, v in ck.chain_eval_ref(c["data_ch"], c["lam_ch"]).items():
        assert torch.equal(ch[k], v), k
    extra = crown_extra(c, ch["cqr"])
    cr = ckr.crown_eval(c["data_cr"], c["lam_cr"], extra, c["prep"])
    for k, v in ckr.crown_eval_ref(c["data_cr"], c["lam_cr"], extra, c["prep"]).items():
        assert torch.equal(cr[k], v), k
    args = (c["data_ch"]["ABt"], ch["qt"], ch["rt"],
            torch.ones((c["ms"].meta.S, c["data_ch"]["ABt"].shape[-1])),
            torch.ones((c["ms"].meta.S, c["ms"].meta.nx)))
    for a, b in zip(ck.chain_blocks_factor_lanes(*args),
                    ck.chain_blocks_factor_lanes_ref(*args)):
        assert torch.equal(a, b)
    assert ck.chain_eval.launches == ckr.crown_eval.launches == 0
    assert ck.chain_blocks_factor_lanes.launches == 0
    meta = lambda d: {k: v.to("meta") for k, v in d.items()}
    with pytest.raises(ValueError, match="expected"):
        ck.chain_eval(meta(c["data_ch"]), c["lam_ch"].to("meta"))
    with pytest.raises(ValueError, match="expected"):
        ckr.crown_eval(meta(c["data_cr"]), c["lam_cr"].to("meta"),
                       extra.to("meta"), c["prep"])
    with pytest.raises(ValueError, match="expected"):
        ck.chain_blocks_factor_lanes(*(a.to("meta") for a in args))

"""PyTorch port, the IPM's Riccati kernels: the plain twins of the five
CUDA kernels (ric_chain_factor, ric_chain_bwd, ric_chain_fwd,
crown_ric_factor, crown_ric_solve; what the wrappers run on CPU tensors)
against the JAX Pallas kernels in interpret mode, on the same numpy-seeded
f32 operands: diagonal and dense (general-row) stage Hessians, a case with
S > 128 (two lane tiles of the TPU kernels), and the crown of a multistage
tree with the chains' boundary terms at its chain roots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import crown_riccati as jcr
from treeqp_tpu.ops import riccati_kernels as jrk
from treeqp_tpu.solvers import ipm as jipm
from treeqp_tpu.utils.tree import TreeStructure as JTree

from treeqp_tpu_torch import convert
from treeqp_tpu_torch.ops import crown_riccati as crk
from treeqp_tpu_torch.ops import riccati_kernels as rk
from treeqp_tpu_torch.solvers import ipm

torch.set_num_threads(1)

# f32 on both sides, the same per-element order, FMA-free on the CPU:
# factors to 1e-5 x max(1, max|ref|), solves to 1e-4 (ROADMAP tolerances)
FACTOR_RTOL, SOLVE_RTOL = 1e-5, 1e-4
# (S, L, nx, nz, dense)
CHAIN_CASES = {"diag": (5, 4, 4, 5, False), "dense": (5, 4, 4, 5, True),
               "diag_two_controls": (3, 3, 3, 5, False),
               "dense_S144": (144, 2, 2, 3, True)}


def close(got, ref, rtol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    err = np.abs(got - ref).max()
    assert err <= rtol * max(1.0, np.abs(ref).max()), (what, err)


def chain_operands(S, L, nx, nz, dense, seed=0):
    """SPD stage Hessians (a barrier-like diagonal, plus G'G of two rows
    when dense) and edge dynamics, f32."""
    rng = np.random.default_rng(seed)
    hb = 1.0 + rng.random((S, L, nz))
    if dense:
        G = rng.standard_normal((S, L, 2, nz))
        hb = np.einsum("slci,slcj->slij", G, G) + np.einsum("sli,ij->slij", hb, np.eye(nz))
    AB = 0.5 * rng.standard_normal((S, L, nx, nz))
    rg = rng.standard_normal((S, L, nz))
    rb = rng.standard_normal((S, L, nx))
    zr = rng.standard_normal((S, nz))
    return [a.astype(np.float32) for a in (hb, AB, rg, rb, zr)]


@pytest.fixture(scope="module", params=sorted(CHAIN_CASES))
def chain_case(request):
    S, L, nx, nz, dense = CHAIN_CASES[request.param]
    hb, AB, rg, rb, zr = chain_operands(S, L, nx, nz, dense)
    fj, W0j = jrk.ric_chain_factor(jnp.asarray(hb), jnp.asarray(AB))
    pj, kj, w0j = jrk.ric_chain_bwd(fj, jnp.asarray(rg), jnp.asarray(rb))
    dzj, dlj = jrk.ric_chain_fwd(fj, pj, kj, jnp.asarray(rb), jnp.asarray(zr))
    jax_out = dict(fact={k: np.asarray(jrk._from_kernel(fj[k], S))
                         for k in ("P", "Luu", "K", "Mxu")},
                   W0=np.asarray(W0j), p=np.asarray(jrk._from_kernel(pj, S)),
                   k=np.asarray(jrk._from_kernel(kj, S)), w0=np.asarray(w0j),
                   dz=np.asarray(dzj), dl=np.asarray(dlj))
    t = lambda a: torch.tensor(a)
    return dict(ops=(t(hb), t(AB), t(rg), t(rb), t(zr)), jax=jax_out)


def test_ric_chain_factor_matches_pallas(chain_case):
    hb, AB, *_ = chain_case["ops"]
    ref = chain_case["jax"]
    fact, W0 = rk.ric_chain_factor(hb, AB)
    for k in ("P", "Luu", "K", "Mxu"):
        close(fact[k], ref["fact"][k], FACTOR_RTOL, k)
    close(W0, ref["W0"], FACTOR_RTOL, "W0")
    assert torch.equal(fact["P"], fact["P"].mT)


def test_ric_chain_sweeps_match_pallas(chain_case):
    hb, AB, rg, rb, zr = chain_case["ops"]
    ref = chain_case["jax"]
    fact, _ = rk.ric_chain_factor(hb, AB)
    p, k, w0 = rk.ric_chain_bwd(fact, rg, rb)
    for name, v in (("p", p), ("k", k), ("w0", w0)):
        close(v, ref[name], SOLVE_RTOL, name)
    dz, dl = rk.ric_chain_fwd(fact, p, k, rb, zr)
    close(dz, ref["dz"], SOLVE_RTOL, "dz")
    close(dl, ref["dl"], SOLVE_RTOL, "dl")


def test_ric_chain_twins_solve_the_chain_system():
    """The twins' sweeps solve the equality-constrained chain KKT system
    their factors describe (the plain f64 sweeps of ipm_multistage give
    the same step on f64 operands)."""
    from treeqp_tpu_torch.solvers import ipm_multistage as im
    hb, AB, rg, rb, zr = (torch.tensor(a, dtype=torch.float64)
                          for a in chain_operands(4, 5, 3, 4, True, seed=1))
    fact, W0 = rk.ric_chain_factor_ref(hb, AB)
    plain = im._chain_riccati_factor(hb, AB, ipm.IpmOpts())
    for k in ("P", "Luu", "K", "Mxu"):
        close(fact[k], plain[k], 1e-12, k)
    close(W0, plain["W0"], 1e-12, "W0")
    got = rk.ric_chain_fwd_ref(fact, *rk.ric_chain_bwd_ref(fact, rg, rb)[:2], rb, zr)
    want = im._chain_riccati_fwd(plain, *im._chain_riccati_bwd(plain, rg, rb)[:2], rb, zr)
    for a, b in zip(got, want):
        close(a, b, 1e-12, "sweep")


@pytest.fixture(scope="module")
def crown_case():
    """The crown (stages 0..2, 13 nodes) of a multistage tree md=3, Nr=2,
    its 9 stage-2 nodes carrying chain boundary terms, and a whole small
    tree (31 nodes, 5 stages) without them; nx=4, nz=5."""
    rng = np.random.default_rng(2)
    out = {}
    for tag, (md, Nr, Nh), boundary in (("crown", (3, 2, 2), True),
                                        ("tree", (3, 2, 4), False)):
        topo = JTree.multistage(md=md, Nr=Nr, Nh=Nh, nx=4, nu=1)
        Nc, nx, nz = topo.Nn, 4, 5
        hb = (1.0 + rng.random((Nc, nz))).astype(np.float32)
        AB = (0.5 * rng.standard_normal((Nc, nx, nz))).astype(np.float32)
        AB[0] = 0.0
        W0 = np.zeros((Nc, nz, nz), np.float32)
        w0 = np.zeros((Nc, nz), np.float32)
        if boundary:
            leaves = np.nonzero(topo.stage == Nh)[0]
            X = rng.standard_normal((len(leaves), 3, nz))
            W0[leaves] = np.einsum("lci,lcj->lij", X, X)
            w0[leaves] = rng.standard_normal((len(leaves), nz))
        rg = rng.standard_normal((Nc, nz)).astype(np.float32)
        rb = rng.standard_normal((Nc, nx)).astype(np.float32)
        rb[0] = 0.0
        jprep = jipm._get_ipm_prep(topo)
        fj = jcr.crown_ric_factor(jnp.asarray(hb), jnp.asarray(AB), jnp.asarray(W0),
                                  jprep, nx=nx)
        dzj, dlj = jcr.crown_ric_solve(fj, jnp.asarray(rg), jnp.asarray(rb),
                                       jnp.asarray(w0), jprep)
        prep = ipm._get_ipm_prep(convert.topo_from(topo))
        t = lambda a: torch.tensor(a)
        out[tag] = dict(
            ops=(t(hb), t(AB), t(W0), t(rg), t(rb), t(w0)), prep=prep, nx=nx,
            fact={k: np.asarray(jcr._unlanes(fj[k], Nc)) for k in ("P", "Luu", "K", "Mxu")},
            dz=np.asarray(dzj), dl=np.asarray(dlj))
    return out


@pytest.mark.parametrize("tag", ["crown", "tree"])
def test_crown_ric_factor_matches_pallas(crown_case, tag):
    c = crown_case[tag]
    hb, AB, W0, *_ = c["ops"]
    fact = crk.crown_ric_factor(hb, AB, W0, c["prep"], c["nx"])
    for k in ("P", "Luu", "K", "Mxu"):
        close(fact[k], c["fact"][k], FACTOR_RTOL, k)


@pytest.mark.parametrize("tag", ["crown", "tree"])
def test_crown_ric_solve_matches_pallas(crown_case, tag):
    c = crown_case[tag]
    hb, AB, W0, rg, rb, w0 = c["ops"]
    fact = crk.crown_ric_factor(hb, AB, W0, c["prep"], c["nx"])
    dz, dl = crk.crown_ric_solve(fact, rg, rb, w0, c["prep"])
    close(dz, c["dz"], SOLVE_RTOL, "dz")
    close(dl, c["dl"], SOLVE_RTOL, "dl")


def test_crown_schedule_lists_each_node_once(crown_case):
    """The level schedule: every node on exactly one level, deepest stage
    first and the root last; each non-root node's parent in the next
    level's accumulation list."""
    prep = crown_case["tree"]["prep"]
    sched = crk._get_sched(prep)
    topo = prep.topo
    assert np.array_equal(np.sort(sched.lev_node), np.arange(topo.Nn))
    assert sched.lev_node[-1] == 0 and sched.n_lev == topo.Nh + 1
    for r, (nodes, pars, kk) in enumerate(sched.levels("cpu")):
        assert (topo.stage[nodes.numpy()] == topo.Nh - r).all()
        kids = kk[kk >= 0].numpy()
        assert np.array_equal(np.sort(kids), np.sort(nodes.numpy()[nodes.numpy() != 0]))

"""PyTorch port, the IPM's Riccati kernels: the plain twins of the five
CUDA kernels (ric_chain_factor, ric_chain_bwd, ric_chain_fwd,
crown_ric_factor, crown_ric_solve; what the wrappers run on CPU tensors)
against the JAX Pallas kernels in interpret mode, on the same numpy-seeded
f32 operands: diagonal and dense (general-row) stage Hessians, a case with
S > 128 (two lane tiles of the TPU kernels), and the crown of a multistage
tree with the chains' boundary terms at its chain roots. Past nz = 16 (the
CUDA kernels' 32-lane instantiation) also against JAX's XLA Riccati, the
path JAX takes there at chain_backend "xla" and, for the crown, always."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.ops import crown_riccati as jcr
from treeqp_tpu.ops import riccati_kernels as jrk
from treeqp_tpu.solvers import ipm as jipm
from treeqp_tpu.solvers import ipm_multistage as jims
from treeqp_tpu.utils.tree import TreeStructure as JTree

import chip_smoke
from treeqp_tpu_torch import convert
from treeqp_tpu_torch.ops import crown_riccati as crk
from treeqp_tpu_torch.ops import riccati_kernels as rk
from treeqp_tpu_torch.solvers import ipm
from treeqp_tpu_torch.utils.tree import TreeStructure

torch.set_num_threads(1)

# f32 on both sides, the same per-element order, FMA-free on the CPU:
# factors to 1e-5 x max(1, max|ref|), solves to 1e-4 (ROADMAP tolerances)
FACTOR_RTOL, SOLVE_RTOL = 1e-5, 1e-4
# (S, L, nx, nz, dense); then six at the CUDA kernels' edges
# (chip_smoke.RIC_EDGES): nz 8 and 9 on either side of their 8 / 16-lane
# switch, nz = 16 with nx = 15 in one stage and with nu = 2, two stages
# (fewer than the rings hold), S = 5 no multiple of the chains a warp
# holds, both hbar forms; and nz = 23 with nx = 16 (the reference's largest
# linear chain), the 32-lane instantiation
CHAIN_CASES = {"diag": (5, 4, 4, 5, False), "dense": (5, 4, 4, 5, True),
               "diag_two_controls": (3, 3, 3, 5, False),
               "dense_S144": (144, 2, 2, 3, True),
               "diag_nz8": (5, 3, 7, 8, False), "dense_nz9": (5, 3, 8, 9, True),
               "dense_nz16_nx15_L1": (5, 1, 15, 16, True),
               "diag_L2": (5, 2, 4, 5, False), "dense_nz16_nu2": (5, 3, 14, 16, True),
               "diag_nz23": (5, 3, 16, 23, False)}
# past nz = 16 against JAX's XLA chain Riccati (ipm_multistage's
# _chain_riccati_*): dense at nz = 23 (nx = 16), nz = 32 with nx = 31
# and, dense, with nx = 4 (a wide nu)
XLA_CHAIN_CASES = {"dense_nz23": (5, 4, 16, 23, True), "diag_nz32": (5, 3, 31, 32, False),
                   "dense_nz32_nx4": (3, 3, 4, 32, True)}


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


@pytest.mark.parametrize("case", sorted(XLA_CHAIN_CASES))
def test_ric_chain_twins_match_xla(case):
    """The chain twins against JAX's XLA chain Riccati in f32 past nz = 16:
    factors to FACTOR_RTOL, the sweeps to SOLVE_RTOL."""
    S, L, nx, nz, dense = XLA_CHAIN_CASES[case]
    hb, AB, rg, rb, zr = chain_operands(S, L, nx, nz, dense, seed=3)
    fj = jims._chain_riccati_factor(jnp.asarray(hb), jnp.asarray(AB), jipm.IpmOpts())
    pj, kj, w0j = jims._chain_riccati_bwd(fj, jnp.asarray(rg), jnp.asarray(rb))
    dzj, dlj = jims._chain_riccati_fwd(fj, pj, kj, jnp.asarray(rb), jnp.asarray(zr))
    t = torch.tensor
    fact, W0 = rk.ric_chain_factor(t(hb), t(AB), jipm.IpmOpts().reg_eps)
    for k in ("P", "Luu", "K", "Mxu"):
        close(fact[k], fj[k], FACTOR_RTOL, k)
    close(W0, fj["W0"], FACTOR_RTOL, "W0")
    p, k, w0 = rk.ric_chain_bwd(fact, t(rg), t(rb))
    dz, dl = rk.ric_chain_fwd(fact, p, k, t(rb), t(zr))
    for name, got, ref in (("p", p, pj), ("k", k, kj), ("w0", w0, w0j), ("dz", dz, dzj),
                           ("dl", dl, dlj)):
        close(got, ref, SOLVE_RTOL, name)


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


def test_crown_ric_twins_match_xla_nz23():
    """The crown twins at nz = 23 against JAX's XLA tree Riccati
    (ipm._riccati_factor / _riccati_solve in f32, what JAX runs above nz =
    16) on the linear chain of nm = 8, nu = 7 (md=3, Nr=2, Nh=3: 22 nodes),
    its leaves carrying chain boundary terms: factors to FACTOR_RTOL, dz and
    dlam to SOLVE_RTOL."""
    qp_j = jmodels.linear_chain(nm=8, nu_count=7, md=3, Nr=2, Nh=3).qp
    topo = qp_j.topo
    Nc, nx, nz = topo.Nn, topo.nxm, topo.nxm + topo.num
    rng = np.random.default_rng(5)
    hb = (1.0 + rng.random((Nc, nz))).astype(np.float32)
    AB = np.concatenate([np.asarray(qp_j.A), np.asarray(qp_j.B)], axis=2).astype(np.float32)
    W0 = np.zeros((Nc, nz, nz), np.float32)
    w0 = np.zeros((Nc, nz), np.float32)
    leaves = np.nonzero(topo.stage == topo.Nh)[0]
    X = rng.standard_normal((len(leaves), 3, nz))
    W0[leaves] = np.einsum("lci,lcj->lij", X, X)
    w0[leaves] = rng.standard_normal((len(leaves), nz))
    rg = rng.standard_normal((Nc, nz)).astype(np.float32)
    rb = rng.standard_normal((Nc, nx)).astype(np.float32)
    rb[0] = 0.0
    jprep = jipm._get_ipm_prep(topo)
    fj = jipm._riccati_factor(qp_j, jnp.asarray(np.einsum("ni,ij->nij", hb, np.eye(nz))),
                              jprep, jipm.IpmOpts(), fdt=jnp.float32, Wsum0=jnp.asarray(W0))
    dzj, dlj = jipm._riccati_solve(qp_j, fj, jnp.asarray(rg), jnp.asarray(rb), jprep,
                                   wsum0=jnp.asarray(w0))
    prep = ipm._get_ipm_prep(convert.topo_from(topo))
    t = torch.tensor
    fact = crk.crown_ric_factor(t(hb), t(AB), t(W0), prep, nx)
    for k in ("P", "Luu", "K", "Mxu"):
        close(fact[k], np.asarray(fj[k])[:Nc], FACTOR_RTOL, k)
    dz, dl = crk.crown_ric_solve(fact, t(rg), t(rb), t(w0), prep)
    close(dz, dzj, SOLVE_RTOL, "dz")
    close(dl, dlj, SOLVE_RTOL, "dl")


def test_wrappers_take_nz_up_to_32():
    """The shape checks the wrappers run before a launch (on CUDA tensors
    only): nz = 32 passes, nz = 33 raises, naming the bound 32."""
    assert rk._MAX_NZ == 32
    rk._check_dims("ric_chain_factor", 2, 3, 31, 32)
    with pytest.raises(ValueError, match="nz <= 32"):
        rk._check_dims("ric_chain_factor", 2, 3, 31, 33)
    sched = crk._get_sched(ipm._get_ipm_prep(TreeStructure.multistage(2, 1, 2, 31, 1)))
    Nc = len(sched.par)
    crk._check("crown_ric_factor", sched, Nc, 31, 32)
    with pytest.raises(ValueError, match="nz <= 32"):
        crk._check("crown_ric_solve", sched, Nc, 31, 33)


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


def _check_runs(prep):
    """The run arrays of the crown kernels' schedule on ``prep``: every
    node on exactly one level and in exactly one run; a run's nodes a
    single-kid path, deepest first, that starts at the root, a leaf or a
    node of two or more kids; every run's kids' runs on earlier phases and
    its top feeding a parent that starts a run of a later phase; the last
    phase the root's run alone."""
    sched = crk._get_sched(prep)
    topo = prep.topo
    Nn = topo.Nn
    par = np.asarray(topo.parent_np)
    nk = np.bincount(par[1:], minlength=Nn)
    assert np.array_equal(np.sort(sched.lev_node), np.arange(Nn))
    assert np.array_equal(np.sort(sched.run_node), np.arange(Nn))
    assert sched.ph_ptr[0] == 0 and sched.ph_ptr[-1] == len(sched.run_ptr) - 1
    assert np.all(np.diff(sched.ph_ptr) >= 1) and np.all(np.diff(sched.run_ptr) >= 1)
    assert sched.run_width == np.diff(sched.ph_ptr).max()
    phase_of = np.empty(Nn, np.int64)
    runs = []
    for h in range(sched.n_ph):
        for r in range(sched.ph_ptr[h], sched.ph_ptr[h + 1]):
            run = sched.run_node[sched.run_ptr[r]:sched.run_ptr[r + 1]]
            phase_of[run] = h
            runs.append((h, run))
    for h, run in runs:
        first, top = run[0], run[-1]
        assert first == 0 or nk[first] != 1
        for below, above in zip(run[:-1], run[1:]):
            assert par[below] == above and nk[above] == 1 and above != 0
        for c in np.nonzero(par == first)[0]:
            if c != 0:
                assert phase_of[c] < h
        if top != 0:
            p = par[top]
            assert phase_of[p] > h and (p == 0 or nk[p] != 1)
            assert p in [r[0] for hh, r in runs if hh == phase_of[p]]
    last = sched.run_node[sched.run_ptr[sched.ph_ptr[-2]]:]
    assert sched.ph_ptr[-1] - sched.ph_ptr[-2] == 1 and list(last) == [0]
    return sched


def test_crown_schedule_runs(crown_case):
    """_get_sched's runs on crown_case's whole tree (its stages 3 and 4
    single-kid: 9 runs of three nodes), on multistage trees and on a
    seeded tree of random kid counts."""
    sched = _check_runs(crown_case["tree"]["prep"])
    assert (sched.n_lev, sched.n_ph, sched.run_width) == (5, 3, 9)
    assert list(np.diff(sched.run_ptr)[:9]) == [3] * 9
    shapes = {(4, 4, 4): (5, 256), (4, 4, 20): (5, 256), (4, 3, 7): (4, 64),
              (2, 2, 12): (3, 4), (2, 0, 6): (2, 1), (4, 5, 5): (6, 1024)}
    for (md, Nr, Nh), (n_ph, width) in shapes.items():
        s = _check_runs(ipm._get_ipm_prep(TreeStructure.multistage(md, Nr, Nh, 3, 1)))
        assert (s.n_ph, s.run_width) == (n_ph, width), (md, Nr, Nh)
    rng = np.random.default_rng(11)
    nk = [3]  # kid counts, breadth first, until some 80 nodes
    while len(nk) < 1 + sum(nk):
        nk.append(int(rng.choice(4, p=[0.35, 0.4, 0.15, 0.1])) if sum(nk) < 80 else 0)
    s = _check_runs(ipm._get_ipm_prep(TreeStructure.from_nkids(nk, [3] * len(nk),
                                                                [1] * len(nk))))
    assert s.n_ph < s.n_lev and max(np.diff(s.run_ptr)) > 1


def test_ric_launch_shape():
    """_ric_launch: a group a run of the widest phase in one round where a
    block's threads (16 warps; 8 for the 32-lane groups past nz = 16) and
    shared memory (227 KB) allow; one block up to 32 runs, one cluster of
    16 blocks beyond, striding over wider phases."""
    prep = lambda md, Nr, Nh, nx, nu: ipm._get_ipm_prep(
        TreeStructure.multistage(md, Nr, Nh, nx, nu))
    got = {key: crk._ric_launch(crk._get_sched(prep(*key)), key[3] + key[4])
           for key in [(4, 4, 4, 8, 1), (4, 4, 20, 8, 1), (4, 3, 7, 8, 1), (4, 4, 4, 16, 7),
                       (4, 4, 50, 16, 7)]
           + [e[:5] for e in chip_smoke.CROWN_RIC_EDGES]}
    # IPM path B's crown and path C's trees (nz = 9: 16 lanes a run)
    assert got[(4, 4, 4, 8, 1)] == (16, 8)
    assert got[(4, 4, 20, 8, 1)] == (16, 8)
    assert got[(4, 3, 7, 8, 1)] == (16, 2)
    # the edges: nz = 2 (8 lanes), nz = 16, 1024 runs (4 rounds), a deep
    # tree of runs, a chain
    assert got[(3, 2, 3, 1, 1)] == (1, 3)
    assert got[(3, 2, 3, 8, 8)] == (1, 5)
    assert got[(3, 2, 3, 15, 1)] == (1, 5)
    assert got[(4, 5, 5, 8, 1)] == (16, 16)
    assert got[(2, 2, 12, 4, 2)] == (1, 1)
    assert got[(2, 0, 6, 4, 1)] == (1, 1)
    assert got[(3, 2, 4, 6, 3)] == (1, 5)
    # past nz = 16 (a group a warp, 8 warps a block): the linear chain of
    # nm = 8, nu = 7 on the reference grid's largest tree, its 341-node crown
    # and the whole 12117-node tree (256 runs each: two rounds); the
    # edges nz = 17, 23 and 32 (9 runs, past one block's 8 groups), 64 runs
    # at nz = 23, a deep tree of 4 runs (one block), and 256 runs at nz =
    # 32, where the shared memory of 45 KB a group leaves 5 warps a block
    assert got[(4, 4, 4, 16, 7)] == (16, 8)
    assert got[(4, 4, 50, 16, 7)] == (16, 8)
    assert got[(3, 2, 3, 16, 1)] == (16, 1)
    assert got[(3, 2, 3, 22, 1)] == (16, 1)
    assert got[(3, 2, 3, 31, 1)] == (16, 1)
    assert got[(4, 3, 5, 16, 7)] == (16, 4)
    assert got[(2, 2, 12, 16, 7)] == (1, 4)
    assert got[(4, 4, 5, 4, 28)] == (16, 5)
    for (md, Nr, Nh, nx, nu), (blocks, warps) in got.items():
        nz = nx + nu
        per_warp = 32 // (8 if nz <= 8 else 16 if nz <= 16 else 32)
        max_warps = 16 if nz <= 16 else 8
        width = crk._get_sched(prep(md, Nr, Nh, nx, nu)).run_width
        assert blocks in (1, 16) and 1 <= warps <= max_warps
        # the groups' shared memory (the most any nx < nz needs) fits a block
        assert warps * per_warp * crk._ric_floats(nz) * 4 <= 227 * 1024
        # one round where the limits allow, one block only up to 32 runs
        # that one block's groups take at once
        cap = min(max_warps, 227 * 1024 // (4 * crk._ric_floats(nz) * per_warp))
        assert blocks * warps * per_warp >= min(width, blocks * cap * per_warp)
        assert (blocks == 1) == (width <= min(32, cap * per_warp))


def crown_kkt_operands(md, Nr, Nh, nx, nu, seed):
    """Seeded operands of the crown Riccati kernels on the whole multistage
    tree (md, Nr, Nh) with nx states and nu inputs, on the CPU
    (``chip_smoke.ric_crown_operands``): (hbar, AB, Wsum0, rg, rb, wsum0,
    prep)."""
    return chip_smoke.ric_crown_operands(torch, md, Nr, Nh, nx, nu, seed, "cpu")


@pytest.mark.parametrize("shape,reg", [((2, 2, 4, 3, 2), 0.0), ((3, 2, 3, 8, 1), 1e-3)])
def test_crown_ric_kkt_yardstick(shape, reg):
    """chip_smoke's library calls of crown_ric_factor / crown_ric_solve:
    torch.linalg.ldl_factor_ex of the crown's dense KKT matrix
    (``chip_smoke.ric_crown_matrix``) and ldl_solve with its factors give
    the twins' dz and dlam to SOLVE_RTOL on seeded operands of the whole
    multistage tree (md, Nr, Nh) with nx states and nu inputs
    (``crown_kkt_operands``)."""
    hbar, AB, W0, rg, rb, w0, prep = crown_kkt_operands(*shape, 4)
    nx = shape[3]
    dz, dl = crk.crown_ric_solve_ref(crk.crown_ric_factor_ref(hbar, AB, W0, prep, nx, reg),
                                     rg, rb, w0, prep)
    M = chip_smoke.ric_crown_matrix(torch, hbar, AB, W0, prep, nx, reg)
    assert torch.equal(M, M.T)
    LD, piv, info = torch.linalg.ldl_factor_ex(M)
    assert int(info) == 0
    x = torch.linalg.ldl_solve(LD, piv, chip_smoke.ric_crown_vector(torch, rg, rb, w0))
    lz, ll = chip_smoke.ric_crown_vector(torch, rg, rb, w0, x=x)
    close(lz, dz, SOLVE_RTOL, "dz")
    close(ll, dl, SOLVE_RTOL, "dlam")


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_ric_chain_kkt_yardstick(dense):
    """chip_smoke's library calls of the chain Riccati kernels (rows 22-24):
    torch.linalg.ldl_factor_ex of each chain's dense KKT matrix
    (``chip_smoke.ric_chain_matrix``: the stage Hessians with reg on the
    inputs' block, the dynamics rows and their transposes) and ldl_solve
    with ``chip_smoke.ric_chain_vector``'s right-hand side give what
    ric_chain_bwd followed by ric_chain_fwd gives (the twins), in f64 to
    1e-10, on seeded operands (``chip_smoke.ric_operands`` / ``ric_rhs``)."""
    S, L, nx, nz, reg = 3, 4, 3, 5, 1e-3
    hb, AB = chip_smoke.ric_operands(torch, S, L, nx, nz, dense, 7, "cpu")
    rg, rb, zr = chip_smoke.ric_rhs(torch, S, L, nx, nz, 8, "cpu")
    hb, AB, rg, rb, zr = (t.double() for t in (hb, AB, rg, rb, zr))
    fact, _ = rk.ric_chain_factor_ref(hb, AB, reg)
    p, k, _ = rk.ric_chain_bwd_ref(fact, rg, rb)
    dz, dl = rk.ric_chain_fwd_ref(fact, p, k, rb, zr)
    M = chip_smoke.ric_chain_matrix(torch, hb, AB, reg)
    assert M.shape == (S, L * (nz + nx), L * (nz + nx)) and torch.equal(M, M.mT)
    LD, piv, info = torch.linalg.ldl_factor_ex(M)
    assert int(info.abs().max()) == 0
    x = torch.linalg.ldl_solve(LD, piv, chip_smoke.ric_chain_vector(torch, rg, rb, zr, AB))
    lz, ll = chip_smoke.ric_chain_vector(torch, rg, rb, zr, AB, x=x)
    close(lz, dz, 1e-10, "dz")
    close(ll, dl, 1e-10, "dlam")
    # the same through the smoke's timed form of the two calls
    _, _, info_max, err = chip_smoke.ric_chain_ldl(torch, hb, AB, reg, rg, rb, zr)
    assert info_max == 0 and err <= 1e-10

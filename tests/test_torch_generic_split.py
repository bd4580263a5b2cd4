"""PyTorch port, the generic-tree solver's tree Cholesky on its split
path: the level schedules against the JAX package's, and on
quadcopter(2,2,6) pruned to 3 scenarios (18 nodes, a split of 4 chain
levels of width 3) the dual-Hessian blocks, the plain twins of the chain
kernels (chain_factor, chain_solve_bwd, chain_forward) and of the crown
kernels against the Pallas kernels (interpret mode), the whole split
factor-and-solve against the JAX split path, and the five wrappers on CPU
tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.core.qp_data import TreeQPIn as JTreeQPIn
from treeqp_tpu.ops import chain_kernels as jck
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.utils.pruning import prune_scenario_tree as jprune
from treeqp_tpu.utils.tree import TreeStructure as JTree

from test_torch_chain_kernels import assert_close
from test_torch_generic_kernels import (
    FACTOR_RTOL, REG, SOLVE_RTOL, SPEED, blocks, check_blocks, check_crown, jax_qp,
    lanes, t32)
from treeqp_tpu_torch import convert, models
from treeqp_tpu_torch.core.qp_data import TreeQPIn
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import crown_kernels as ckr
from treeqp_tpu_torch.solvers import tdunes as td

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# schedules


def pruned_topo_4_4_20():
    """The chip smoke run's generic instance: quadcopter(4,4,20)'s tree
    pruned to 128 scenarios (Dirichlet leaf probabilities, seed 0)."""
    jt = JTree.multistage(4, 4, 20, 6, 4)
    probs = np.random.default_rng(0).dirichlet(np.ones(256))
    return jprune(JTreeQPIn.zeros(jt), leaf_probs=probs, nscenmax=128)[0].topo


TOPOS = {
    "asym": lambda: jax_qp("asym").topo,
    "pruned": lambda: jax_qp("pruned").topo,
    "multistage": lambda: JTree.multistage(2, 2, 6, 6, 4),
    "pruned_4_4_20": pruned_topo_4_4_20,
}


def same_levels(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert tuple(la[:4]) == tuple(lb[:4])
        np.testing.assert_array_equal(la[4], lb[4])


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_schedules_match_jax(name):
    """_sliced_sched and _split_sched level by level, None where JAX
    returns None."""
    jt = TOPOS[name]()
    jp, p = jtd._get_prep(jt), td._get_prep(convert.topo_from(jt))
    js, s = jtd._sliced_sched(jp), td._sliced_sched(p)
    assert (js is None) == (s is None)
    if s is not None:
        same_levels(s, js)
    jsp, sp = jtd._split_sched(jp), td._split_sched(p)
    assert (jsp is None) == (sp is None)
    if sp is not None:
        same_levels(sp[0], jsp[0])
        same_levels(sp[1], jsp[1])
    expect_split = {"asym": False, "pruned": True, "multistage": True,
                    "pruned_4_4_20": True}[name]
    assert (sp is not None) == expect_split


def test_chip_instance_shape():
    """quadcopter(4,4,20) pruned to 128 scenarios: 2257 nodes, 2129
    lambda-groups of dim 24, 128 chains of 16 levels and 3 crown levels;
    the port's pruning of the same tree (``models.pruned``) gives the same
    topology."""
    jt = pruned_topo_4_4_20()
    p = td._get_prep(convert.topo_from(jt))
    chain, crown = td._split_sched(p)
    assert (jt.Nn, p.NpG, p.G) == (2257, 2129, 24)
    assert len(chain) == 16 and {lv[1] for lv in chain} == {128}
    assert len(crown) == 3
    topo = convert.topo_from(JTree.multistage(4, 4, 20, 6, 4))
    qp = models.pruned(TreeQPIn.zeros(topo, device="cpu"), 128)
    assert qp.topo == convert.topo_from(jt)


@pytest.mark.parametrize("name", ["pruned", "pruned_4_4_20"])
def test_crown_schedule_of_the_split_crown(name):
    """The crown schedule of the split path lists the crown levels only:
    with the root they are the groups 0..Nc-1, the chains' groups are the
    rest, and the crown kernels take the Nc crown groups alone."""
    p = td._get_prep(convert.topo_from(TOPOS[name]()))
    chain, crown = td._split_sched(p)
    sp = td._split_index(p, (chain, crown), "cpu")
    sched = ckr._get_sched(p, sp["crown"])
    Nc = sp["Nc"]
    assert sched.n_lev == len(crown) and sched.NpG == Nc
    crown_groups = np.concatenate([np.arange(c0, c0 + w) for c0, w, *_ in crown])
    np.testing.assert_array_equal(sched.lev_child, crown_groups)
    np.testing.assert_array_equal(np.sort(crown_groups), np.arange(1, Nc))
    np.testing.assert_array_equal(np.sort(sp["chain"].numpy().ravel()),
                                  np.arange(Nc, p.NpG))
    # chain s hangs from crown group dad[s] at slot[s]; the boundary level's
    # dads are the deepest crown level's groups
    assert set(sp["dad"].tolist()) <= set(crown[0][0] + np.arange(crown[0][1]))
    assert ckr._get_sched(p, sp["crown"]) is sched


def test_crown_schedule_refuses_levels_that_are_not_a_group_prefix():
    """The crown kernels take a prefix of the groups: levels that skip a
    group, or list one twice, are refused."""
    p = td._get_prep(convert.topo_from(TOPOS["pruned_4_4_20"]()))
    chain, crown = td._split_sched(p)
    levels = td._split_index(p, (chain, crown), "cpu")["crown"]
    with pytest.raises(ValueError, match="once"):
        ckr._get_sched(p, [lv[lv != 1] for lv in levels])
    with pytest.raises(ValueError, match="once"):
        ckr._get_sched(p, [levels[0]] + levels)


# ---------------------------------------------------------------------------
# the kernels' plain twins on the pruned tree


@pytest.mark.parametrize("it", [0, 2])
def test_dual_hessian_blocks_match_jax(it):
    check_blocks("pruned", it)


def test_crown_factor_and_solve_match_pallas():
    """The crown kernels over the whole pruned tree (a generic tree to
    crown_factor), at the cold start."""
    check_crown("pruned", 0)


def split_operands(b, prep, split):
    """The chain kernels' operands of the split path, as
    tdunes._tree_chol_factor_split / _tree_chol_solve_split build them
    (j = 0 the chain level next to the crown; the LM shift pre-added)."""
    chain_levels = split[0]
    S, nxm = chain_levels[0][1], prep.nxm
    pick = lambda a, cols: np.stack([a[(slice(c0, c0 + S),) + cols]
                                     for c0, *_ in reversed(chain_levels)], axis=1)
    Wc = pick(b["Ws"], np.index_exp[:nxm, :nxm]) + np.float32(REG) * np.eye(nxm, dtype=np.float32)
    Utc = pick(b["Uts"], np.index_exp[:, :nxm])
    rch = pick(b["rg"], np.index_exp[:nxm])
    return Wc, Utc, rch


def test_chain_kernels_match_pallas():
    """chain_factor, chain_solve_bwd and chain_forward on the split chain
    blocks of the pruned quadcopter (cold start) against the Pallas
    kernels; each sweep on the Pallas factors."""
    b = blocks("pruned", 0)
    qp_j = jax_qp("pruned")
    prep = td._get_prep(convert.topo_from(qp_j.topo))
    Wc, Utc, rch = split_operands(b, prep, td._split_sched(prep))
    S, L, n, _ = Wc.shape
    Ls, CUs, schur0 = ck.chain_factor_ref(t32(Wc), t32(Utc))
    jLs, jCUs, jschur0 = jck.chain_factor(jnp.asarray(Wc), jnp.asarray(Utc))
    jLs_s, jCUs_s = lanes(jLs, S), lanes(jCUs, S)
    assert_close(Ls, jLs_s, FACTOR_RTOL, "Ls")
    assert_close(CUs, jCUs_s, FACTOR_RTOL, "CUs")
    assert_close(schur0, jschur0, FACTOR_RTOL, "schur0")
    jys, jradd0 = jck.chain_solve_bwd(jLs, jCUs, jnp.asarray(rch))
    ys, radd0 = ck.chain_solve_bwd_ref(t32(jLs_s), t32(jCUs_s), t32(rch))
    assert_close(ys, lanes(jys, S), SOLVE_RTOL, "ys")
    assert_close(radd0, jradd0, SOLVE_RTOL, "radd0")
    droot = np.random.default_rng(1).standard_normal((S, n)).astype(np.float32)
    jdls = jck.chain_forward(jLs, jCUs, jys, jnp.asarray(droot))
    dls = ck.chain_forward_ref(t32(jLs_s), t32(jCUs_s), t32(lanes(jys, S)), t32(droot))
    assert_close(dls, jdls, SOLVE_RTOL, "dls")


def split_both(it):
    """The split factor-and-solve of the port and of the JAX package on
    the pruned quadcopter's blocks at iterate ``it``."""
    b = blocks("pruned", it)
    qp_j = jax_qp("pruned")
    jp = jtd._get_prep(qp_j.topo)
    prep = td._get_prep(convert.topo_from(qp_j.topo))
    o_j = jtd.TdunesOpts(**SPEED)
    split_j = jtd._split_sched(jp)
    fj = jtd._tree_chol_factor_split(jnp.asarray(b["Ws"]), jnp.asarray(b["Uts"]),
                                     o_j, jp, split_j)
    dj = jtd._tree_chol_solve_split(fj, jnp.asarray(b["rg"]), o_j, jp, split_j)
    fact = td._tree_chol_factor(t32(b["Ws"]), t32(b["Uts"]), td.TdunesOpts(**SPEED), prep)
    d = td._tree_chol_solve(fact, torch.tensor(b["rg"], dtype=torch.float64), prep)
    return split_j, fj, dj, fact, d


def test_split_factor_and_solve_match_jax():
    """The port's _tree_chol_factor / _tree_chol_solve on the pruned
    quadcopter at the cold start (split path: chain kernels, boundary
    Schur update, the crown levels through crown_factor / crown_solve)
    against the JAX package's _tree_chol_factor_split /
    _tree_chol_solve_split with the Pallas chain kernels (its crown in
    XLA)."""
    split_j, fj, dj, fact, d = split_both(0)
    assert set(fact) == {"Ls", "CUs", "CholW", "CholUt"}
    # the crown factors cover the crown's groups 0..Nc-1 only
    assert fact["CholW"].shape[0] == 1 + sum(w for _, w, *_ in split_j[1])
    S = split_j[0][0][1]
    assert_close(fact["Ls"], lanes(fj["Ls"], S), FACTOR_RTOL, "Ls")
    assert_close(fact["CUs"], lanes(fj["CUs"], S), FACTOR_RTOL, "CUs")
    crown = np.concatenate([np.arange(c0, c0 + w) for c0, w, *_ in split_j[1]])
    assert_close(fact["CholW"][crown], np.asarray(fj["CholW"])[crown], FACTOR_RTOL, "CholW")
    assert_close(fact["CholW"][0], np.asarray(fj["CholW"])[0], FACTOR_RTOL, "root")
    assert_close(fact["CholUt"][crown], np.asarray(fj["CholUt"])[crown], FACTOR_RTOL,
                 "CholUt")
    assert d.dtype == torch.float64
    assert_close(d, dj, SOLVE_RTOL, "dlam")


# Later on the path the crown's root block has pivots near 0.02 (condition
# ~2e3): XLA's blocked Cholesky and the kernels' column order then differ
# by up to 1.8e-5 in the crown factors, so only the solves are compared.
@pytest.mark.parametrize("it", [2, 3])
def test_split_solve_matches_jax_on_the_path(it):
    *_, dj, _, d = split_both(it)
    assert_close(d, dj, SOLVE_RTOL, "dlam")


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors


def test_cpu_wrappers_run_the_plain_twins():
    """On CPU tensors each wrapper returns its twin's result and launches
    nothing; tensors on another device are refused, not run on a twin."""
    b = blocks("pruned", 0)
    prep = td._get_prep(convert.topo_from(jax_qp("pruned").topo))
    Wc, Utc, rch = (t32(a) for a in split_operands(b, prep, td._split_sched(prep)))
    Ls, CUs, schur0 = ck.chain_factor(Wc, Utc)
    for a, r in zip((Ls, CUs, schur0), ck.chain_factor_ref(Wc, Utc)):
        assert torch.equal(a, r)
    ys, radd0 = ck.chain_solve_bwd(Ls, CUs, rch)
    for a, r in zip((ys, radd0), ck.chain_solve_bwd_ref(Ls, CUs, rch)):
        assert torch.equal(a, r)
    droot = radd0.clone()
    assert torch.equal(ck.chain_forward(Ls, CUs, ys, droot),
                       ck.chain_forward_ref(Ls, CUs, ys, droot))
    W, Ut, rg = t32(b["Ws"]), t32(b["Uts"]), t32(b["rg"])
    CholW, CholUt = ckr.crown_factor(W, Ut, prep, reg=REG)
    for a, r in zip((CholW, CholUt), ckr.crown_factor_ref(W, Ut, prep, reg=REG)):
        assert torch.equal(a, r)
    assert torch.equal(ckr.crown_solve(CholW, CholUt, rg, prep),
                       ckr.crown_solve_ref(CholW, CholUt, rg, prep))
    for fn in (ck.chain_factor, ck.chain_solve_bwd, ck.chain_forward,
               ckr.crown_factor, ckr.crown_solve):
        assert fn.launches == 0
    meta = lambda *ts: [t.to("meta") for t in ts]
    with pytest.raises(ValueError, match="expected"):
        ck.chain_factor(*meta(Wc, Utc))
    with pytest.raises(ValueError, match="expected"):
        ck.chain_solve_bwd(*meta(Ls, CUs, rch))
    with pytest.raises(ValueError, match="expected"):
        ck.chain_forward(*meta(Ls, CUs, ys, droot))
    with pytest.raises(ValueError, match="expected"):
        ckr.crown_factor(*meta(W, Ut), prep, reg=REG)
    with pytest.raises(ValueError, match="expected"):
        ckr.crown_solve(*meta(CholW, CholUt, rg), prep)

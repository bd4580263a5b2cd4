"""PyTorch port, crown factorize: the level schedule and the plain twin of
the CUDA kernel (crown_blocks_factor_ref, what the wrapper runs on CPU
tensors) against the JAX Pallas kernel (interpret mode) on the same
operands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import crown_kernels as jckr
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.utils.tree import TreeStructure as JTree

import chip_smoke
from test_torch_chain_kernels import assert_close, factor_inputs, jax_ref
from treeqp_tpu_torch import models
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import crown_kernels as ckr
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm
from treeqp_tpu_torch.utils.tree import TreeStructure

torch.set_num_threads(1)

REG = 1e-6
# f32 on both sides with another summation order (tests/test_fused_eval.py)
RTOL = 1e-5


def jax_prep(topo):
    return jtd._get_prep(JTree(topo.parent, topo.nx, topo.nu, topo.nc))


def crown_operands(name, point):
    ms, prep, ctx, inp = factor_inputs(name, point)
    schur0 = ck.chain_blocks_factor_ref(*inp["chain"])[2]
    Wadd = -tm._schur_scatter(schur0, ctx["g_of"], ctx["slot"], prep, prep.nxm)
    return ms, prep, (*inp["crown"], Wadd)


# Quadcopter crowns are compared at the cold start only: once bounds clip,
# their blocks lose ~3 digits to conditioning and the 1-ulp differences of
# f32 rsqrt (XLA's CPU rsqrt is not correctly rounded, PyTorch's is
# another approximation) reach ~1e-5 in the factors. The system-solve test
# (test_torch_system_kernels.py) still covers those points, at its 1e-4
# bound.
@pytest.mark.parametrize("name,point", [
    ("quadcopter", "zero"), ("spring_mass_chain", "zero"),
    ("spring_mass_chain", "half"), ("spring_mass_chain", "solution")])
def test_crown_blocks_factor_matches_pallas(name, point):
    ms, prep, args = crown_operands(name, point)
    CholW, CholUt = ckr.crown_blocks_factor_ref(*args, prep, reg=REG)
    jW, jU = jax_ref(jckr.crown_blocks_factor, *(jnp.asarray(t.numpy()) for t in args),
                     prep=jax_prep(ms.meta.crown_topo), reg=REG)
    lanes = lambda v: np.transpose(np.asarray(v)[..., :prep.NpG], (2, 0, 1))
    assert_close(CholW, lanes(jW), RTOL, "CholW")
    assert_close(CholUt, lanes(jU), RTOL, "CholUt")


@pytest.mark.parametrize("md,Nr,nx", [(2, 2, 6), (3, 2, 4), (4, 4, 6), (4, 5, 6)],
                         ids=["quadcopter_small", "spring_mass", "bench_crown",
                              "crown_1024"])
def test_crown_schedule_matches_pallas(md, Nr, nx):
    """Per-level (child, parent, slot) lists against the JAX kernel's
    one-hot slot matrices and level masks; includes the 1024-scenario
    crown (1365 nodes, 341 groups)."""
    crown = tm._ms_meta(TreeStructure.multistage(md, Nr, Nr + 2, nx, 1)).crown_topo
    sched = ckr._get_sched(td._get_prep(crown))
    jsched = jckr._get_sched(jax_prep(crown))
    assert (sched.n_lev, sched.K, sched.G, sched.nxm, sched.NpG) == \
        (jsched.n_lev, jsched.K, jsched.G, jsched.nxm, jsched.NpG)
    for r in range(sched.n_lev):
        sl = slice(sched.lev_ptr[r], sched.lev_ptr[r + 1])
        child = sched.lev_child[sl]
        np.testing.assert_array_equal(np.sort(child),
                                      np.nonzero(jsched.masks[r, 0])[0])
        for g, d, s in zip(child, sched.lev_parent[sl], sched.lev_slot[sl]):
            assert jsched.P[s, g, d] == 1.0
    assert len(sched.lev_child) == int(jsched.P.sum())
    assert jsched.masks[sched.n_lev, 0, 0] == 1.0
    # every group but the root on one level
    np.testing.assert_array_equal(np.sort(sched.lev_child), np.arange(1, sched.NpG))


def test_crown_blocks_factor_cpu_wrapper_runs_plain_twin():
    _, prep, args = crown_operands("spring_mass_chain", "half")
    for a, b in zip(ckr.crown_blocks_factor(*args, prep, reg=REG),
                    ckr.crown_blocks_factor_ref(*args, prep, reg=REG)):
        assert torch.equal(a, b)
    assert ckr.crown_blocks_factor.launches == 0
    with pytest.raises(ValueError, match="expected"):
        ckr.crown_blocks_factor(*(t.to("meta") for t in args), prep, reg=REG)


# ---------------------------------------------------------------------------
# The CUDA kernels' redesign (a warp a group on one cluster): the dense
# yardstick of the smoke's library call, the twin at the kernels' edges,
# and the launch shape.

FACTOR_RTOL = chip_smoke.FACTOR_RTOL
SOLVE_RTOL = chip_smoke.SOLVE_RTOL
CPU = torch.device("cpu")


def asym_prep():
    return td._get_prep(models.asym_tree(device="cpu").topo)


YARDSTICK = {"headline": lambda: chip_smoke.crown_prep(4, 4, 6), "asymmetric": asym_prep}


@pytest.mark.parametrize("name", sorted(YARDSTICK))
def test_dense_crown_matrix_reproduces_the_twins(name):
    """The smoke's library call: the Cholesky factor of the crown as one
    dense matrix (``chip_smoke.crown_matrix``, the deepest level first)
    holds crown_factor_ref's CholW / CholUt, and cholesky_solve with it
    gives crown_solve_ref's solution, on seeded operands (the headline
    crown: 85 groups of 24, a [2040, 2040] matrix; the asymmetric tree:
    17 groups, 9 levels)."""
    prep = YARDSTICK[name]()
    sched = ckr._get_sched(prep)
    _, (W, Ut) = chip_smoke.crown_operands(torch, sched, sched.nxm + 4, 5, CPU)
    reg = chip_smoke.CROWN_REG
    CholW, CholUt = ckr.crown_factor_ref(W, Ut, prep, reg=reg)
    M = chip_smoke.crown_matrix(torch, W, Ut, sched, reg=reg)
    assert M.shape == (sched.NpG * sched.G,) * 2
    L, info = torch.linalg.cholesky_ex(M)
    assert int(info) == 0
    F = chip_smoke.crown_matrix(torch, CholW, CholUt, sched, factor=True)
    assert_close(L, F, FACTOR_RTOL, "dense factor")
    rg = torch.tensor(np.random.default_rng(6).standard_normal((sched.NpG, sched.G)),
                      dtype=torch.float32)
    x = torch.cholesky_solve(chip_smoke.crown_vector(torch, rg, sched), L)
    assert_close(chip_smoke.crown_vector(torch, x.view(-1), sched, back=True),
                 ckr.crown_solve_ref(CholW, CholUt, rg, prep), SOLVE_RTOL, "dense solve")


# G = 48 and 64 (nxm 16: two rows a lane in the kernel) and crowns with a
# zero block on their deepest level at reg = 0, whose pivots floor at 1e-8;
# one level each (the interpret-mode Pallas factorization of G = 64 takes
# ~40 s to compile)
PALLAS_EDGES = {"G48": (3, 2, 16, 1e-6, False), "G64_floor": (4, 2, 16, 0.0, True),
                "G24_floor": (4, 3, 6, 0.0, True)}


@pytest.mark.parametrize("edge", sorted(PALLAS_EDGES))
def test_crown_factor_twin_matches_pallas_at_edges(edge):
    """crown_factor_ref against the interpret-mode Pallas crown_factor on
    ``chip_smoke.crown_operands``, at the CUDA kernels' edges."""
    md, Nr, nx, reg, zero = PALLAS_EDGES[edge]
    crown = tm._ms_meta(TreeStructure.multistage(md, Nr, Nr + 2, nx, 1)).crown_topo
    prep = td._get_prep(crown)
    sched = ckr._get_sched(prep)
    assert sched.G == md * nx
    _, (W, Ut) = chip_smoke.crown_operands(torch, sched, nx + 2, 7, CPU, zero=zero)
    CholW, CholUt = ckr.crown_factor_ref(W, Ut, prep, reg=reg)
    jW, jU = jckr.crown_factor(jnp.asarray(W.numpy()), jnp.asarray(Ut.numpy()),
                               jax_prep(crown), reg=reg)
    lanes = lambda v: np.moveaxis(np.asarray(v)[..., :sched.NpG], -1, 0)
    assert_close(CholW, lanes(jW), FACTOR_RTOL, "CholW")
    assert_close(CholUt, lanes(jU), FACTOR_RTOL, "CholUt")
    if zero:
        # the floored pivots: 1e-8 * rsqrt(1e-8) on the diagonal, 0 below
        g = int(sched.lev_child[0])
        np.testing.assert_allclose(torch.diagonal(CholW[g]).numpy(), 1e-4, rtol=1e-6)
        assert float(torch.tril(CholW[g], -1).abs().max()) == 0.0


def _split_crown(qq):
    """(prep, levels) of ``qq``'s crown: the split path's crown levels, or
    every level without a split schedule."""
    p = td._get_prep(qq.topo)
    split = td._split_sched(p)
    return p, None if split is None else td._split_index(p, split, "cpu")["crown"]


def launch_shapes():
    """The crowns the kernels take on the solvers' paths (as in
    scripts/prof_torch_crown_kernels.py) and at chip_smoke.CROWN_EDGES:
    name -> (schedule, nz of crown_blocks_factor or 0)."""
    q = models.quadcopter(4, 4, 20, device="cpu").qp
    out = {name: (ckr._get_sched(chip_smoke.crown_prep(*tree)), nz)
           for name, tree, nz in (("headline", (4, 4, 6), 10), ("bootstrap", (4, 4, 8), 9),
                                  ("1024 scenarios", (4, 5, 6), 10))}
    for name, qq in (("pruned", models.pruned(q, 128)),
                     ("general C/D", models.general_cd("qpgen", device="cpu")),
                     ("asymmetric", models.asym_tree(device="cpu"))):
        out[name] = (ckr._get_sched(*_split_crown(qq)), 0)
    for md, Nr, nx, _, _ in chip_smoke.CROWN_EDGES:
        out[f"edge {md} {Nr} {nx}"] = (ckr._get_sched(chip_smoke.crown_prep(md, Nr, nx)), nx + 2)
    return out


def test_factor_launch_shape():
    """_factor_launch: one round of warps where a block's threads and
    shared memory allow, a warp's floats holding the group's factors with
    odd rows (and the block build's operands)."""
    shapes = launch_shapes()
    got = {name: ckr._factor_launch(s, nz) for name, (s, nz) in shapes.items()}
    # the solvers' crowns (G = 24 or 32, NpG 85 / 341 / 81 / 85 / 17)
    assert got["headline"] == (11, 752)
    assert got["bootstrap"] == (8, 1320)
    assert got["1024 scenarios"] == (16, 752)
    assert got["pruned"] == (11, 752)
    assert got["general C/D"] == (8, 1320)
    assert got["asymmetric"] == (3, 800)
    for name, (s, nz) in shapes.items():
        warps, floats = got[name]
        rows = -(-(s.G + s.nxm) // 32)
        assert 1 <= warps <= (16 if rows == 1 else 8), name
        assert floats % 4 == 0 and floats >= (s.G + s.nxm) * (s.G + 1), name
        assert floats >= 2 * nz * s.G + nz + s.G, name
        assert warps * floats * 4 + 4 * (s.n_lev + 1 + 3 * (s.NpG - 1)) <= 227 * 1024, name
        # a round of the cluster's warps covers the groups where the limit allows
        assert 8 * warps >= min(s.NpG, 8 * (16 if rows == 1 else 8)), name
    assert got["edge 4 3 16"] == (3, 5200)


def test_solve_launch_shape():
    """_solve_launch: a warp a group of the widest level in one round where
    a block's threads allow, one block where the levels are narrow, one
    cluster beyond, and the per-thread form in one block for G > 32."""
    shapes = launch_shapes()
    shapes["unpruned"] = (ckr._get_sched(*_split_crown(models.quadcopter(4, 4, 20,
                                                                         device="cpu").qp)), 0)
    got = {name: ckr._solve_launch(s) for name, (s, _) in shapes.items()}
    # the solvers' crowns: widest levels 64 / 64 / 256 / 60 / 64 / 64 / 3
    assert got["headline"] == (8, 8)
    assert got["bootstrap"] == (8, 8)
    assert got["1024 scenarios"] == (8, 16)
    assert got["pruned"] == (8, 8)
    assert got["unpruned"] == (8, 8)
    assert got["general C/D"] == (8, 8)
    assert got["asymmetric"] == (1, 3)
    assert got["edge 2 3 1"] == (1, 4)
    assert got["edge 3 3 16"] == (1, 1)  # G = 48: a thread a group
    assert got["edge 4 3 16"] == (1, 1)  # G = 64
    for name, (s, _) in shapes.items():
        blocks, warps = got[name]
        assert blocks in (1, 8) and 1 <= warps <= 16, name
        if s.G > 32:
            # the per-thread form: one block, a thread a group of the widest level
            assert blocks == 1 and 32 * warps >= min(s.width, 512), name
        else:
            # a round of the warps covers the widest level where the limit allows
            assert blocks * warps >= min(s.width, blocks * 16), name
            assert blocks == 1 or s.width > 16, name


def test_crown_eval_launch():
    """_crown_eval_launch (the launch of crown_eval, crown_eval_df and
    crown_apply_df): one cluster of _EVAL_CLUSTER blocks (or the team asked
    for); a block's groups of tq::lanes(nz) lanes cover the crown in one
    round where a block's threads allow. Pinned at the bench and two-norm
    paths' 341-node crown, tdunes_ms_f32's (341 nodes, nx = 8, nu = 1: 16
    lanes a node), quadcopter(4,5,20)'s 1365 and the smoke's edges
    (chip_smoke.CROWN_EVAL_EDGES)."""
    assert ckr._crown_eval_launch(341, 6, 4) == (16, 22, 352)
    assert ckr._crown_eval_launch(341, 8, 1) == (16, 22, 352)
    assert ckr._crown_eval_launch(1365, 6, 4) == (16, 64, 1024)
    assert ckr._crown_eval_launch(341, 6, 4, blocks=1) == (1, 64, 1024)
    assert ckr._crown_eval_launch(1365, 6, 4, blocks=8) == (8, 64, 1024)
    nodes = {}
    for md, Nr, nx, nu in chip_smoke.CROWN_EVAL_EDGES:
        topo = TreeStructure.multistage(md, Nr, Nr + 2, nx, nu)
        Nn = tm._ms_meta(topo).crown_topo.Nn
        nodes[md, Nr, nx, nu] = Nn
        blocks, groups, threads = ckr._crown_eval_launch(Nn, nx, nu)
        G = 8 if nx + nu <= 8 else 16
        assert blocks == ckr._EVAL_CLUSTER
        assert threads % 32 == 0 and threads <= ckr._EVAL_THREADS and groups == threads // G
        rounds = -(-Nn // (blocks * groups))
        assert rounds == 1 or threads == ckr._EVAL_THREADS
    assert nodes == {(4, 0, 6, 4): 1, (3, 3, 1, 1): 40, (3, 2, 16, 16): 13,
                     (40, 1, 6, 4): 41, (2, 8, 6, 4): 511, (4, 5, 6, 4): 1365}
    assert ckr._crown_eval_launch(1, 6, 4) == (16, 2, 32)
    assert ckr._crown_eval_launch(40, 1, 1) == (16, 4, 32)
    assert ckr._crown_eval_launch(13, 16, 16) == (16, 2, 32)


def test_crown_eval_twin_on_a_root_only_crown():
    """The crown of one node (chip_smoke.CROWN_EVAL_EDGES' first edge) has
    no kid slots: the kid sum is zero, so the twin's stage solve is the
    root's own clip of Qinv (-q + lam - extra_x), Rinv (-r - extra_u), and
    its residual is masked to zero."""
    data, lam, extra, prep = chip_smoke.crown_eval_operands(torch, 4, 0, 6, 4, 3, "cpu")
    assert len(prep.par) == 1
    assert torch.equal(td._kid_sum(extra, prep), torch.zeros_like(extra))
    out = ckr.crown_eval_ref(data, lam, extra, prep)
    xU = data["Qinv"] * ((-data["q"] + lam - extra[:, :6]) * data["xm"])
    uU = data["Rinv"] * ((-data["r"] - extra[:, 6:]) * data["um"])
    assert torch.equal(out["xUnc"], xU) and torch.equal(out["uUnc"], uU)
    assert torch.equal(out["x"], torch.clamp(xU, data["xmin"], data["xmax"]) * data["xm"])
    assert torch.equal(out["res"], torch.zeros_like(out["res"]))

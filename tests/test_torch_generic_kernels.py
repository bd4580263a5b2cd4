"""PyTorch port, the generic-tree solver's tree Cholesky on its crown
path: the dual-Hessian blocks and the plain twins of the crown kernels
(crown_factor, crown_solve: what the wrappers run on CPU tensors) against
the JAX package and its Pallas kernels (interpret mode), on the same
operands, on the asymmetric thesis-class tree of
``benchmarks/generic_bench.py`` (20 nodes, lambda-groups of dim 24, no
split schedule). Also the instances and helpers of
test_torch_generic_split.py (the split path, on quadcopter(2,2,6) pruned
to 3 scenarios: 18 nodes, 4 chain levels of width 3) and
test_torch_generic_solve.py."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import generic_bench as gb
from benchmarks import models as jmodels
from treeqp_tpu.ops import crown_kernels as jckr
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.utils.pruning import prune_scenario_tree as jprune

from test_torch_chain_kernels import assert_close
from treeqp_tpu_torch import convert
from treeqp_tpu_torch.ops import crown_kernels as ckr
from treeqp_tpu_torch.solvers import tdunes as td

torch.set_num_threads(1)

# generic_bench.speed_opts(on_tpu=True): the options of the slice
SPEED = dataclasses.asdict(gb.speed_opts(True))
REG = SPEED["reg_value"]
# f32 on both sides with another summation order: factors to 1e-5 and
# solves to 1e-4 relative to max(1, max|ref|) (tests/test_crown_kernels.py)
FACTOR_RTOL = 1e-5
SOLVE_RTOL = 1e-4
# the dual-Hessian blocks: f32 products summed in another order
BLOCK_RTOL = 1e-6


def asym():
    return gb.build("asym_speed")[0]


def pruned(md=2, Nr=2, Nh=6, nscen=3):
    """quadcopter(md, Nr, Nh) pruned to ``nscen`` scenarios with Dirichlet
    leaf probabilities (seed 0), the fault-tolerance example's controller."""
    qp = jmodels.quadcopter(md, Nr, Nh).qp
    probs = np.random.default_rng(0).dirichlet(np.ones(md ** Nr))
    return jprune(qp, leaf_probs=probs, nscenmax=nscen)[0]


CASES = {"asym": asym, "pruned": pruned}


@functools.lru_cache(maxsize=None)
def jax_qp(name):
    return CASES[name]()


def port_qp(name):
    qp_j = jax_qp(name)
    return convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                                 device="cpu")


@functools.lru_cache(maxsize=None)
def blocks(name, it):
    """JAX's f32 dual-Hessian blocks at the dual point of the ``it``-th
    iterate of the one-phase solve (0: the cold start), their Jacobi
    equilibration as ``_newton_factor`` does it, and the equilibrated
    right-hand side — numpy arrays."""
    qp_j = jax_qp(name)
    o = jtd.TdunesOpts(**{**SPEED, "f32_phase_tol": 0.0, "chain_backend": "xla",
                          "max_iter": it})
    lam = jtd.tdunes_solve(qp_j, None, o).lam
    prep = jtd._get_prep(qp_j.topo)
    data = jtd._stage_data(qp_j, o)
    sol = jtd._stage_solve(qp_j, lam, data, o, prep)
    res = jtd._dual_residual(qp_j, sol, prep)
    W, Ut = jtd._build_dual_hessian(qp_j, sol, data, o, prep, dtype=jnp.float32)
    sW = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(W, axis1=1, axis2=2), 1e-12))
    rows = prep.gslot[:, None] * prep.nxm + np.arange(prep.nxm)[None, :]
    sUt = sW[np.maximum(prep.gdad, 0)[:, None], rows]
    Ws = W * sW[:, :, None] * sW[:, None, :]
    Uts = Ut * sUt[:, :, None] * sW[:, None, :]
    rg = (jtd._nodes_to_group_mm(res, prep) * sW).astype(jnp.float32)
    return {k: np.asarray(v) for k, v in dict(lam=lam, W=W, Ut=Ut, sW=sW, Ws=Ws,
                                                 Uts=Uts, rg=rg).items()}


def t32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def lanes(v, n):
    """A lane-major Pallas output [..., NPg] -> group-major [n, ...]."""
    v = np.asarray(v)[..., :n]
    return np.moveaxis(v, -1, 0)


# ---------------------------------------------------------------------------
# checks shared with test_torch_generic_split.py (the pruned tree)


def check_blocks(name, it):
    """_build_dual_hessian (clipping, built in f32) and the Jacobi
    equilibration of _newton_factor against JAX's at a dual point on the
    path."""
    b = blocks(name, it)
    qp = port_qp(name)
    prep = td._get_prep(qp.topo)
    opts = td.TdunesOpts(**SPEED)
    data = td._stage_data(qp, opts, prep)
    sol = td._stage_solve(qp, torch.tensor(b["lam"]), data, opts, prep)
    W, Ut = td._build_dual_hessian(qp, sol, data, opts, prep)
    assert W.dtype == torch.float32
    assert_close(W, b["W"], BLOCK_RTOL, "W")
    assert_close(Ut, b["Ut"], BLOCK_RTOL, "Ut")
    sW, _ = td._newton_factor(t32(b["W"]), t32(b["Ut"]), opts, prep)
    assert_close(sW, b["sW"], BLOCK_RTOL, "sW")


def check_crown(name, it):
    """crown_factor over the whole tree against the Pallas crown_factor;
    crown_solve on the Pallas factors against the Pallas crown_solve."""
    b = blocks(name, it)
    qp_j = jax_qp(name)
    jp = jtd._get_prep(qp_j.topo)
    prep = td._get_prep(convert.topo_from(qp_j.topo))
    CholW, CholUt = ckr.crown_factor_ref(t32(b["Ws"]), t32(b["Uts"]), prep, reg=REG)
    jfact = jckr.crown_factor(jnp.asarray(b["Ws"]), jnp.asarray(b["Uts"]), jp, reg=REG)
    jW, jU = lanes(jfact[0], prep.NpG), lanes(jfact[1], prep.NpG)
    assert_close(CholW, jW, FACTOR_RTOL, "CholW")
    assert_close(CholUt, jU, FACTOR_RTOL, "CholUt")
    jd = jckr.crown_solve(*jfact, jnp.asarray(b["rg"]), jp)
    d = ckr.crown_solve_ref(t32(jW), t32(jU), t32(b["rg"]), prep)
    assert_close(d, jd, SOLVE_RTOL, "dlam")


# ---------------------------------------------------------------------------
# the crown path, on the asymmetric tree


@pytest.mark.parametrize("it", [0, 2])
def test_dual_hessian_blocks_match_jax(it):
    check_blocks("asym", it)


# Factors are compared where the blocks are well conditioned. At the
# asymmetric tree's cold start the root block's Schur complement cancels
# enough that the 1-ulp difference of f32 rsqrt (XLA CPU vs PyTorch) shows
# as 1.3e-5 in its factor (every other group within 4e-7); the whole-solve
# tests (test_torch_generic_solve.py) cover that point.
@pytest.mark.parametrize("it", [2, 4])
def test_crown_factor_and_solve_match_pallas(it):
    check_crown("asym", it)


def test_crown_path_on_the_asymmetric_tree():
    """Without a split schedule the whole tree goes through crown_factor /
    crown_solve (every group but the root on one level)."""
    b = blocks("asym", 0)
    prep = td._get_prep(convert.topo_from(jax_qp("asym").topo))
    assert td._split_sched(prep) is None
    fact = td._tree_chol_factor(t32(b["Ws"]), t32(b["Uts"]), td.TdunesOpts(**SPEED), prep)
    assert set(fact) == {"CholW", "CholUt"}
    sched = ckr._get_sched(prep)
    assert sched.NpG == prep.NpG
    np.testing.assert_array_equal(np.sort(sched.lev_child), np.arange(1, prep.NpG))
    ref = ckr.crown_factor_ref(t32(b["Ws"]), t32(b["Uts"]), prep, reg=REG)
    for a, r in zip((fact["CholW"], fact["CholUt"]), ref):
        assert torch.equal(a, r)
    d = td._tree_chol_solve(fact, torch.tensor(b["rg"], dtype=torch.float64), prep)
    assert d.dtype == torch.float64
    assert torch.equal(d, ckr.crown_solve_ref(*ref, t32(b["rg"]), prep).double())

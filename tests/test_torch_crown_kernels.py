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

from test_torch_chain_kernels import assert_close, factor_inputs
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
    jW, jU = jckr.crown_blocks_factor(*(jnp.asarray(t.numpy()) for t in args),
                                      jax_prep(ms.meta.crown_topo), reg=REG)
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

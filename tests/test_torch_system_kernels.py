"""PyTorch port, whole-system Newton solve: the scenario <-> group index
lists and the plain twin of the CUDA kernel (system_solve_ref, what the
wrapper runs on CPU tensors) against the JAX Pallas kernel (interpret
mode), both solving with the same factors and right-hand sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import crown_kernels as jckr
from treeqp_tpu.ops import system_kernels as jsk

import chip_smoke
from test_torch_chain_kernels import CASES, POINTS, assert_close, factor_inputs, jax_ref
from test_torch_crown_kernels import REG, jax_prep
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import crown_kernels as ckr
from treeqp_tpu_torch.ops import system_kernels as sk
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

# f32 solves on both sides with another summation order
# (tests/test_crown_kernels.py)
RTOL = 1e-4


def system_case(name, point, seed=0):
    ms, prep, ctx, inp = factor_inputs(name, point)
    Ls, CUs, schur0, _ = ck.chain_blocks_factor_ref(*inp["chain"])
    Wadd = -tm._schur_scatter(schur0, ctx["g_of"], ctx["slot"], prep, prep.nxm)
    CholW, CholUt = ckr.crown_blocks_factor_ref(*inp["crown"], Wadd, prep, reg=REG)
    rng = np.random.default_rng(seed)
    rg = torch.tensor(rng.standard_normal((prep.NpG, prep.G)), dtype=torch.float32)
    rch = torch.tensor(rng.standard_normal(tuple(ms.q.shape)), dtype=torch.float32)
    return ms, prep, (Ls, CUs, CholW, CholUt, rg, rch)


def _pad_lanes(v, lanes, eye):
    """[..., N] -> [..., lanes]: identity blocks (eye) or zeros beyond N."""
    out = np.zeros(v.shape[:-1] + (lanes,), np.float32)
    if eye:
        out[...] = np.eye(v.shape[-3], dtype=np.float32)[..., None]
    out[..., : v.shape[-1]] = v
    return out


def jax_layout(Ls, CUs, CholW, CholUt, prep):
    """The port's factors in the Pallas kernels' lane layouts."""
    S = Ls.shape[0]
    SP = max(128, -(-S // 128) * 128)
    NPg = jckr._get_sched(prep).NPg
    tr = lambda v, p: np.transpose(v.numpy(), p)
    return (_pad_lanes(tr(Ls, (1, 2, 3, 0)), SP, True),
            _pad_lanes(tr(CUs, (1, 2, 3, 0)), SP, False),
            _pad_lanes(tr(CholW, (1, 2, 0)), NPg, True),
            _pad_lanes(tr(CholUt, (1, 2, 0)), NPg, False))


# seeded factors (chip_smoke.system_operands) on crowns the solver cases
# do not reach, at small depth: the multistage tree (md, Nr, Nh) with nx
# states of sdunes' bootstrap crown (spring_mass_chain's nx = 8, 4 kids:
# G = 32, a warp's rows) and with crown groups of 48 rows (nx = 16, 3
# kids: past a warp, the CUDA kernel's block-0 path); the point is the seed
SEEDED = {"seeded_G32": (4, 2, 4, 8), "seeded_G48": (3, 2, 4, 16)}


@pytest.mark.parametrize("name", sorted(CASES) + sorted(SEEDED))
@pytest.mark.parametrize("point", sorted(POINTS))
def test_system_solve_matches_pallas(name, point):
    if name in SEEDED:
        *args, prep, root_ids = chip_smoke.system_operands(
            torch, *SEEDED[name], sorted(POINTS).index(point), torch.device("cpu"))
        topo = prep.topo
    else:
        ms, prep, args = system_case(name, point)
        root_ids, topo = ms.meta.root_ids, ms.meta.crown_topo
    dg, dch = sk.system_solve_ref(*args, prep, root_ids)
    jprep = jax_prep(topo)
    factors = jax_layout(*args[:4], jprep)
    jdg, jdch = jax_ref(jsk.system_solve, *(jnp.asarray(f) for f in factors),
                        jnp.asarray(args[4].numpy()), jnp.asarray(args[5].numpy()),
                        prep=jprep, root_ids=np.asarray(root_ids))
    assert_close(dg, jdg, RTOL, "dg")
    assert_close(dch, jdch, RTOL, "dch")


@pytest.mark.parametrize("name", sorted(CASES))
def test_ms_sched_matches_pallas(name):
    ms, prep, _, _ = factor_inputs(name, "zero")
    ids = sk.ms_sched(prep, ms.meta.root_ids, "cpu")
    J = jsk.ms_sched(jax_prep(ms.meta.crown_topo), ms.meta.root_ids, ms.meta.S)
    g_of, slot = ids["g_of"].numpy(), ids["slot"].numpy()
    assert all(J[slot[s], s, g_of[s]] == 1.0 for s in range(ms.meta.S))
    assert int(J.sum()) == ms.meta.S


def test_system_solve_cpu_wrapper_runs_plain_twin():
    ms, prep, args = system_case("quadcopter", "half")
    for a, b in zip(sk.system_solve(*args, prep, ms.meta.root_ids),
                    sk.system_solve_ref(*args, prep, ms.meta.root_ids)):
        assert torch.equal(a, b)
    assert sk.system_solve.launches == 0
    with pytest.raises(ValueError, match="expected"):
        sk.system_solve(*(t.to("meta") for t in args), prep, ms.meta.root_ids)


@pytest.mark.parametrize("shape", [(2, 2, 5, 3), (3, 1, 2, 5), (4, 2, 4, 8)])
def test_system_matrix_yardstick(shape):
    """chip_smoke's library call of system_solve: torch.cholesky_solve with
    the whole tree's factor as one dense lower matrix
    (``chip_smoke.system_matrix``, the right-hand sides ordered by
    ``system_vector``) equals the twin to SOLVE_RTOL on seeded factors of
    the multistage tree (md, Nr, Nh) with nx states."""
    *args, prep, root_ids = chip_smoke.system_operands(torch, *shape, 3, torch.device("cpu"))
    dg, dch = sk.system_solve_ref(*args, prep, root_ids)
    F = chip_smoke.system_matrix(torch, *args[:4], prep, root_ids)
    S, L, n, _ = args[0].shape
    assert F.shape == (S * L * n + dg.numel(),) * 2 and bool((F.triu(1) == 0).all())
    v = chip_smoke.system_vector(torch, args[4], args[5], prep)
    ldg, ldch = chip_smoke.system_vector(torch, args[4], args[5], prep,
                                         x=torch.cholesky_solve(v, F))
    assert_close(ldg, dg, chip_smoke.SOLVE_RTOL, "dg")
    assert_close(ldch, dch, chip_smoke.SOLVE_RTOL, "dch")

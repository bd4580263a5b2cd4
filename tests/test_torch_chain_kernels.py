"""PyTorch port, chain factorize: the plain twin of the CUDA kernel
(chain_blocks_factor_ref, what the wrapper runs on CPU tensors) against the
JAX Pallas kernel (interpret mode) on the same operands."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks import models as jmodels
from treeqp_tpu.ops import chain_kernels as jck

from treeqp_tpu_torch import convert
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

_JITTED = {}


def _static_key(v):
    """A cache key for a static argument: its value where hashable, a numpy
    array's bytes, else the object itself by identity (the cache keeps it
    alive)."""
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    try:
        hash(v)
        return v
    except TypeError:
        return ("id", id(v))


def jax_ref(fn, *args, **static):
    """The JAX reference fn(*args, **static) under one ``jax.jit`` per (fn,
    static) for the test process: ``args`` (arrays, and pytrees of them) are
    traced, ``static`` bound. Tests that call an interpret-mode Pallas
    reference at equal shapes then share its trace, lowering and compile,
    which take 10-60 s on the CPU against milliseconds of running."""
    key = (fn, tuple((k, _static_key(v)) for k, v in sorted(static.items())))
    if key not in _JITTED:
        _JITTED[key] = (jax.jit(functools.partial(fn, **static)), static)
    return _JITTED[key][0](*args)

CASES = {
    "quadcopter": lambda: jmodels.quadcopter(2, 2, 6).qp,
    "spring_mass_chain": lambda: jmodels.spring_mass_chain(nm=2, md=3, Nr=2, Nh=8)[0],
}
OPTS = td.TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=120,
                     factor_dtype="float32", refine_steps=2,
                     refine_safeguard=False, chain_backend="pallas",
                     reg_type="always", reg_value=1e-6)
# f32 on both sides with another summation order (tests/test_fused_eval.py)
RTOL = 1e-5
# dual points on the solver's path: the cold start, half-way, the solution.
# (Random dual points are a poor test: with many bounds clipped the chain
# blocks become so ill-conditioned that the 1-ulp difference between
# XLA's and PyTorch's f32 rsqrt is amplified past any f32 tolerance, or
# lose rank and give zero pivots in both implementations.)
POINTS = {"zero": 0.0, "half": 0.5, "solution": 1.0}


def factor_inputs(name, point):
    """The factor kernels' operands at a dual point of a case."""
    qp_j = CASES[name]()
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    ms = tm.split_multistage(qp)
    prep = td._get_prep(ms.meta.crown_topo)
    ctx = tm._solve_ctx(ms, prep)
    cro, cho, info = tm.tdunes_ms_solve(ms, None, None, OPTS)
    assert info["status"] == 0
    w = POINTS[point]
    cr, ch = tm._ms_stage_solve(ms, td._stage_data(ms.crown, OPTS, prep),
                                w * cro["lam"], w * cho["lam"], OPTS, prep,
                                ctx["rid"])
    return ms, prep, ctx, tm._factor_inputs(cr["qtilde"], cr["rtilde"],
                                            ch["qt"], ch["rt"], prep, ctx)


def assert_close(got, ref, rtol, what):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    bound = rtol * max(1.0, float(np.max(np.abs(ref))))
    assert float(np.max(np.abs(got - ref))) <= bound, what


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("point", sorted(POINTS))
def test_chain_blocks_factor_matches_pallas(name, point):
    _, _, _, inp = factor_inputs(name, point)
    ABt, ztp, qtc, s_root = inp["chain"]
    Ls, CUs, schur0, sc = ck.chain_blocks_factor_ref(ABt, ztp, qtc, s_root)
    jLs, jCUs, jschur0, jsc = jax_ref(
        jck.chain_blocks_factor, *(jnp.asarray(t.numpy()) for t in (ABt, ztp, qtc, s_root)))
    S = ABt.shape[0]
    lanes = lambda v: np.transpose(np.asarray(v)[..., :S], (3, 0, 1, 2))
    assert_close(Ls, lanes(jLs), RTOL, "Ls")
    assert_close(CUs, lanes(jCUs), RTOL, "CUs")
    assert_close(schur0, jschur0, RTOL, "schur0")
    assert_close(sc, jsc, RTOL, "sc")


def test_chain_blocks_factor_cpu_wrapper_runs_plain_twin():
    _, _, _, inp = factor_inputs("quadcopter", "half")
    for a, b in zip(ck.chain_blocks_factor(*inp["chain"]),
                    ck.chain_blocks_factor_ref(*inp["chain"])):
        assert torch.equal(a, b)
    assert ck.chain_blocks_factor.launches == 0


def test_chain_blocks_factor_rejects_non_cuda_device():
    """Off the CPU, the wrapper launches the kernel or raises: a tensor on
    another device is refused before any build."""
    _, _, _, inp = factor_inputs("quadcopter", "half")
    with pytest.raises(ValueError, match="expected"):
        ck.chain_blocks_factor(*(t.to("meta") for t in inp["chain"]))


# The CUDA kernel's edges (csrc/chain_blocks_factor.cu: one instantiation
# per nx, a 4-stage ring of the steps' sources), the shapes and seeded
# operands the smoke holds the kernel to its twin at: one step, L past the
# ring, nx = 1, an odd nx and the widest, nx = 16 (the L = 130 chain is
# left to the card: the interpret-mode Pallas kernel unrolls its steps).
EDGES = {f"S{S}_L{L}_nx{nx}_nz{nz}": (k, (S, L, nx, nz))
         for k, (S, L, nx, nz) in enumerate(chip_smoke.BLOCK_EDGES) if L <= 7}


@pytest.mark.parametrize("form", ["stacked", "lanes"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_chain_blocks_factor_edges_match_pallas(edge, form):
    """Both twins against the interpret-mode Pallas kernels at the CUDA
    kernel's edge shapes (``chip_smoke.block_operands``: one chain system
    in both forms; the lanes form's Pallas kernel takes the chain
    evaluation's lane layout, padded to its 128 lanes)."""
    k, (S, L, nx, nz) = EDGES[edge]
    stacked, lanes = chip_smoke.block_operands(torch, S, L, nx, nz, k, torch.device("cpu"))
    if form == "stacked":
        got = ck.chain_blocks_factor_ref(*stacked)
        ref = jck.chain_blocks_factor(*(jnp.asarray(t.numpy()) for t in stacked))
    else:
        got = ck.chain_blocks_factor_lanes_ref(*lanes)
        ABt, qt, rt, root, s_root = (t.numpy() for t in lanes)
        pad = lambda v, fill: np.concatenate(
            [v, np.full(v.shape[:-1] + (128 - S,), fill, np.float32)], axis=-1)
        ref = jck.chain_blocks_factor_lanes(
            jnp.asarray(pad(np.transpose(ABt, (1, 2, 3, 0)), 0.0)),
            jnp.asarray(pad(np.transpose(qt, (1, 2, 0)), 1.0)),
            jnp.asarray(pad(np.transpose(rt, (1, 2, 0)), 0.0)),
            jnp.asarray(root), jnp.asarray(s_root))
    jLs, jCUs, jschur0, jsc = ref
    lanes4 = lambda v: np.transpose(np.asarray(v)[..., :S], (3, 0, 1, 2))
    Ls, CUs, schur0, sc = got
    assert_close(Ls, lanes4(jLs), RTOL, "Ls")
    assert_close(CUs, lanes4(jCUs), RTOL, "CUs")
    assert_close(schur0, jschur0, RTOL, "schur0")
    assert_close(sc, jsc, RTOL, "sc")

"""PyTorch port, the plain twins of the serial chain kernels against the
JAX package's Pallas kernels (interpret mode) at new chain lengths and
state dims: L in (1, 2, 17), n in (1, 6, 8, 16), on five chains of
tests/test_torch_chain_cr.py's seeded blocks. The factor twin
(chain_factor_ref) is held against the Pallas chain_factor on the blocks;
the sweep twins (chain_solve_bwd_ref, chain_forward_ref) against the Pallas
chain_solve_bwd and chain_forward, both sides sweeping the factor twin's
factors. The twins have no shared-memory ring and no lane groups:
chip_smoke.py holds the card's kernels against these twins at the ring's
edges."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import chain_kernels as jck

from test_torch_chain_cr import blocks, rhs
from test_torch_chain_kernels import assert_close
from test_torch_generic_kernels import FACTOR_RTOL, SOLVE_RTOL, lanes, t32
from treeqp_tpu_torch.ops import chain_kernels as ck

S = 5

EDGES = [(L, n) for L in (1, 2, 17) for n in (1, 6, 8, 16)]


def lane_layout(x):
    """Port factors [S, L, n, n] -> the Pallas kernels' lane layout
    [L, n, n, 128], identity blocks on the padded lanes as jck.chain_factor
    pads them."""
    n = x.shape[-1]
    out = np.zeros((*x.shape[1:], 128), np.float32)
    out[..., S:] = np.eye(n, dtype=np.float32)[None, :, :, None]
    out[..., :S] = x.numpy().transpose(1, 2, 3, 0)
    return jnp.asarray(out)


@functools.lru_cache(maxsize=None)
def pallas_bwd(L, n):
    """The operands at (L, n) and the Pallas backward sweep on them (both
    tests of a shape read it; interpreting the kernel dominates)."""
    Wc, Utc = blocks(S, L, n)
    Ls, CUs, _ = ck.chain_factor_ref(torch.tensor(Wc), torch.tensor(Utc))
    Lt, CUt = lane_layout(Ls), lane_layout(CUs)
    res, droot = rhs(S, L, n)
    jys, jradd0 = jck.chain_solve_bwd(Lt, CUt, jnp.asarray(res))
    return Ls, CUs, Lt, CUt, res, droot, jys, jradd0


@pytest.mark.parametrize("L,n", EDGES)
def test_chain_factor_twin_matches_pallas(L, n):
    """The factor twin against the Pallas chain_factor (its factors moved
    out of the lane layout) at 1e-5 x max(1, max|ref|)."""
    Wc, Utc = blocks(S, L, n)
    Ls, CUs, schur0 = ck.chain_factor_ref(torch.tensor(Wc), torch.tensor(Utc))
    jLs, jCUs, jschur0 = jck.chain_factor(jnp.asarray(Wc), jnp.asarray(Utc))
    assert Ls.shape == CUs.shape == (S, L, n, n) and schur0.shape == (S, n, n)
    assert_close(Ls, lanes(jLs, S), FACTOR_RTOL, "Ls")
    assert_close(CUs, lanes(jCUs, S), FACTOR_RTOL, "CUs")
    assert_close(schur0, jschur0, FACTOR_RTOL, "schur0")


@pytest.mark.parametrize("L,n", EDGES)
def test_chain_solve_bwd_twin_matches_pallas(L, n):
    Ls, CUs, _, _, res, _, jys, jradd0 = pallas_bwd(L, n)
    ys, radd0 = ck.chain_solve_bwd_ref(Ls, CUs, t32(res))
    assert ys.shape == (S, L, n) and radd0.shape == (S, n)
    assert_close(ys, lanes(jys, S), SOLVE_RTOL, "ys")
    assert_close(radd0, jradd0, SOLVE_RTOL, "radd0")


@pytest.mark.parametrize("L,n", EDGES)
def test_chain_forward_twin_matches_pallas(L, n):
    """The forward sweep from the Pallas backward sweep's ys, on both sides."""
    Ls, CUs, Lt, CUt, _, droot, jys, _ = pallas_bwd(L, n)
    jdls = jck.chain_forward(Lt, CUt, jys, jnp.asarray(droot))
    dls = ck.chain_forward_ref(Ls, CUs, t32(lanes(jys, S)), t32(droot))
    assert dls.shape == (S, L, n)
    assert_close(dls, jdls, SOLVE_RTOL, "dls")

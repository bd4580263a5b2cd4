"""PyTorch port: the cyclic-reduction chain sweeps (``ops/chain_cr.py``).

The plain twins of chain_cr_precompute, chain_solve_bwd_cr and
chain_forward_cr (what the wrappers run on CPU tensors) against the JAX
package's Pallas kernels (interpret mode, as tests/test_chain_cr.py runs
them) on the factors of the JAX ``chain_factor``, moved from its lane
layout [L, n, n, S_pad] to the port's [S, L, n, n]; and, torch only, the
CR twins against the serial twins (chain_solve_bwd_ref, chain_forward_ref)
and the operators against their definition in f64, over chain lengths
that are and are not powers of two and at the CUDA kernels' edges; and
the launch shapes (``precompute_launch``, ``sweep_launch``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import chain_cr as jcr
from treeqp_tpu.ops import chain_kernels as jck

from test_torch_chain_kernels import assert_close
from treeqp_tpu_torch.ops import chain_cr as cr
from treeqp_tpu_torch.ops import chain_kernels as ck

torch.set_num_threads(1)

# the absolute bound of tests/test_chain_cr.py (f32 sweeps of O(1) data)
ATOL = 2e-4
# f32 factors to 1e-5 relative to max(1, max|ref|), as everywhere in the port
FACTOR_RTOL = 1e-5


def blocks(S, L, n, seed=0):
    """tests/test_chain_cr.py's chain blocks: W = A A' + 3 I, Ut = 0.3 N."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((S, L, n, n))
    Wc = (A @ A.transpose(0, 1, 3, 2) + 3.0 * np.eye(n)).astype(np.float32)
    Utc = (0.3 * rng.standard_normal((S, L, n, n))).astype(np.float32)
    return Wc, Utc


def rhs(S, L, n):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((S, L, n)).astype(np.float32),
            rng.standard_normal((S, n)).astype(np.float32))


@pytest.mark.parametrize("dims", [
    pytest.param((3, 16, 8), marks=pytest.mark.slow),  # the headline-ish shape
    (2, 6, 3),
])
def test_cr_twins_match_pallas(dims):
    S, L, n = dims
    Wc, Utc = blocks(S, L, n)
    Lt, CUt, _ = jck.chain_factor(jnp.asarray(Wc), jnp.asarray(Utc))
    res, droot = rhs(S, L, n)
    Ab_j, Bf_j = jcr.chain_cr_precompute(Lt, CUt)
    ys_j, radd_j = jcr.chain_solve_bwd_cr(Lt, CUt, Ab_j, jnp.asarray(res))
    dls_j = jcr.chain_forward_cr(Lt, CUt, Bf_j, ys_j, jnp.asarray(droot))

    mats = lambda v: torch.tensor(np.transpose(np.asarray(v)[..., :S], (3, 0, 1, 2)))
    vecs = lambda v: np.transpose(np.asarray(v)[..., :S], (2, 0, 1))
    Ls, CUs = mats(Lt), mats(CUt)
    Ab, Bf = cr.chain_cr_precompute(Ls, CUs)
    assert_close(Ab, mats(Ab_j), FACTOR_RTOL, "Abwd")
    assert_close(Bf, mats(Bf_j), FACTOR_RTOL, "Bfwd")
    ys, radd = cr.chain_solve_bwd_cr(Ls, CUs, Ab, torch.tensor(res))
    dls = cr.chain_forward_cr(Ls, CUs, Bf, ys, torch.tensor(droot))
    np.testing.assert_allclose(ys.numpy(), vecs(ys_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(radd.numpy(), np.asarray(radd_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dls.numpy(), np.asarray(dls_j), rtol=0, atol=ATOL)


def port_factors(S, L, n):
    Wc, Utc = blocks(S, L, n)
    return ck.chain_factor_ref(torch.tensor(Wc), torch.tensor(Utc))[:2]


@pytest.mark.parametrize("n", [3, 6, 8, 16])
@pytest.mark.parametrize("L", [1, 2, 5, 16, 20, 33])
def test_cr_twins_match_serial_twins(L, n):
    """The CR pair against the serial pair on the same factors and
    right-hand sides, and the operators against their definition."""
    S = 3
    Ls, CUs = port_factors(S, L, n)
    res, droot = (torch.tensor(v) for v in rhs(S, L, n))
    Ab, Bf = cr.chain_cr_precompute(Ls, CUs)
    A_def, B_def = precompute_definition(Ls, CUs)
    assert_close(Ab.double(), A_def, FACTOR_RTOL, "Abwd")
    assert_close(Bf.double(), B_def, FACTOR_RTOL, "Bfwd")
    ys_s, radd_s = ck.chain_solve_bwd_ref(Ls, CUs, res)
    dls_s = ck.chain_forward_ref(Ls, CUs, ys_s, droot)
    ys, radd = cr.chain_solve_bwd_cr(Ls, CUs, Ab, res)
    dls = cr.chain_forward_cr(Ls, CUs, Bf, ys, droot)
    for got, ref in ((ys, ys_s), (radd, radd_s), (dls, dls_s)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    # ys of either backward sweep feeds either forward sweep
    np.testing.assert_allclose(ck.chain_forward_ref(Ls, CUs, ys, droot).numpy(),
                               dls_s.numpy(), rtol=0, atol=ATOL)


def precompute_definition(Ls, CUs):
    """Abwd, Bfwd of chain_cr_precompute by their definition, in f64."""
    L64, CU64 = Ls.double(), CUs.double()
    A_def = torch.zeros_like(CU64)
    A_def[:, :-1] = -torch.linalg.solve_triangular(L64[:, :-1], CU64[:, 1:], upper=False)
    return A_def, -torch.linalg.solve_triangular(L64.mT, CU64.mT, upper=True)


# chip_smoke.py's CR_EDGES (S, L, n): one node, n = 1, odd n, 16 lanes a
# node, the longest chain
@pytest.mark.parametrize("shape", [(3, 1, 6), (5, 2, 1), (5, 17, 5), (3, 33, 16),
                                   (2, 240, 16)])
def test_precompute_twin_at_kernel_edges(shape):
    """The precompute twin (what the card's kernel is held to) against the
    operators' definition at the CUDA kernels' edges."""
    Ls, CUs = port_factors(*shape)
    Ab, Bf = cr.chain_cr_precompute(Ls, CUs)
    A_def, B_def = precompute_definition(Ls, CUs)
    assert_close(Ab.double(), A_def, FACTOR_RTOL, "Abwd")
    assert_close(Bf.double(), B_def, FACTOR_RTOL, "Bfwd")
    assert torch.equal(Ab[:, -1], torch.zeros_like(Ab[:, -1]))


@pytest.mark.parametrize("shape, launch", [
    ((128, 16, 6), (64, 592)),     # pruned: 4 nodes a block, 4 x 36 floats + 16 B
    ((256, 16, 8), (64, 1040)),    # random
    ((256, 20, 8), (64, 1040)),    # sdunes
    ((4, 130, 16), (64, 2064)),    # 2 nodes of 16 + 16 lanes
    ((3, 1, 6), (64, 592)),        # CR_EDGES
    ((5, 2, 1), (64, 32)),
    ((5, 17, 5), (64, 416)),
    ((3, 33, 16), (64, 2064)),
    ((2, 240, 16), (64, 2064)),
])
def test_precompute_launch(shape, launch):
    """The precompute's block (threads, shared bytes), which chip_smoke.py
    holds to the kernel's tq_chain_cr_precompute_launch on the card: one
    warp of A's lane groups and one of B's, 32 / G nodes whose Ls blocks
    are staged as one range, 16 bytes more for its offset; no opt-in."""
    S, L, n = shape
    assert cr.precompute_launch(n) == launch
    threads, smem = launch
    G = 8 if n <= 8 else 16
    assert threads == 2 * 32 and smem == 32 // G * n * n * 4 + 16 <= 48 * 1024


@pytest.mark.parametrize("shape, launch", [
    ((128, 16, 6), (128, 2864, 0)),     # pruned: 16 groups of 8 lanes, one round
    ((256, 20, 8), (160, 6048, 0)),     # sdunes
    ((4, 130, 16), (704, 142496, 0)),   # 3 rounds of 44 groups of 16, in shared memory
    ((2, 240, 16), (960, 0, 65280)),    # past 227 KB: the global scratch, 4 rounds
])
def test_sweep_launch(shape, launch):
    """The CR sweeps' launch (threads, shared bytes, scratch floats a
    chain), which csrc/chain_cr.cu's sweep_threads / sweep_smem_bytes make
    and the wrappers size the scratch by; chip_smoke.py holds the two
    against each other on the card."""
    S, L, n = shape
    assert cr.sweep_launch(L, n) == launch
    threads, smem, scratch = launch
    assert threads % 32 == 0 and threads <= 1024
    assert (smem == 0) == (scratch > 0) and smem <= 227 * 1024
    sc = cr._scratch(S, L, n, torch.device("cpu"))
    assert (sc is None) if scratch == 0 else sc.shape == (S, scratch)

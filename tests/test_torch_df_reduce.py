"""PyTorch port, the fixed-order f64 reduction: the plain twin of
``df_reduce_flat`` (what the wrapper runs on CPU tensors) against an exactly
rounded sum (``math.fsum``) and against the JAX package's double-float
``df_reduce_flat`` (Pallas interpret mode), on the inputs of
tests/test_df_reduce.py; and a numpy emulation of the CUDA kernel's
two-level order (csrc/df_reduce.cu) against the twin, bit for bit."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import df64 as jdf
from treeqp_tpu.ops import df_reduce as jdr

from treeqp_tpu_torch.ops import df_reduce as dr

SIZES = [1, 7, 128, 1024, 1025, 50000]
# a binary tree of f64 adds is within log2(n) ulps of the sum of |x| (2e-15
# at 50000 elements)
FSUM_RTOL = 1e-14
# the JAX kernel's double-float words carry ~48 bits
JAX_RTOL = 1e-13


def cancelling(n, seed):
    """tests/test_df_reduce.py's data: large paired +/- values plus a small
    signal."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n)
    a[: n // 2 * 2: 2] *= 1e4
    a[1: n // 2 * 2: 2] = -a[: n // 2 * 2: 2][: n // 2] + rng.standard_normal(n // 2) * 1e-6
    return a


@pytest.mark.parametrize("n", SIZES)
def test_twin_matches_fsum(n):
    a = cancelling(n, seed=n)
    got = dr.df_reduce_flat_ref(torch.tensor(a))
    assert got.shape == () and got.dtype == torch.float64
    scale = max(float(np.sum(np.abs(a))), 1.0)
    assert abs(float(got) - math.fsum(a)) <= FSUM_RTOL * scale


@pytest.mark.parametrize("n", SIZES)
def test_twin_matches_jax_kernel(n):
    a = cancelling(n, seed=n)
    got = float(dr.df_reduce_flat_ref(torch.tensor(a)))
    ref = jdr.df_reduce_flat(jdf.from_f64(jnp.asarray(a)))
    scale = max(float(np.sum(np.abs(a))), 1.0)
    assert abs(got - (float(ref.hi) + float(ref.lo))) <= JAX_RTOL * scale


def test_zero_padding_and_order_are_fixed():
    """Appending zeros does not change the sum bit for bit; the folds pair
    x[i] with x[i + h], not neighbours."""
    a = torch.tensor(cancelling(130, seed=3))
    got = dr.df_reduce_flat_ref(a)
    assert torch.equal(got, dr.df_reduce_flat_ref(torch.cat([a, torch.zeros(126, dtype=torch.float64)])))
    x = torch.tensor([1.0, 1e16, -1e16, 1.0], dtype=torch.float64)
    # (1 + -1e16) + (1e16 + 1) rounds to -1e16 + 1e16 = 0; the exact sum is 2
    assert float(dr.df_reduce_flat_ref(x)) == 0.0
    assert float(dr.df_reduce_flat_ref(torch.zeros(0, dtype=torch.float64))) == 0.0


def test_cpu_wrapper_runs_plain_twin():
    a = torch.tensor(cancelling(1025, seed=5))
    assert torch.equal(dr.df_reduce_flat(a), dr.df_reduce_flat_ref(a))
    assert dr.df_reduce_flat.launches == 0
    with pytest.raises(ValueError, match="expected"):
        dr.df_reduce_flat(a.to("meta"))


# the CUDA kernel's shape (csrc/df_reduce.cu): kThreads threads a block,
# kCol values a thread folds in registers, one block up to K_SINGLE values,
# else one cluster of kCluster blocks
K_THREADS, K_COL, K_CLUSTER = 256, 16, 8
K_SINGLE = K_THREADS * K_COL


def halving(v):
    """The halving folds of v along axis 0 (a power of two long) to one row."""
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        v = v[:h] + v[h:]
    return v[0]


def brev(q, bits):
    return int(format(q, f"0{bits}b")[::-1], 2) if bits else 0


def kernel_order(a, G):
    """The kernel's sum of ``a`` with G columns (the kernel's own count for
    G=None): zero-pad to m; m <= K_SINGLE (G=None) or m <= G: one block (its
    columns of stride min(m, kThreads) folded in registers, then those);
    else column r of x[r + k G] (c = m / G values) folded by halving for
    c <= kCol, else as the pairwise sum over bit-reversed k (chunks of kCol
    consecutive positions, a halving fold each, combined in order by a
    binary-counter stack), then the G partials folded by halving (the
    kernel's blocks fold them down to their residues, block 0 the rest: the
    same pairs)."""
    m = dr._padded_size(a.size)
    x = np.concatenate([a, np.zeros(m - a.size)])

    def block(v):
        W = min(v.size, K_THREADS)
        return halving(halving(v.reshape(-1, W)))
    if G is None:
        if m <= K_SINGLE:
            return block(x)
        G = K_CLUSTER * K_THREADS
    if m <= G:
        return block(x)
    X = x.reshape(-1, G)  # row k: x[k G .. (k + 1) G)
    c = X.shape[0]
    if c <= K_COL:
        return halving(halving(X))
    lq = c.bit_length() - 1 - (K_COL.bit_length() - 1)
    stack, res = {}, None
    for q in range(1 << lq):
        s = halving(X[brev(q, lq) + (1 << lq) * np.arange(K_COL)])
        lvl = 0
        while (q >> lvl) & 1:
            s = stack[lvl] + s
            lvl += 1
        stack[lvl] = res = s
    return halving(res)


SIZES_2L = (0, 1, 2, 3, 1000, K_SINGLE - 1, K_SINGLE, K_SINGLE + 1, 26624, 50000,
            3 * 2 ** 17 + 5)
TWO_LEVEL = [(G, n) for G in (None, 256) for n in SIZES_2L]


@pytest.mark.parametrize("G,n", TWO_LEVEL)
def test_kernel_two_level_order_matches_twin(G, n):
    """The order the kernel relies on: the halving folds of the columns of
    stride G (bit-reversed pairwise for long columns), then of the G
    partials, give the twin's sum bit for bit; G the kernel's own column
    count (None) and 256."""
    a = cancelling(n, seed=n + (G or 0))
    got = np.float64(kernel_order(a, G))
    ref = dr.df_reduce_flat_ref(torch.tensor(a)).numpy()
    assert got.view(np.int64) == ref.view(np.int64), (float(got), float(ref))

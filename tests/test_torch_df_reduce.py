"""PyTorch port, the fixed-order f64 reduction: the plain twin of
``df_reduce_flat`` (what the wrapper runs on CPU tensors) against an exactly
rounded sum (``math.fsum``) and against the JAX package's double-float
``df_reduce_flat`` (Pallas interpret mode), on the inputs of
tests/test_df_reduce.py."""

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

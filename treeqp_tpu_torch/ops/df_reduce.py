"""Fixed-order f64 sum of a vector: the reduction of the high-precision
phase's dual values and directional derivatives.

Port of ``treeqp_tpu/ops/df_reduce.py``. The JAX kernel sums (hi, lo) f32
pairs with an ordered two-sum tree, because TPU Pallas has no f64; the
H100 has native FP64, so the values here are doubles. What carries over is
the fixed order: the Armijo test compares dual values of O(1e3) that differ
by ~1e-10, so the sum must be the same on every run. The order is: pad with
zeros to a power of two, then fold halves (``x = x[:h] + x[h:]``) down to
one value. ``df_reduce_flat`` launches ``csrc/df_reduce.cu`` on a CUDA
tensor, which forms the same sum over many SMs in two levels (the halving
folds of the columns x[r], x[r + G], ... for r < G, then of those G
partials: the same additions) and so matches the plain twin
``df_reduce_flat_ref`` (what it runs on a CPU tensor) bit for bit. Any
size is allowed; the JAX kernel's chunking above ``MAX_ELEMS`` was a VMEM
limit and is not carried over.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _build

__all__ = ["df_reduce_flat", "df_reduce_flat_ref"]


def _padded_size(n: int) -> int:
    """The next power of two >= n (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def df_reduce_flat_ref(x):
    """Plain PyTorch twin of the kernel (see ``df_reduce_flat``)."""
    x = x.reshape(-1)
    x = torch.cat([x, x.new_zeros(_padded_size(x.numel()) - x.numel())])
    while x.numel() > 1:
        h = x.numel() // 2
        x = x[:h] + x[h:]
    return x.reshape(())


def df_reduce_flat(x):
    """Sum of the f64 tensor ``x`` (any shape, flattened) as a 0-dim f64
    tensor, in the fixed halving-fold order of ``df_reduce_flat_ref``."""
    if x.device.type == "cpu":
        return df_reduce_flat_ref(x)
    name = "df_reduce_flat"
    f64 = torch.float64
    dev = x.device
    x = x.reshape(-1).contiguous()
    n = x.numel()
    _build.require(name, "x", x, (n,), dev, f64)
    out = torch.empty((), dtype=f64, device=dev)
    err = _build.lib().tq_df_reduce(x.data_ptr(), n, _padded_size(n), out.data_ptr(),
                                    _build.stream(dev))
    _build.check(err, name)
    df_reduce_flat.launches += 1
    return out


df_reduce_flat.launches = 0

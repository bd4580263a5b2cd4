"""Plain PyTorch versions of the per-block routines of ``csrc/tq_dense.cuh``,
batched over the leading dims: the arithmetic the kernels' plain twins
share. Same pivot rule and per-element summation order as the kernels and
the Pallas kernels they replace: every sum is accumulated term by term in
index order (no einsum / matmul, whose order is the library's), because
the blocks are ill-conditioned enough that a different f32 rounding order
shows in the factors."""

from __future__ import annotations

import torch

PIVOT_FLOOR = 1e-8


def outer_sum(X, Y, z=None):
    """sum_n (X[..., :, n] z[..., n]) Y[..., :, n]'  ([..., a, N], [..., b, N]
    -> [..., a, b]); z defaults to ones."""
    out = 0
    for n in range(X.shape[-1]):
        x = X[..., :, n] if z is None else X[..., :, n] * z[..., n:n + 1]
        out = out + x[..., :, None] * Y[..., None, :, n]
    return out


def sum_last(v):
    """v summed over its last index, term by term in index order."""
    out = 0
    for i in range(v.shape[-1]):
        out = out + v[..., i]
    return out


def mv(M, v, trans: bool = False):
    """M v (or M' v), summed over the contracted index in order."""
    out = 0
    for k in range(v.shape[-1]):
        col = M[..., k, :] if trans else M[..., :, k]
        out = out + col * v[..., k:k + 1]
    return out


def chol(W, reg: float = 0.0, clamp_diag: bool = False):
    """Lower Cholesky of [..., n, n] column by column: a = W[:, k] (+ reg on
    the diagonal) - sum_{m<k} L[:, m] L[k, m]; d = max(a_kk, 1e-8); rows
    below the diagonal a * rsqrt(d); diagonal d * rsqrt(d) if
    ``clamp_diag`` (crown kernels) else a_kk * rsqrt(d) (chain kernels)."""
    n = W.shape[-1]
    Lf = torch.zeros_like(W)
    for k in range(n):
        a = W[..., :, k].clone()
        a[..., k] += reg
        for m in range(k):
            a = a - Lf[..., :, m] * Lf[..., k:k + 1, m]
        d = torch.clamp(a[..., k:k + 1], min=PIVOT_FLOOR)
        dinv = torch.rsqrt(d)
        col = a * dinv
        if clamp_diag:
            col[..., k:k + 1] = d * dinv
        col[..., :k] = 0.0
        Lf[..., :, k] = col
    return Lf


def rtrsm_t(Lf, B):
    """X with X L' = B; L lower [..., n, n], B [..., m, n]."""
    n = Lf.shape[-1]
    X = torch.zeros_like(B)
    for j in range(n):
        acc = B[..., :, j]
        for c in range(j):
            acc = acc - X[..., :, c] * Lf[..., j:j + 1, c]
        X[..., :, j] = acc / Lf[..., j:j + 1, j]
    return X


def ltrsv(Lf, r):
    """y with L y = r; L [..., n, n], r [..., n]."""
    n = Lf.shape[-1]
    y = torch.zeros_like(r)
    for i in range(n):
        acc = r[..., i]
        for m in range(i):
            acc = acc - Lf[..., i, m] * y[..., m]
        y[..., i] = acc / Lf[..., i, i]
    return y


def uttrsv(Lf, d):
    """z with L' z = d; L [..., n, n], d [..., n]."""
    n = Lf.shape[-1]
    z = torch.zeros_like(d)
    for i in range(n - 1, -1, -1):
        acc = d[..., i]
        for m in range(i + 1, n):
            acc = acc - Lf[..., m, i] * z[..., m]
        z[..., i] = acc / Lf[..., i, i]
    return z


def mm(A, B, trans_a: bool = False):
    """A B (or A' B) for [..., n, n] A and [..., n, m] B, summed over the
    contracted index in order."""
    out = 0
    for k in range(A.shape[-1]):
        col = A[..., k, :] if trans_a else A[..., :, k]
        out = out + col[..., :, None] * B[..., k:k + 1, :]
    return out


def ltrsv_mat(Lf, R):
    """Y with L Y = R, column by column; L [..., n, n], R [..., n, m]."""
    n = Lf.shape[-1]
    Y = torch.zeros_like(R)
    for i in range(n):
        acc = R[..., i, :]
        for k in range(i):
            acc = acc - Lf[..., i, k:k + 1] * Y[..., k, :]
        Y[..., i, :] = acc / Lf[..., i, i:i + 1]
    return Y


def uttrsv_mat(Lf, D):
    """Z with L' Z = D, column by column; L [..., n, n], D [..., n, m]."""
    n = Lf.shape[-1]
    Z = torch.zeros_like(D)
    for i in range(n - 1, -1, -1):
        acc = D[..., i, :]
        for k in range(i + 1, n):
            acc = acc - Lf[..., k, i:i + 1] * Z[..., k, :]
        Z[..., i, :] = acc / Lf[..., i, i:i + 1]
    return Z

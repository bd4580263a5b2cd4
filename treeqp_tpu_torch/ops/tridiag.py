"""Batched block cyclic reduction for SPD block-tridiagonal systems.

Port of ``treeqp_tpu/ops/tridiag.py``, the portable solve of sdunes' "Jay"
system (the non-anticipativity couplings of adjacent scenarios, block
tridiagonal with P = Ns - 1 blocks), which the reference factors
sequentially (dual_Newton_scenarios.c:815-817). Cyclic reduction (even-odd
elimination) solves it in ceil(log2 P) levels of batched PyTorch ops: each
level Cholesky-factors all odd blocks at once, folds them into their even
neighbours, and recurses on the halved system. It runs on any device in
the dtype of its operands; ``ops/jay_kernel.py`` is the f32 CUDA kernel of
the same elimination order.

Convention: diag [P, b, b] (SPD blocks), off [P-1, b, b] with
off[i] = M[i+1, i], rhs [P, b].
"""

from __future__ import annotations

import torch

__all__ = ["tridiag_cr_solve"]


def _cholesky(D):
    """Lower Cholesky factors of a batch of blocks, with NaN in the lower
    triangle where a factorization fails (the JAX package's convention)."""
    L, info = torch.linalg.cholesky_ex(D)
    return torch.where(info[..., None, None] > 0, torch.full_like(L, torch.nan).tril(), L)


def _chol(D, shift, reg_tol):
    """Batched Cholesky with the on-the-fly Levenberg-Marquardt cascade of
    treeqp_dpotrf_l_with_reg_opts (dual_Newton_common.c:81-123), per block:
    factor, and take the factor WITH the per-row diagonal ``shift`` on the
    blocks whose smallest pivot is <= reg_tol or NaN (exactly singular).
    reg_tol < 0 applies the shift unconditionally; shift None disables.
    Both factorizations run batched and the choice is a select, with no
    host read."""
    if shift is None:
        return _cholesky(D)
    D1 = D + torch.diag_embed(shift)
    if reg_tol < 0:
        return _cholesky(D1)
    L0 = _cholesky(D)
    piv = torch.diagonal(L0, dim1=-2, dim2=-1).amin(dim=-1)
    need = ~(piv > reg_tol)  # NaN-safe: NaN compares false
    return torch.where(need[..., None, None], _cholesky(D1), L0)


def _cho_solve(L, B):
    """Solve (L L') X = B for batched [*, b, k] B."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def tridiag_cr_solve(diag, off, rhs, shift=None, reg_tol: float = -1.0):
    """Solve the SPD block-tridiagonal system by cyclic reduction.

    diag [P, b, b], off [P-1, b, b] (block (i+1, i)), rhs [P, b]. Returns
    x [P, b]. Exact (direct) up to roundoff; ceil(log2 P) batched levels
    instead of P sequential steps. ``shift`` ([P, b] per-row
    Levenberg-Marquardt diagonal) and ``reg_tol`` select the per-block
    regularized Cholesky (see ``_chol``): reg_tol >= 0 applies the shift on
    the fly only to blocks with pivots <= reg_tol.
    """
    P, b, _ = diag.shape
    if P == 1:
        return _cho_solve(_chol(diag, shift, reg_tol), rhs[..., None])[..., 0]
    zM = diag.new_zeros((1, b, b))
    zv = diag.new_zeros((1, b))
    # off padded to length P (zero: no right neighbour)
    offp = torch.cat([off, zM], dim=0)

    no = P // 2                               # odd blocks
    Lo = _chol(diag[1::2], None if shift is None else shift[1::2], reg_tol)
    Z1 = _cho_solve(Lo, offp[0:2 * no:2])     # D_o^-1 M[o, o-1]
    Z2 = _cho_solve(Lo, offp[1:2 * no + 1:2].mT)  # D_o^-1 M[o, o+1]
    zr = _cho_solve(Lo, rhs[1::2][..., None])[..., 0]

    ne = (P + 1) // 2
    # left odd neighbour of even e = 2j is odd j-1, right is odd j (zero
    # at the ends)
    Z2_l = torch.cat([zM, Z2], dim=0)[:ne]
    zr_l = torch.cat([zv, zr], dim=0)[:ne]
    Z1_r = torch.cat([Z1, zM], dim=0)[:ne]
    zr_r = torch.cat([zr, zv], dim=0)[:ne]
    offl = torch.cat([zM, offp], dim=0)[:ne * 2:2]   # off[e-1]
    offr_t = offp[0:2 * ne:2].mT                     # off[e]'

    D_new = diag[0::2] - offl @ Z2_l - offr_t @ Z1_r
    r_new = (rhs[0::2] - (offl @ zr_l[..., None])[..., 0]
             - (offr_t @ zr_r[..., None])[..., 0])
    # M'[j+1, j] = -off[e+1] Z1_j, e = 2j
    off_new = -offp[1:2 * (ne - 1):2] @ Z1[:ne - 1]

    x_ev = tridiag_cr_solve(D_new, off_new, r_new,
                            None if shift is None else shift[0::2], reg_tol)

    # back substitution of the odd blocks: x_o = zr_j - Z1_j x_2j - Z2_j x_2j+2
    x_r = torch.cat([x_ev[1:], zv], dim=0)[:no]
    x_odd = zr - (Z1 @ x_ev[:no][..., None])[..., 0] - (Z2 @ x_r[..., None])[..., 0]
    x = diag.new_empty((P, b))
    x[0::2] = x_ev[:ne]
    x[1::2] = x_odd
    return x

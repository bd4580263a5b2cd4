"""Chain-side factorize of the multistage dual Hessian.

Port of ``chain_blocks_factor`` in ``treeqp_tpu/ops/chain_kernels.py``
(the Pallas kernel there). ``chain_blocks_factor`` launches the CUDA kernel
of ``csrc/chain_blocks_factor.cu`` on CUDA tensors and runs the plain
PyTorch twin ``chain_blocks_factor_ref`` on CPU tensors. Both are f32,
like the Pallas kernel. The other chain kernels of that module (separate
factor / sweeps, the lane-layout variant, the multi-RHS solve, the fused
evaluation) are not ported yet.

The factor handles ``Ls``/``CUs`` are laid out ``[S, L, nx, nx]`` (the
JAX kernel's are ``[L, nx, nx, S_pad]``); only ``system_kernels`` reads
them.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _build, _dense

__all__ = ["chain_blocks_factor", "chain_blocks_factor_ref"]


def chain_blocks_factor_ref(ABt, ztp, qtc, s_root):
    """Plain PyTorch twin of the kernel (see ``chain_blocks_factor``)."""
    S, L, nx, nz = ABt.shape
    W = _dense.outer_sum(ABt, ABt, ztp) + torch.diag_embed(qtc)
    sc = torch.rsqrt(torch.clamp(torch.diagonal(W, dim1=2, dim2=3), min=1e-12))
    W = W * sc[..., :, None] * sc[..., None, :]
    # Ut[i, c] = -ztp[i] A[c, i], rows in the parent's scale, cols in sc
    Ut = -(ztp[..., :nx, None] * ABt[..., :nx].transpose(2, 3))
    scp = torch.cat([s_root[:, None], sc[:, :-1]], dim=1)
    Ut = Ut * scp[..., :, None] * sc[..., None, :]
    Ls = torch.empty((S, L, nx, nx), dtype=W.dtype, device=W.device)
    CUs = torch.empty_like(Ls)
    schur = torch.zeros((S, nx, nx), dtype=W.dtype, device=W.device)
    for j in range(L - 1, -1, -1):
        Lf = _dense.chol(W[:, j] - schur)
        CU = _dense.rtrsm_t(Lf, Ut[:, j])
        Ls[:, j], CUs[:, j] = Lf, CU
        schur = _dense.outer_sum(CU, CU)
    return Ls, CUs, schur, sc.contiguous()


def chain_blocks_factor(ABt, ztp, qtc, s_root):
    """Chain block build + Jacobi equilibration + banded backward
    factorization, per chain.

    ABt [S, L, nx, nz] edge dynamics [A B] into chain node j; ztp
    [S, L, nz] the parent's masked inverses (the crown root's at j=0); qtc
    [S, L, nx] the node's own x masked inverses; s_root [S, nx] the crown
    row scale of each chain's crown parent. All f32.

    Returns (Ls, CUs [S, L, nx, nx] factors, schur0 [S, nx, nx] the Schur
    block flowing into the crown, in crown scale, sc [S, L, nx] the chain
    Jacobi scales).
    """
    if ABt.device.type == "cpu":
        return chain_blocks_factor_ref(ABt, ztp, qtc, s_root)
    name = "chain_blocks_factor"
    S, L, nx, nz = ABt.shape
    dev = ABt.device
    for arg, t, shape in (("ABt", ABt, (S, L, nx, nz)), ("ztp", ztp, (S, L, nz)),
                          ("qtc", qtc, (S, L, nx)), ("s_root", s_root, (S, nx))):
        _build.require(name, arg, t, shape, dev)
    if not (0 < nx <= 16 and nx <= nz and S > 0 and L > 0):
        raise ValueError(f"{name}: unsupported shape {tuple(ABt.shape)}")
    f32 = dict(dtype=torch.float32, device=dev)
    Ls = torch.empty((S, L, nx, nx), **f32)
    CUs = torch.empty((S, L, nx, nx), **f32)
    schur0 = torch.empty((S, nx, nx), **f32)
    sc = torch.empty((S, L, nx), **f32)
    err = _build.lib().tq_chain_blocks_factor(
        ABt.data_ptr(), ztp.data_ptr(), qtc.data_ptr(), s_root.data_ptr(),
        Ls.data_ptr(), CUs.data_ptr(), schur0.data_ptr(), sc.data_ptr(),
        S, L, nx, nz, _build.stream(dev))
    _build.check(err, name)
    chain_blocks_factor.launches += 1
    return Ls, CUs, schur0, sc


chain_blocks_factor.launches = 0

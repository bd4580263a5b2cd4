"""Chain Riccati kernels of the multistage IPM: factorize, backward
right-hand-side sweep and forward sweep.

Port of ``ric_chain_factor``, ``ric_chain_bwd`` and ``ric_chain_fwd`` in
``treeqp_tpu/ops/riccati_kernels.py``. Each wrapper launches its CUDA
kernel (``csrc/ric_chain.cu``, one thread per scenario chain running the
whole length-L sweep) on CUDA tensors and runs its plain PyTorch twin
(``*_ref``) on CPU tensors. All are f32, like the Pallas kernels. For
j = L-1 .. 0 (j = 0 the chain node next to the crown):

    factor:  M_j = hbar_j + W,  Lu_j = chol(Muu_j + reg I) (pivot floor
             1e-8, clamped diagonal),  K_j = -Muu_j^-1 Mux_j,
             P_j = sym(Mxx_j + Mxu_j K_j),  W = AB_j' P_j AB_j
    rhs bwd: k_j = -Muu_j^-1 m_u,  p_j = m_x + Mxu_j k_j,
             w = AB_j' (P_j rb_j + p_j),  m = rg_j + w
    forward (j = 0 .. L-1): dx = AB_j z_prev + rb_j, du = K_j dx + k_j,
             dlam = P_j dx + p_j

with the chain-root terms W0 = W and w0 = w that flow into the crown. The
twins sum every product term by term in the Pallas kernels' order
(``ops/_dense.py``). Tensors are ``[S, L, ...]``; the JAX kernels' lane
layout ``[L, ..., S_pad]`` with its 128-lane padding and identity-padded
lanes is not carried over.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _build, _dense

__all__ = ["ric_chain_factor", "ric_chain_factor_ref", "ric_chain_bwd",
           "ric_chain_bwd_ref", "ric_chain_fwd", "ric_chain_fwd_ref",
           "stage_factor", "stage_bwd", "stage_fwd"]

_MAX_NZ = 16  # csrc/tq_riccati.cuh's per-thread block bound


# ---------------------------------------------------------------------------
# one Riccati stage, batched over the leading dims (shared with the crown
# kernels' twins in ops/crown_riccati.py)


def _trsm_cols(Lu, B, upper):
    """Lu^-1 B (or Lu^-T B) column by column; Lu [..., n, n], B [..., n, m]."""
    solve = _dense.uttrsv if upper else _dense.ltrsv
    return solve(Lu[..., None, :, :], B.mT).mT


def stage_factor(M, AB, nx, reg):
    """One stage: M [..., nz, nz], AB [..., nx, nz] -> (P, Lu, K, Mxu, W)
    with W = AB' P AB, the term its parent adds."""
    Lu = _dense.chol(M[..., nx:, nx:], reg=reg, clamp_diag=True)
    K = -_trsm_cols(Lu, _trsm_cols(Lu, M[..., nx:, :nx], False), True)
    Mxu = M[..., :nx, nx:]
    P = M[..., :nx, :nx] + _dense.outer_sum(Mxu, K.mT)
    P = 0.5 * (P + P.mT)
    tmp = _dense.outer_sum(P, AB.mT)           # P AB, summed over k
    W = _dense.outer_sum(AB.mT, tmp.mT)        # AB' tmp, summed over x
    return P, Lu, K, Mxu, W


def stage_bwd(m, P, Lu, Mxu, AB, rb, nx):
    """One stage of the rhs sweep: m [..., nz] -> (p, k, w = AB'(P rb + p))."""
    k = -_dense.uttrsv(Lu, _dense.ltrsv(Lu, m[..., nx:]))
    p = m[..., :nx] + _dense.mv(Mxu, k)
    v = _dense.mv(P, rb) + p
    return p, k, _dense.mv(AB, v, trans=True)


def stage_fwd(zp, P, K, AB, rb, p, k):
    """One stage of the forward sweep from the parent's dz ``zp``:
    returns (dz = [dx; du], dlam)."""
    dx = _dense.mv(AB, zp) + rb
    du = _dense.mv(K, dx) + k
    return torch.cat([dx, du], dim=-1), _dense.mv(P, dx) + p


# ---------------------------------------------------------------------------
# the chain kernels


def ric_chain_factor_ref(hbar, AB, reg=0.0):
    """Plain PyTorch twin of the kernel (see ``ric_chain_factor``)."""
    S, L, nx, nz = AB.shape
    dense = hbar.dim() == 4
    W = torch.zeros((S, nz, nz), dtype=AB.dtype, device=AB.device)
    outs = []
    for j in range(L - 1, -1, -1):
        M = W + (hbar[:, j] if dense else torch.diag_embed(hbar[:, j]))
        *fj, W = stage_factor(M, AB[:, j], nx, reg)
        outs.append(fj)
    P, Lu, K, Mxu = (torch.stack(v[::-1], dim=1) for v in zip(*outs))
    return dict(P=P, Luu=Lu, K=K, Mxu=Mxu, AB=AB), W


def _check_dims(name, S, L, nx, nz):
    if not (S > 0 and L > 0 and 0 < nx < nz <= _MAX_NZ):
        raise ValueError(f"{name}: unsupported shape S={S} L={L} nx={nx} nz={nz}")


def ric_chain_factor(hbar, AB, reg=0.0):
    """Backward Riccati factorization along every chain.

    hbar [S, L, nz] (diagonal stage Hessians, barrier included) or
    [S, L, nz, nz] (dense: general C/D rows), AB [S, L, nx, nz] the edge
    into chain node j; f32. Returns (fact, W0): fact = dict(P [S, L, nx,
    nx], Luu [S, L, nu, nu], K [S, L, nu, nx], Mxu [S, L, nx, nu], AB) for
    ``ric_chain_bwd`` / ``ric_chain_fwd``, and W0 [S, nz, nz] the chain
    roots' terms for the crown."""
    if AB.device.type == "cpu":
        return ric_chain_factor_ref(hbar, AB, reg)
    name = "ric_chain_factor"
    S, L, nx, nz = AB.shape
    nu = nz - nx
    dev = AB.device
    dense = hbar.dim() == 4
    _check_dims(name, S, L, nx, nz)
    _build.require(name, "hbar", hbar, (S, L, nz, nz) if dense else (S, L, nz), dev)
    _build.require(name, "AB", AB, (S, L, nx, nz), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    P = torch.empty((S, L, nx, nx), **f32)
    Lu = torch.empty((S, L, nu, nu), **f32)
    K = torch.empty((S, L, nu, nx), **f32)
    Mxu = torch.empty((S, L, nx, nu), **f32)
    W0 = torch.empty((S, nz, nz), **f32)
    err = _build.lib().tq_ric_chain_factor(
        hbar.data_ptr(), AB.data_ptr(), P.data_ptr(), Lu.data_ptr(), K.data_ptr(),
        Mxu.data_ptr(), W0.data_ptr(), S, L, nx, nz, int(dense), float(reg),
        _build.stream(dev))
    _build.check(err, name)
    ric_chain_factor.launches += 1
    return dict(P=P, Luu=Lu, K=K, Mxu=Mxu, AB=AB), W0


ric_chain_factor.launches = 0


def ric_chain_bwd_ref(fact, rg, rb):
    """Plain PyTorch twin of the kernel (see ``ric_chain_bwd``)."""
    P, Lu, Mxu, AB = fact["P"], fact["Luu"], fact["Mxu"], fact["AB"]
    S, L, nx, nz = AB.shape
    w = torch.zeros((S, nz), dtype=P.dtype, device=P.device)
    ps, ks = [], []
    for j in range(L - 1, -1, -1):
        p, k, w = stage_bwd(rg[:, j] + w, P[:, j], Lu[:, j], Mxu[:, j], AB[:, j],
                            rb[:, j], nx)
        ps.append(p)
        ks.append(k)
    return torch.stack(ps[::-1], dim=1), torch.stack(ks[::-1], dim=1), w


def _check_fact(name, fact, dev):
    S, L, nx, nz = fact["AB"].shape
    nu = nz - nx
    _check_dims(name, S, L, nx, nz)
    for k, shape in (("P", (nx, nx)), ("Luu", (nu, nu)), ("K", (nu, nx)),
                     ("Mxu", (nx, nu)), ("AB", (nx, nz))):
        _build.require(name, k, fact[k], (S, L, *shape), dev)
    return S, L, nx, nz


def ric_chain_bwd(fact, rg, rb):
    """Backward right-hand-side sweep with ``ric_chain_factor``'s factors.

    rg [S, L, nz], rb [S, L, nx] (cast to f32). Returns (p [S, L, nx],
    k [S, L, nu], w0 [S, nz] the chain roots' terms for the crown)."""
    P = fact["P"]
    rg, rb = rg.to(P.dtype).contiguous(), rb.to(P.dtype).contiguous()
    if P.device.type == "cpu":
        return ric_chain_bwd_ref(fact, rg, rb)
    name = "ric_chain_bwd"
    dev = P.device
    S, L, nx, nz = _check_fact(name, fact, dev)
    _build.require(name, "rg", rg, (S, L, nz), dev)
    _build.require(name, "rb", rb, (S, L, nx), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    p = torch.empty((S, L, nx), **f32)
    k = torch.empty((S, L, nz - nx), **f32)
    w0 = torch.empty((S, nz), **f32)
    ptrs = _build.ptr_array([P, fact["Luu"], fact["Mxu"], fact["AB"], rg, rb, p, k, w0])
    err = _build.lib().tq_ric_chain_bwd(ptrs, S, L, nx, nz, _build.stream(dev))
    _build.check(err, name)
    ric_chain_bwd.launches += 1
    return p, k, w0


ric_chain_bwd.launches = 0


def ric_chain_fwd_ref(fact, p, k, rb, z_root):
    """Plain PyTorch twin of the kernel (see ``ric_chain_fwd``)."""
    P, K, AB = fact["P"], fact["K"], fact["AB"]
    zp, dzs, dls = z_root, [], []
    for j in range(AB.shape[1]):
        zp, dl = stage_fwd(zp, P[:, j], K[:, j], AB[:, j], rb[:, j], p[:, j], k[:, j])
        dzs.append(zp)
        dls.append(dl)
    return torch.stack(dzs, dim=1), torch.stack(dls, dim=1)


def ric_chain_fwd(fact, p, k, rb, z_root):
    """Forward sweep down every chain from the crown's step at the chain
    roots' parents, ``z_root`` [S, nz]; p, k from ``ric_chain_bwd``, rb
    [S, L, nx] (cast to f32). Returns (dz [S, L, nz], dlam [S, L, nx])."""
    P = fact["P"]
    rb, z_root = rb.to(P.dtype).contiguous(), z_root.to(P.dtype).contiguous()
    if P.device.type == "cpu":
        return ric_chain_fwd_ref(fact, p, k, rb, z_root)
    name = "ric_chain_fwd"
    dev = P.device
    S, L, nx, nz = _check_fact(name, fact, dev)
    for arg, t, shape in (("p", p, (S, L, nx)), ("k", k, (S, L, nz - nx)),
                          ("rb", rb, (S, L, nx)), ("z_root", z_root, (S, nz))):
        _build.require(name, arg, t, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dz = torch.empty((S, L, nz), **f32)
    dl = torch.empty((S, L, nx), **f32)
    ptrs = _build.ptr_array([P, fact["K"], fact["AB"], rb, p, k, z_root, dz, dl])
    err = _build.lib().tq_ric_chain_fwd(ptrs, S, L, nx, nz, _build.stream(dev))
    _build.check(err, name)
    ric_chain_fwd.launches += 1
    return dz, dl


ric_chain_fwd.launches = 0

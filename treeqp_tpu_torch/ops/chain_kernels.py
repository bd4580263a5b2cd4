"""Chain kernels of the multistage dual Newton: factorize and evaluation.

Port of ``chain_blocks_factor``, ``chain_blocks_factor_lanes``,
``chain_eval`` and ``chain_eval_data`` in
``treeqp_tpu/ops/chain_kernels.py``. Each kernel wrapper launches its CUDA
kernel (``csrc/chain_blocks_factor.cu``, ``csrc/chain_eval.cu``) on CUDA
tensors and runs its plain PyTorch twin (``*_ref``) on CPU tensors. All are
f32, like the Pallas kernels. The other chain kernels of that module
(separate factor / sweeps, the multi-RHS solve) are not ported yet.

Every chain tensor is laid out ``[S, L, ...]`` (scenario first); the JAX
kernels' lane layout ``[L, ..., S_pad]`` is not carried over, so the
"lanes" variant of the factorize differs from the plain one only in where
it reads the parent's masked inverses. The factor handles ``Ls``/``CUs``
are ``[S, L, nx, nx]``; only ``system_kernels`` and ``iter_kernel`` read
them.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _build, _dense

__all__ = ["chain_blocks_factor", "chain_blocks_factor_ref",
           "chain_blocks_factor_lanes", "chain_blocks_factor_lanes_ref",
           "CHAIN_DATA_KEYS", "chain_eval_data", "chain_eval", "chain_eval_ref"]

# chain_eval_data's fields, in the order the CUDA kernels read them
CHAIN_DATA_KEYS = ("ABt", "q", "r", "Qd", "Rd", "Qinv", "Rinv", "xmin", "xmax",
                   "umin", "umax", "b")


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


def _factor_outputs(name, ABt):
    """The factor kernels' outputs (Ls, CUs, schur0, sc), after the shape
    check they share."""
    S, L, nx, nz = ABt.shape
    if not (0 < nx <= 16 and nx <= nz and S > 0 and L > 0):
        raise ValueError(f"{name}: unsupported shape {tuple(ABt.shape)}")
    f32 = dict(dtype=torch.float32, device=ABt.device)
    return (torch.empty((S, L, nx, nx), **f32), torch.empty((S, L, nx, nx), **f32),
            torch.empty((S, nx, nx), **f32), torch.empty((S, L, nx), **f32))


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
    Ls, CUs, schur0, sc = _factor_outputs(name, ABt)
    err = _build.lib().tq_chain_blocks_factor(
        ABt.data_ptr(), ztp.data_ptr(), qtc.data_ptr(), s_root.data_ptr(),
        Ls.data_ptr(), CUs.data_ptr(), schur0.data_ptr(), sc.data_ptr(),
        S, L, nx, nz, _build.stream(dev))
    _build.check(err, name)
    chain_blocks_factor.launches += 1
    return Ls, CUs, schur0, sc


chain_blocks_factor.launches = 0


def chain_blocks_factor_lanes_ref(ABt, qt, rt, ztp_root, s_root):
    """Plain PyTorch twin of the kernel (see ``chain_blocks_factor_lanes``)."""
    ztp_ch = torch.cat([qt, rt], dim=-1)
    ztp = torch.cat([ztp_root[:, None], ztp_ch[:, :-1]], dim=1)
    return chain_blocks_factor_ref(ABt, ztp, qt, s_root)


def chain_blocks_factor_lanes(ABt, qt, rt, ztp_root, s_root):
    """``chain_blocks_factor`` fed straight from the chain evaluation: the
    parent's masked inverses are the crown root's ``ztp_root`` at j = 0 and
    ``(qt, rt)_{j-1}`` for j >= 1, read inside the kernel.

    ABt [S, L, nx, nz] (``chain_eval_data``'s); qt [S, L, nx], rt [S, L, nu]
    (``chain_eval``'s); ztp_root [S, nz] the crown-root masked inverses;
    s_root [S, nx] the crown row scales. All f32. Returns (Ls, CUs, schur0,
    sc) as ``chain_blocks_factor``.
    """
    if ABt.device.type == "cpu":
        return chain_blocks_factor_lanes_ref(ABt, qt, rt, ztp_root, s_root)
    name = "chain_blocks_factor_lanes"
    S, L, nx, nz = ABt.shape
    dev = ABt.device
    for arg, t, shape in (("ABt", ABt, (S, L, nx, nz)), ("qt", qt, (S, L, nx)),
                          ("rt", rt, (S, L, nz - nx)),
                          ("ztp_root", ztp_root, (S, nz)),
                          ("s_root", s_root, (S, nx))):
        _build.require(name, arg, t, shape, dev)
    Ls, CUs, schur0, sc = _factor_outputs(name, ABt)
    err = _build.lib().tq_chain_blocks_factor_lanes(
        ABt.data_ptr(), qt.data_ptr(), rt.data_ptr(), ztp_root.data_ptr(),
        s_root.data_ptr(), Ls.data_ptr(), CUs.data_ptr(), schur0.data_ptr(),
        sc.data_ptr(), S, L, nx, nz, _build.stream(dev))
    _build.check(err, name)
    chain_blocks_factor_lanes.launches += 1
    return Ls, CUs, schur0, sc


chain_blocks_factor_lanes.launches = 0


def chain_eval_data(A, B, q, r, Qd, Rd, xmin, xmax, umin, umax, b,
                    dtype=torch.float32):
    """Loop-invariant operands of ``chain_eval`` (and of the chain half of
    ``iter_kernel.newton_iter``; with ``dtype=torch.float64``, of
    ``df_eval_kernels.chain_eval_df``), from the [S, L, ...] chain tensors
    of a ``MultistageQP``. The inverses are taken in the input dtype, then
    cast, as the JAX package does."""
    c = lambda v: v.to(dtype).contiguous()
    return dict(ABt=c(torch.cat([A, B], dim=3)), q=c(q), r=c(r), Qd=c(Qd),
                Rd=c(Rd), Qinv=c(1.0 / Qd), Rinv=c(1.0 / Rd), xmin=c(xmin),
                xmax=c(xmax), umin=c(umin), umax=c(umax), b=c(b))


def chain_data_shapes(S, L, nx, nu) -> dict:
    """The shape of each ``chain_eval_data`` field."""
    wide = dict(ABt=(nx, nx + nu), r=(nu,), Rd=(nu,), Rinv=(nu,), umin=(nu,),
                umax=(nu,))
    return {k: (S, L, *wide.get(k, (nx,))) for k in CHAIN_DATA_KEYS}


def chain_eval_ref(data, lam):
    """Plain PyTorch twin of the kernel (see ``chain_eval``)."""
    AB = data["ABt"]
    nx = AB.shape[2]
    lam = lam.to(AB.dtype)
    up = _dense.mv(AB[:, 1:], lam[:, 1:], trans=True)      # A_{j+1}' lam_{j+1}
    qmod = -data["q"] + lam
    qmod = torch.cat([qmod[:, :-1] - up[..., :nx], qmod[:, -1:]], dim=1)
    rmod = -data["r"]
    rmod = torch.cat([rmod[:, :-1] - up[..., nx:], rmod[:, -1:]], dim=1)
    xU = data["Qinv"] * qmod
    uU = data["Rinv"] * rmod
    x = torch.minimum(torch.maximum(xU, data["xmin"]), data["xmax"])
    u = torch.minimum(torch.maximum(uU, data["umin"]), data["umax"])
    qt = torch.where((xU > data["xmax"]) | (xU < data["xmin"]), 0.0, data["Qinv"])
    rt = torch.where((uU > data["umax"]) | (uU < data["umin"]), 0.0, data["Rinv"])
    res = data["b"] - x
    res = torch.cat([res[:, :1],
                     res[:, 1:] + _dense.mv(AB[:, 1:, :, :nx], x[:, :-1])
                     + _dense.mv(AB[:, 1:, :, nx:], u[:, :-1])], dim=1)
    tx = x * (qmod - 0.5 * data["Qd"] * x) - data["b"] * lam
    tu = u * (rmod - 0.5 * data["Rd"] * u)
    sx, su = _dense.sum_last(tx), _dense.sum_last(tu)
    f = torch.zeros_like(sx[:, 0])
    for j in range(sx.shape[1]):
        f = f + sx[:, j] + su[:, j]
    return dict(x=x, u=u, qt=qt, rt=rt, xUnc=xU, uUnc=uU, res_part=res,
                cqr=_dense.mv(AB[:, 0], lam[:, 0], trans=True), fch=f)


def chain_eval(data, lam):
    """Chain stage evaluation at the dual point ``lam`` [S, L, nx]:
    clipping stage solve, active-set masked inverses, chain-edge dual
    residuals, crown-root contributions and dual-value partials.

    ``data`` from ``chain_eval_data``; ``lam`` is cast to f32. Returns
    dict(x, u, qt, rt, xUnc, uUnc [S, L, ...]; res_part [S, L, nx] the
    residuals A_j z_{j-1} + b_j - x_j, whose row j = 0 holds b_0 - x_0 only
    (the caller adds A_0 z_crown); cqr [S, nz] = [A_0 B_0]' lam_0, the
    crown-root contributions; fch [S] the per-chain dual-value partial
    sums). All f32.
    """
    if lam.device.type == "cpu":
        return chain_eval_ref(data, lam)
    out = eval_launch("chain_eval", "tq_chain_eval", data, lam, torch.float32)
    chain_eval.launches += 1
    return out


chain_eval.launches = 0


def eval_launch(name, entry, data, lam, dtype):
    """Check the operands of a chain evaluation kernel of ``dtype`` (f32
    ``chain_eval`` or f64 ``chain_eval_df``) and launch it; returns its
    outputs (see ``chain_eval``)."""
    S, L, nx, nz = data["ABt"].shape
    nu = nz - nx
    dev = lam.device
    lam = lam.to(dtype).contiguous()
    _build.require(name, "lam", lam, (S, L, nx), dev, dtype)
    for k, shape in chain_data_shapes(S, L, nx, nu).items():
        _build.require(name, k, data[k], shape, dev, dtype)
    if not (0 < nx <= 16 and nu > 0 and S > 0 and L > 0):
        raise ValueError(f"{name}: unsupported shape {tuple(data['ABt'].shape)}")
    kw = dict(dtype=dtype, device=dev)
    out = dict(x=torch.empty((S, L, nx), **kw), u=torch.empty((S, L, nu), **kw),
               qt=torch.empty((S, L, nx), **kw), rt=torch.empty((S, L, nu), **kw),
               xUnc=torch.empty((S, L, nx), **kw), uUnc=torch.empty((S, L, nu), **kw),
               res_part=torch.empty((S, L, nx), **kw), fch=torch.empty((S,), **kw),
               cqr=torch.empty((S, nz), **kw))
    ptrs = _build.ptr_array(
        [data[k] for k in CHAIN_DATA_KEYS] + [lam]
        + [out[k] for k in ("x", "u", "qt", "rt", "xUnc", "uUnc", "res_part", "fch")]
        + [None, out["cqr"]])
    err = getattr(_build.lib(), entry)(ptrs, S, L, nx, nu, _build.stream(dev))
    _build.check(err, name)
    return out


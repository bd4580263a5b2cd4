"""Evaluation and Hessian-action kernels of the high-precision phase, in
native f64.

Port of ``treeqp_tpu/ops/df_eval_kernels.py``. The JAX kernels carry every
value as an (hi, lo) pair of f32 words (double-float, ``ops/df64.py``)
because TPU Pallas has no f64. The H100 has native FP64, so these kernels
keep the phase's math, semantics and kernel boundaries and compute in
``double``; ``ops/df64.py`` has no counterpart. Each wrapper launches its
CUDA kernel on CUDA tensors and runs its plain PyTorch twin (``*_ref``) on
CPU tensors:

* ``chain_eval_df`` (``csrc/chain_eval_df.cu``) — the chain evaluation:
  clipping stage solve, masked inverses, residual rows, root contributions
  and dual-value partials; the f32 ``chain_eval`` kernel in double, a
  thread a chain node (``chain_kernels.chain_node_launch``);
* ``crown_eval_df`` (``csrc/crown_eval_df.cu``) — the crown evaluation, the
  f32 ``crown_eval`` bodies in double on a lane group a node
  (``crown_kernels._crown_eval_launch``); the kid sums and the parent gather
  read ``crown_kernels.eval_sched``'s index lists instead of the TPU
  kernel's one-hot ``P_par``/``P_kid`` matrices, so the crown has no node
  cap;
* ``chain_apply_df`` / ``crown_apply_df`` (``csrc/chain_apply_df.cu``,
  ``csrc/crown_apply_df.cu``) — the two halves of the dual-Hessian action
  M d for iterative refinement, with the direction ``d`` in f32; the chain
  half a thread a chain node, as ``chain_eval_df``, the crown half a lane
  group a node, as ``crown_eval_df``.

Every product and sum is rounded on its own in the twins' order (no FMA
contraction), so a kernel reproduces its twin bit for bit on the card.
All tensors are node-major: chains ``[S, L, ...]``, crown ``[Nn, ...]``
(the JAX kernels' lane layouts are not carried over).
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _build, _dense
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import crown_kernels as ckr
from treeqp_tpu_torch.solvers.tdunes import _kid_sum

__all__ = ["chain_eval_df_data", "chain_eval_df", "chain_eval_df_ref",
           "chain_apply_df", "chain_apply_df_ref",
           "crown_eval_df_data", "crown_eval_df", "crown_eval_df_ref",
           "crown_apply_df", "crown_apply_df_ref"]

f64 = torch.float64


# ---------------------------------------------------------------------------
# chain side

def chain_eval_df_data(A, B, q, r, Qd, Rd, xmin, xmax, umin, umax, b):
    """Loop-invariant f64 operands of ``chain_eval_df`` and
    ``chain_apply_df``: ``chain_kernels.chain_eval_data``'s fields, not
    cast to f32."""
    return ck.chain_eval_data(A, B, q, r, Qd, Rd, xmin, xmax, umin, umax, b,
                              dtype=f64)


def chain_eval_df_ref(data, lam):
    """Plain PyTorch twin of the kernel (see ``chain_eval_df``): the f32
    twin's arithmetic on f64 data."""
    return ck.chain_eval_ref(data, lam)


def chain_eval_df(data, lam):
    """Chain stage evaluation at the dual point ``lam`` [S, L, nx], in f64.

    ``data`` from ``chain_eval_df_data``; ``lam`` is cast to f64. Returns
    ``chain_kernels.chain_eval``'s outputs in f64: x, u, qt, rt, xUnc, uUnc
    [S, L, ...]; res_part [S, L, nx] (row j = 0 without A_0 z_crown); cqr
    [S, nz] = [A_0 B_0]' lam_0; fch [S] the per-chain dual-value partials.
    """
    if lam.device.type == "cpu":
        return chain_eval_df_ref(data, lam)
    S, L, nx, nz = data["ABt"].shape
    C, _, _, staged, _ = ck.chain_node_launch(S, L, nx, nz - nx, 8)
    out = ck.eval_launch("chain_eval_df", "tq_chain_eval_df", data, lam, f64,
                         (C, int(staged)))
    chain_eval_df.launches += 1
    return out


chain_eval_df.launches = 0


def chain_apply_df_ref(data, qt, rt, d):
    """Plain PyTorch twin of the kernel (see ``chain_apply_df``)."""
    AB = data["ABt"]
    nx = AB.shape[2]
    d = d.to(AB.dtype)
    up = _dense.mv(AB[:, 1:], d[:, 1:], trans=True)        # [A B]_{j+1}' d_{j+1}
    qml = torch.cat([d[:, :-1] - up[..., :nx], d[:, -1:]], dim=1)
    zero = torch.zeros_like(rt)
    rml = torch.cat([zero[:, :-1] - up[..., nx:], zero[:, -1:]], dim=1)
    xl, ul = qt * qml, rt * rml
    res = -xl
    res = torch.cat([res[:, :1],
                     res[:, 1:] + _dense.mv(AB[:, 1:, :, :nx], xl[:, :-1])
                     + _dense.mv(AB[:, 1:, :, nx:], ul[:, :-1])], dim=1)
    return dict(xl=xl, ul=ul, res_part=res,
                cqr=_dense.mv(AB[:, 0], d[:, 0], trans=True))


def chain_apply_df(data, qt, rt, d):
    """Chain half of the dual-Hessian action M d, in f64.

    ``data`` from ``chain_eval_df_data``; qt [S, L, nx], rt [S, L, nu] the
    masked inverses (f64, from ``chain_eval_df``); d [S, L, nx] the f32
    direction. Returns dict(xl, ul [S, L, ...] the linear stage response
    xl = qt (d - A'd_up), ul = rt (0 - B'd_up); res_part [S, L, nx] the
    linearized residual rows -xl_j + A_j xl_{j-1} + B_j ul_{j-1}, whose row
    j = 0 holds -xl_0 only (the caller adds A_0 [xl; ul] of the crown
    root); cqr [S, nz] = [A_0 B_0]' d_0, the crown-root contributions).
    """
    if d.device.type == "cpu":
        return chain_apply_df_ref(data, qt, rt, d)
    name = "chain_apply_df"
    S, L, nx, nz = data["ABt"].shape
    nu = nz - nx
    dev = d.device
    d = d.contiguous()
    for arg, t, shape, dt in (("ABt", data["ABt"], (S, L, nx, nz), f64),
                              ("qt", qt, (S, L, nx), f64), ("rt", rt, (S, L, nu), f64),
                              ("d", d, (S, L, nx), torch.float32)):
        _build.require(name, arg, t, shape, dev, dt)
    if not (0 < nx <= 16 and nu > 0 and S > 0 and L > 0):
        raise ValueError(f"{name}: unsupported shape {tuple(data['ABt'].shape)}")
    kw = dict(dtype=f64, device=dev)
    out = dict(xl=torch.empty((S, L, nx), **kw), ul=torch.empty((S, L, nu), **kw),
               res_part=torch.empty((S, L, nx), **kw), cqr=torch.empty((S, nz), **kw))
    C, _, _, staged, _ = ck.chain_node_launch(S, L, nx, nu, 8, apply=True)
    err = _build.lib().tq_chain_apply_df(
        data["ABt"].data_ptr(), qt.data_ptr(), rt.data_ptr(), d.data_ptr(),
        out["xl"].data_ptr(), out["ul"].data_ptr(), out["res_part"].data_ptr(),
        out["cqr"].data_ptr(), S, L, nx, nu, C, int(staged), _build.stream(dev))
    _build.check(err, name)
    chain_apply_df.launches += 1
    return out


chain_apply_df.launches = 0


# ---------------------------------------------------------------------------
# crown side


def crown_eval_df_data(qp, prep, xm, um, nrxm):
    """Loop-invariant f64 operands of ``crown_eval_df`` and
    ``crown_apply_df``: ``crown_kernels.crown_eval_data``'s fields, not
    cast to f32."""
    return ckr.crown_eval_data(qp, prep, xm, um, nrxm, dtype=f64)


def crown_eval_df_ref(data, lam, extra, prep):
    """Plain PyTorch twin of the kernel (see ``crown_eval_df``): the f32
    twin's arithmetic on f64 data."""
    return ckr.crown_eval_ref(data, lam, extra, prep)


def crown_eval_df(data, lam, extra, prep):
    """Crown stage evaluation at the dual point ``lam`` [Nn, nxm] (masked by
    nrxm), in f64, with the chain-root contributions ``extra`` [Nn, nz]
    (zero off the root nodes).

    ``data`` from ``crown_eval_df_data``. Returns
    ``crown_kernels.crown_eval``'s outputs in f64: x, u, qtilde, rtilde,
    xUnc, uUnc, res [Nn, ...]; fcr [Nn] the per-node dual-value partials.
    """
    if lam.device.type == "cpu":
        return crown_eval_df_ref(data, lam, extra, prep)
    out = ckr.eval_launch("crown_eval_df", "tq_crown_eval_df", data, lam, extra,
                          prep, f64)
    crown_eval_df.launches += 1
    return out


crown_eval_df.launches = 0


def crown_apply_df_ref(data, qtilde, rtilde, d, extra, prep):
    """Plain PyTorch twin of the kernel (see ``crown_apply_df``)."""
    AB = data["ABt"]
    nx = AB.shape[1]
    d = d.to(AB.dtype)
    sum_AB = _kid_sum(_dense.mv(AB, d, trans=True), prep) + extra
    xl = qtilde * (d - sum_AB[:, :nx]) * data["xm"]
    ul = rtilde * (-sum_AB[:, nx:]) * data["um"]
    par = prep.on(d.device)["par"]
    zp = torch.cat([xl[par], ul[par]], dim=1)
    return dict(xl=xl, ul=ul, res=(_dense.mv(AB, zp) - xl) * data["nrxm"])


def crown_apply_df(data, qtilde, rtilde, d, extra, prep):
    """Crown half of the dual-Hessian action M d, in f64.

    ``data`` from ``crown_eval_df_data``; qtilde [Nn, nxm], rtilde [Nn, num]
    the masked inverses (f64, from ``crown_eval_df``); d [Nn, nxm] the f32
    direction (masked by nrxm); extra [Nn, nz] the chains' root
    contributions of their direction (``chain_apply_df``'s cqr at the root
    nodes, f64). Returns dict(xl, ul [Nn, ...] the linear stage response
    xl = qtilde (d - s_A) xm, ul = rtilde (-s_B) um with s the kid sum of
    [A B]' d plus extra; res [Nn, nxm] the linearized masked residual
    ([A B] [xl; ul]_par - xl) nrxm). M d on the crown is -res.
    """
    if d.device.type == "cpu":
        return crown_apply_df_ref(data, qtilde, rtilde, d, extra, prep)
    name = "crown_apply_df"
    Nn, nx, nz = data["ABt"].shape
    nu = nz - nx
    dev = d.device
    d = d.contiguous()
    for arg, t, shape, dt in (("qtilde", qtilde, (Nn, nx), f64),
                              ("rtilde", rtilde, (Nn, nu), f64),
                              ("d", d, (Nn, nx), torch.float32),
                              ("extra", extra, (Nn, nz), f64)):
        _build.require(name, arg, t, shape, dev, dt)
    ckr.check_data(name, data, prep, dev, f64)
    kw = dict(dtype=f64, device=dev)
    out = dict(xl=torch.empty((Nn, nx), **kw), ul=torch.empty((Nn, nu), **kw),
               res=torch.empty((Nn, nx), **kw))
    t = ckr.eval_sched(prep, dev)
    atb = torch.empty((Nn, nz), **kw)
    ptrs = _build.ptr_array(
        [data[k] for k in ckr.CROWN_DATA_KEYS]
        + [t["par"], t["kid_ptr"], t["kid_idx"], qtilde, rtilde, d, extra, atb]
        + [out[k] for k in ("xl", "ul", "res")])
    blocks, _, threads = ckr._crown_eval_launch(Nn, nx, nu)
    err = _build.lib().tq_crown_apply_df(ptrs, Nn, nx, nu, blocks, threads, _build.stream(dev))
    _build.check(err, name)
    crown_apply_df.launches += 1
    return out


crown_apply_df.launches = 0

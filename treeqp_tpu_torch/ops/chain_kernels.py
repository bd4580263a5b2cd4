"""Chain kernels of the dual Newton: factorize, solve sweeps and evaluation.

Port of ``chain_factor``, ``chain_solve_bwd``, ``chain_forward``,
``chain_blocks_factor``, ``chain_blocks_factor_lanes``, ``chain_eval`` and
``chain_eval_data`` in ``treeqp_tpu/ops/chain_kernels.py``, and of the
multi-RHS solve of self-contained chains ``chain_full_solve_mat`` (sdunes).
Each kernel wrapper launches its CUDA kernel (``csrc/chain_factor.cu``,
``csrc/chain_sweeps.cu``, ``csrc/chain_blocks_factor.cu``,
``csrc/chain_eval.cu``, ``csrc/chain_full_solve.cu``) on CUDA tensors and
runs its plain PyTorch twin (``*_ref``) on CPU tensors. All are f32, like
the Pallas kernels.

Every chain tensor is laid out ``[S, L, ...]`` (scenario first); the JAX
kernels' lane layout ``[L, ..., S_pad]`` is not carried over, so the
"lanes" variant of the factorize differs from the plain one only in where
it reads the parent's masked inverses. The factor handles ``Ls``/``CUs``
are ``[S, L, nx, nx]``; the multistage solver reads them through
``system_kernels`` and ``iter_kernel``, the generic-tree solver's split
path through ``chain_solve_bwd`` and ``chain_forward``.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _build, _dense

__all__ = ["chain_factor", "chain_factor_ref", "chain_solve_bwd",
           "chain_solve_bwd_ref", "chain_forward", "chain_forward_ref",
           "chain_full_solve_mat", "chain_full_solve_mat_ref",
           "chain_blocks_factor", "chain_blocks_factor_ref",
           "chain_blocks_factor_lanes", "chain_blocks_factor_lanes_ref", "chain_blocks",
           "lanes_ztp",
           "CHAIN_DATA_KEYS", "chain_eval_data", "chain_eval", "chain_eval_ref",
           "chain_node_launch"]

# the largest nz = nx + nu the chain block factor kernels take
MAX_BLOCK_NZ = 64

# chain_eval_data's fields, in the order the CUDA kernels read them
CHAIN_DATA_KEYS = ("ABt", "q", "r", "Qd", "Rd", "Qinv", "Rinv", "xmin", "xmax",
                   "umin", "umax", "b")


def chain_factor_ref(Wc, Utc):
    """Plain PyTorch twin of the kernel (see ``chain_factor``)."""
    S, L, nx, _ = Wc.shape
    Ls = torch.empty((S, L, nx, nx), dtype=Wc.dtype, device=Wc.device)
    CUs = torch.empty_like(Ls)
    schur = torch.zeros((S, nx, nx), dtype=Wc.dtype, device=Wc.device)
    for j in range(L - 1, -1, -1):
        Lf = _dense.chol(Wc[:, j] - schur)
        CU = _dense.rtrsm_t(Lf, Utc[:, j])
        Ls[:, j], CUs[:, j] = Lf, CU
        schur = _dense.outer_sum(CU, CU)
    return Ls, CUs, schur


def _chain_shape_check(name, S, L, n):
    if not (0 < n <= 16 and S > 0 and L > 0):
        raise ValueError(f"{name}: unsupported shape S={S} L={L} n={n}")


def chain_factor(Wc, Utc):
    """Banded backward block Cholesky of given chain blocks, per chain:
    for j = L-1 .. 0, Ls_j = chol(Wc_j - CUs_{j+1} CUs_{j+1}') (pivot rule
    a_kk rsqrt(max(a_kk, 1e-8)), no shift: the caller adds any LM shift to
    Wc) and CUs_j = Utc_j Ls_j^-T.

    Wc [S, L, n, n] the equilibrated chain blocks, j = 0 the node next to
    the crown; Utc [S, L, n, n] their couplings to node j-1 (the crown
    parent at j = 0). Both f32. Returns (Ls, CUs [S, L, n, n], schur0
    [S, n, n] = CUs_0 CUs_0', the Schur block flowing into the crown).
    """
    if Wc.device.type == "cpu":
        return chain_factor_ref(Wc, Utc)
    name = "chain_factor"
    S, L, n, _ = Wc.shape
    dev = Wc.device
    for arg, t in (("Wc", Wc), ("Utc", Utc)):
        _build.require(name, arg, t, (S, L, n, n), dev)
    _chain_shape_check(name, S, L, n)
    f32 = dict(dtype=torch.float32, device=dev)
    Ls = torch.empty((S, L, n, n), **f32)
    CUs = torch.empty((S, L, n, n), **f32)
    schur0 = torch.empty((S, n, n), **f32)
    err = _build.lib().tq_chain_factor(
        Wc.data_ptr(), Utc.data_ptr(), Ls.data_ptr(), CUs.data_ptr(),
        schur0.data_ptr(), S, L, n, _build.stream(dev))
    _build.check(err, name)
    chain_factor.launches += 1
    return Ls, CUs, schur0


chain_factor.launches = 0


def chain_solve_bwd_ref(Ls, CUs, res):
    """Plain PyTorch twin of the kernel (see ``chain_solve_bwd``)."""
    S, L, n, _ = Ls.shape
    ys = torch.empty_like(res)
    radd = torch.zeros((S, n), dtype=Ls.dtype, device=Ls.device)
    for j in range(L - 1, -1, -1):
        y = _dense.ltrsv(Ls[:, j], res[:, j] - radd)
        ys[:, j] = y
        radd = _dense.mv(CUs[:, j], y)
    return ys, radd


def chain_solve_bwd(Ls, CUs, res):
    """Right-hand-side backward sweep with ``chain_factor``'s factors:
    ys_j = Ls_j^-1 (res_j - CUs_{j+1} ys_{j+1}) for j = L-1 .. 0.

    Ls, CUs [S, L, n, n]; res [S, L, n]. All f32. Returns (ys [S, L, n] —
    feed it to ``chain_forward`` — and radd0 [S, n] = CUs_0 ys_0, the
    update of each chain's crown-parent right-hand side)."""
    if Ls.device.type == "cpu":
        return chain_solve_bwd_ref(Ls, CUs, res)
    name = "chain_solve_bwd"
    S, L, n, _ = Ls.shape
    dev = Ls.device
    for arg, t, shape in (("Ls", Ls, (S, L, n, n)), ("CUs", CUs, (S, L, n, n)),
                          ("res", res, (S, L, n))):
        _build.require(name, arg, t, shape, dev)
    _chain_shape_check(name, S, L, n)
    ys = torch.empty((S, L, n), dtype=torch.float32, device=dev)
    radd0 = torch.empty((S, n), dtype=torch.float32, device=dev)
    err = _build.lib().tq_chain_solve_bwd(
        Ls.data_ptr(), CUs.data_ptr(), res.data_ptr(), ys.data_ptr(),
        radd0.data_ptr(), S, L, n, _build.stream(dev))
    _build.check(err, name)
    chain_solve_bwd.launches += 1
    return ys, radd0


chain_solve_bwd.launches = 0


def chain_forward_ref(Ls, CUs, ys, droot):
    """Plain PyTorch twin of the kernel (see ``chain_forward``)."""
    L = Ls.shape[1]
    dls = torch.empty_like(ys)
    dp = droot
    for j in range(L):
        dp = _dense.uttrsv(Ls[:, j], ys[:, j] - _dense.mv(CUs[:, j], dp, trans=True))
        dls[:, j] = dp
    return dls


def chain_forward(Ls, CUs, ys, droot):
    """Forward substitution down each chain with ``chain_factor``'s
    factors: dl_j = Ls_j^-T (ys_j - CUs_j' dl_{j-1}) for j = 0 .. L-1, from
    dl_{-1} = droot, the crown's direction at the edge into the chain.

    Ls, CUs [S, L, n, n]; ys [S, L, n] (``chain_solve_bwd``'s); droot
    [S, n]. All f32. Returns dls [S, L, n]."""
    if Ls.device.type == "cpu":
        return chain_forward_ref(Ls, CUs, ys, droot)
    name = "chain_forward"
    S, L, n, _ = Ls.shape
    dev = Ls.device
    for arg, t, shape in (("Ls", Ls, (S, L, n, n)), ("CUs", CUs, (S, L, n, n)),
                          ("ys", ys, (S, L, n)), ("droot", droot, (S, n))):
        _build.require(name, arg, t, shape, dev)
    _chain_shape_check(name, S, L, n)
    dls = torch.empty((S, L, n), dtype=torch.float32, device=dev)
    err = _build.lib().tq_chain_forward(
        Ls.data_ptr(), CUs.data_ptr(), ys.data_ptr(), droot.data_ptr(),
        dls.data_ptr(), S, L, n, _build.stream(dev))
    _build.check(err, name)
    chain_forward.launches += 1
    return dls


chain_forward.launches = 0


def chain_full_solve_mat_ref(Ls, CUs, rhs):
    """Plain PyTorch twin of the kernel (see ``chain_full_solve_mat``)."""
    L = Ls.shape[1]
    z = torch.empty_like(rhs)
    acc = torch.zeros_like(rhs[:, 0])
    for j in range(L - 1, -1, -1):
        y = _dense.ltrsv_mat(Ls[:, j], rhs[:, j] - acc)
        z[:, j] = y
        acc = _dense.mm(CUs[:, j], y)
    zp = torch.zeros_like(rhs[:, 0])
    for j in range(L):
        zp = _dense.uttrsv_mat(Ls[:, j], z[:, j] - _dense.mm(CUs[:, j], zp, trans_a=True))
        z[:, j] = zp
    return z


def chain_full_solve_mat(Ls, CUs, rhs):
    """Full solve of self-contained chains for m right-hand sides at once,
    with ``chain_factor``'s factors of chains whose node 0 has no parent
    coupling (CUs_0 = 0): the backward sweep y_j = Ls_j^-1 (r_j - CUs_{j+1}
    y_{j+1}) for j = L-1 .. 0, then the forward sweep z_j = Ls_j^-T (y_j -
    CUs_j' z_{j-1}) for j = 0 .. L-1, in one launch.

    Ls, CUs [S, L, n, n]; rhs [S, L, n, m], any m. All f32. Returns z
    [S, L, n, m]."""
    if Ls.device.type == "cpu":
        return chain_full_solve_mat_ref(Ls, CUs, rhs)
    name = "chain_full_solve_mat"
    S, L, n, _ = Ls.shape
    m = rhs.shape[-1]
    dev = Ls.device
    for arg, t, shape in (("Ls", Ls, (S, L, n, n)), ("CUs", CUs, (S, L, n, n)),
                          ("rhs", rhs, (S, L, n, m))):
        _build.require(name, arg, t, shape, dev)
    _chain_shape_check(name, S, L, n)
    if m < 1:
        raise ValueError(f"{name}: no right-hand side (m={m})")
    z = torch.empty((S, L, n, m), dtype=torch.float32, device=dev)
    err = _build.lib().tq_chain_full_solve_mat(
        Ls.data_ptr(), CUs.data_ptr(), rhs.data_ptr(), z.data_ptr(), S, L, n, m,
        _build.stream(dev))
    _build.check(err, name)
    chain_full_solve_mat.launches += 1
    return z


chain_full_solve_mat.launches = 0


def chain_blocks(ABt, ztp, qtc, s_root):
    """The equilibrated blocks that ``chain_blocks_factor`` factors: (W
    [S, L, nx, nx], Ut [S, L, nx, nx], sc [S, L, nx])."""
    nx = ABt.shape[2]
    W = _dense.outer_sum(ABt, ABt, ztp) + torch.diag_embed(qtc)
    sc = torch.rsqrt(torch.clamp(torch.diagonal(W, dim1=2, dim2=3), min=1e-12))
    W = W * sc[..., :, None] * sc[..., None, :]
    # Ut[i, c] = -ztp[i] A[c, i], rows in the parent's scale, cols in sc
    Ut = -(ztp[..., :nx, None] * ABt[..., :nx].transpose(2, 3))
    scp = torch.cat([s_root[:, None], sc[:, :-1]], dim=1)
    return W, Ut * scp[..., :, None] * sc[..., None, :], sc


def chain_blocks_factor_ref(ABt, ztp, qtc, s_root):
    """Plain PyTorch twin of the kernel (see ``chain_blocks_factor``)."""
    W, Ut, sc = chain_blocks(ABt, ztp, qtc, s_root)
    Ls, CUs, schur = chain_factor_ref(W, Ut)
    return Ls, CUs, schur, sc.contiguous()


def _factor_outputs(name, ABt):
    """The factor kernels' outputs (Ls, CUs, schur0, sc), after the shape
    check they share (nx <= 16, nx <= nz <= 64: the kernels' ring)."""
    S, L, nx, nz = ABt.shape
    if not (0 < nx <= 16 and nx <= nz <= MAX_BLOCK_NZ and S > 0 and L > 0):
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


def lanes_ztp(qt, rt, ztp_root):
    """The stage weights ``chain_blocks_factor`` takes, from the lanes
    form's operands: node j's ztp is node j-1's [qt | rt], ztp_root at j = 0."""
    ztp_ch = torch.cat([qt, rt], dim=-1)
    return torch.cat([ztp_root[:, None], ztp_ch[:, :-1]], dim=1)


def chain_blocks_factor_lanes_ref(ABt, qt, rt, ztp_root, s_root):
    """Plain PyTorch twin of the kernel (see ``chain_blocks_factor_lanes``)."""
    return chain_blocks_factor_ref(ABt, lanes_ztp(qt, rt, ztp_root), qt, s_root)


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


# the chain evaluation kernels' and chain_apply_df's launch (tq_eval.cuh's
# chain_eval_nodes, csrc/chain_apply_df.cu): a thread a chain node, whole
# chains a block, at most _NODE_THREADS threads a block (tq::kNodeThreads;
# a longer chain's block strides over its nodes), the block's [A B] and lam
# / d rows staged in shared memory where they fit in _BLOCK_SMEM (the H100's
# 227 KB a block). _NODE_CHAINS: the chains a block, the fastest of 1, 2,
# 4, 8 on the H100 in either element size (f64: at the bench path's S =
# 256, L = 16, tying 8 at S = 1024; f32: at S = 256, L = 16 with nx = 6,
# nu = 4 and nx = 8, nu = 1, and at S = 1024, L = 15)
_NODE_CHAINS = 1
_NODE_THREADS = 128
_BLOCK_SMEM = 232448


def _tile_bytes(count, elem):
    """tq::tile_bytes: a staged tile of count elements of elem bytes."""
    return -(-count * elem // 16) * 16 + 16


def _node_smem(chains, L, nx, nu, elem, apply, staged):
    """The dynamic shared memory of one block, as the C launchers size it:
    the evaluation's per-node partials (two of elem bytes a node, rounded
    up to 16 bytes), then, staged, the [A B] tile and the lam (elem) or d
    (f32) tile."""
    nodes = chains * L
    out = 0 if apply else _tile_bytes(2 * nodes, elem) - 16
    if staged:
        out += (_tile_bytes(nodes * nx * (nx + nu), elem)
                + _tile_bytes(nodes * nx, 4 if apply else elem))
    return out


def chain_node_launch(S, L, nx, nu, elem, apply=False, chains=None, staged=None):
    """The launch of ``chain_eval`` (``elem`` 4) and ``chain_eval_df`` (8),
    with ``apply`` of ``chain_apply_df`` (8), on S chains of L nodes:
    (chains a block, blocks, threads a block, staged, shared bytes a
    block). ``chains`` (default _NODE_CHAINS) is cut to as many
    whole chains as _NODE_THREADS threads take, at least one (the last
    block may hold fewer); ``staged`` (default: where the tiles fit
    _BLOCK_SMEM) stages the block's [A B] and lam / d rows in shared
    memory."""
    C = max(1, min(chains or _NODE_CHAINS, _NODE_THREADS // L))
    if staged is None:
        staged = _node_smem(C, L, nx, nu, elem, apply, True) <= _BLOCK_SMEM
    return (C, -(-S // C), min(C * L, _NODE_THREADS), staged,
            _node_smem(C, L, nx, nu, elem, apply, staged))


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
    S, L, nx, nz = data["ABt"].shape
    C, _, _, staged, _ = chain_node_launch(S, L, nx, nz - nx, 4)
    out = eval_launch("chain_eval", "tq_chain_eval", data, lam, torch.float32,
                      (C, int(staged)))
    chain_eval.launches += 1
    return out


chain_eval.launches = 0


def eval_launch(name, entry, data, lam, dtype, launch):
    """Check the operands of a chain evaluation kernel of ``dtype`` (f32
    ``chain_eval`` or f64 ``chain_eval_df``) and launch it with the ints
    ``launch`` (chains a block, staged; ``chain_node_launch``); returns its
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
    err = getattr(_build.lib(), entry)(ptrs, S, L, nx, nu, *launch, _build.stream(dev))
    _build.check(err, name)
    return out


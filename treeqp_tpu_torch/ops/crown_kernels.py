"""Crown (generic-tree) kernels of the dual Newton: factorize, solve and
evaluation.

Port of ``_get_sched``, ``crown_factor``, ``crown_solve``,
``crown_blocks_factor``, ``crown_eval_data`` and ``crown_eval`` in
``treeqp_tpu/ops/crown_kernels.py``. Each kernel wrapper launches its CUDA
kernel (``csrc/crown_factor.cu``, ``csrc/crown_solve.cu``,
``csrc/crown_blocks_factor.cu``, ``csrc/crown_eval.cu``) on CUDA tensors
and runs its plain PyTorch twin (``*_ref``) on CPU tensors; all are f32,
like the Pallas kernels. The level schedule is a list of (child group,
parent group, slot) triples per level instead of the TPU kernel's one-hot
lane-permutation matrices, and the evaluation's kid sum and parent gather
read the kid lists and parents (``eval_sched``) instead of a one-hot
[NPc, NPc] parent matrix, so the crown has no node cap; the evaluation runs
a lane group a crown node on one cluster (``_crown_eval_launch``). A
schedule may cover only the shallow levels of a tree (the crown of the
generic solver's split path); its kernels then take the crown's groups
only, the group prefix those levels and the root form.

Factors are group-major: CholW [NpG, G, G], CholUt [NpG, nxm, G] (the JAX
kernel's are lane-major [G, G, NPg]); evaluation data and results are
node-major [Nn, ...] (the JAX kernel's are [rows, NPc]).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.ops import _build, _dense
from treeqp_tpu_torch.solvers.tdunes import _kid_sum

__all__ = ["crown_supported", "crown_factor", "crown_factor_ref", "crown_solve",
           "crown_solve_ref", "crown_blocks_factor", "crown_blocks_factor_ref",
           "eval_sched", "CROWN_DATA_KEYS", "crown_eval_data", "crown_eval",
           "crown_eval_ref"]

# crown_eval_data's fields, in the order the CUDA kernels read them
CROWN_DATA_KEYS = ("ABt", "q", "r", "b", "Qd", "Rd", "Qinv", "Rinv", "xmin",
                   "xmax", "umin", "umax", "xm", "um", "nrxm")

_MAX_G = 64  # block dim bound, as in the JAX crown_supported


@dataclasses.dataclass(frozen=True)
class _CrownSched:
    """Backward level schedule of the crown block Cholesky (deepest parent
    stage first; the root group 0 comes after the last level)."""

    n_lev: int
    K: int
    G: int
    nxm: int
    NpG: int
    lev_ptr: np.ndarray     # [n_lev + 1] offsets into the lev_* arrays
    lev_child: np.ndarray   # group factorized at this entry
    lev_parent: np.ndarray  # its parent group
    lev_slot: np.ndarray    # its slot in the parent group
    width: int              # most groups on one level
    _tensors: dict = dataclasses.field(default_factory=dict, compare=False)

    def on(self, device) -> dict:
        """The int32 schedule arrays on ``device`` (cached)."""
        device = torch.device(device)
        hit = self._tensors.get(device)
        if hit is None:
            hit = {k: torch.as_tensor(getattr(self, k), dtype=torch.int32,
                                      device=device)
                   for k in ("lev_ptr", "lev_child", "lev_parent",
                             "lev_slot")}
            self._tensors[device] = hit
        return hit


def _get_sched(prep, levels=None) -> _CrownSched:
    """Build / fetch the schedule from a tdunes ``_Prep``: of all its
    levels (``prep.levels``), or of ``levels``, a deepest-first list of
    group-id arrays (the crown levels of the split path). The levels and
    the root group 0 must list each group of a prefix 0..NpG-1 of the
    prep's groups once; that prefix is what the kernels take. Cached on the
    prep."""
    cache = prep.__dict__.setdefault("_crown_scheds", {})
    key = None if levels is None else tuple(tuple(int(g) for g in lv) for lv in levels)
    sched = cache.get(key)
    if sched is not None:
        return sched
    assert prep.NpG == 0 or prep.gdad[0] == -1, "group 0 must be the root group"
    levels = prep.levels if levels is None else [np.asarray(lv) for lv in levels]
    child = np.concatenate([np.zeros(0, np.int64)] + [np.asarray(lv) for lv in levels])
    NpG = len(child) + 1 if prep.NpG else 0
    if prep.NpG and not np.array_equal(np.sort(child), np.arange(1, NpG)):
        raise ValueError("crown schedule: the levels must list each of the groups "
                         f"1..{NpG - 1} once")
    i32 = lambda v: np.asarray(v, np.int32)
    sched = _CrownSched(
        n_lev=len(levels), K=prep.K, G=prep.G, nxm=prep.nxm, NpG=NpG,
        lev_ptr=i32(np.cumsum([0] + [len(lv) for lv in levels])),
        lev_child=i32(child), lev_parent=i32(prep.gdad[child]),
        lev_slot=i32(prep.gslot[child]),
        width=max([len(v) for v in levels] + [1]))
    cache[key] = sched
    return sched


def _level_index(sched, device):
    """Per level, the (child, parent, slot) long tensors on ``device``."""
    out = []
    for r in range(sched.n_lev):
        sl = slice(int(sched.lev_ptr[r]), int(sched.lev_ptr[r + 1]))
        out.append(tuple(torch.as_tensor(a[sl], dtype=torch.long, device=device)
                         for a in (sched.lev_child, sched.lev_parent, sched.lev_slot)))
    return out


# the crown factor kernels' launch (csrc/tq_crown.cuh): one cluster of
# _CLUSTER blocks, a warp a group; a lane holds R = ceil((G + nxm) / 32)
# rows of the group's block and couplings, and a block takes at most 16
# warps (R = 1) or 8
_CLUSTER = 8
_MAX_WARPS = {1: 16, 2: 8, 3: 8}
_BLOCK_SMEM = 227 * 1024  # the shared memory a block can have on Hopper


def _factor_launch(sched, nz=0) -> tuple[int, int]:
    """(warps a block, shared-memory floats a warp) of ``crown_factor``
    and, with the blocks' ``nz``, ``crown_blocks_factor``: a warp's
    floats hold the group's factors with rows of G + 1 floats (and the
    block build's [A B]', its products, ztp and sW), rounded up to 4; the
    warps cover the groups in one round where a block's threads and shared
    memory (less the level schedule's ints) allow."""
    G, n = sched.G, sched.nxm
    floats = max((G + n) * (G + 1), 2 * nz * G + nz + G)
    floats = -(-floats // 4) * 4
    sched_bytes = 4 * (sched.n_lev + 1 + 3 * (sched.NpG - 1))
    warps = min(_MAX_WARPS[-(-(G + n) // 32)], (_BLOCK_SMEM - sched_bytes) // (4 * floats),
                -(-sched.NpG // _CLUSTER))
    return max(1, warps), floats


# the crown solve's launch (csrc/crown_solve.cu): blocks of at most
# _SOLVE_WARPS warps, on one cluster of _CLUSTER blocks or in one block;
# a warp a group for G <= 32, a thread a group in one block beyond
_SOLVE_WARPS = 16
_SOLVE_ONE_BLOCK = 16  # the widest level one block takes, a warp a group


def _solve_launch(sched) -> tuple[int, int]:
    """(blocks, warps a block) of ``crown_solve``: the warps cover the
    widest level in one round where a block's threads allow. Levels of at
    most _SOLVE_ONE_BLOCK groups take one block, whose barrier costs less
    than the cluster's; wider ones a cluster, their warps interleaved over
    its blocks. G > 32 takes the per-thread form: one block, a thread a
    group."""
    if sched.G > 32:
        return 1, min(_SOLVE_WARPS, -(-sched.width // 32))
    if sched.width <= _SOLVE_ONE_BLOCK:
        return 1, sched.width
    return _CLUSTER, min(_SOLVE_WARPS, -(-sched.width // _CLUSTER))


# the lane-group crown kernels' launch (crown_eval, crown_eval_df,
# crown_apply_df: tq_eval.cuh's crown_eval_lanes, crown_apply_lanes): a
# group of tq::lanes(nz) lanes a node, at most _EVAL_THREADS threads a
# block, on one cluster of _EVAL_CLUSTER blocks
_EVAL_THREADS = 1024
_EVAL_CLUSTER = 16


def _crown_eval_launch(Nn, nx, nu, blocks=_EVAL_CLUSTER):
    """(blocks, groups a block, threads a block) of the lane-group crown
    kernels on a crown of Nn nodes: ``blocks`` is the team, one cluster or
    one block; a block takes the groups that cover the crown in one round
    where _EVAL_THREADS allow (group g of the team takes nodes g, g +
    groups * blocks, ...)."""
    G = 8 if nx + nu <= 8 else 16  # tq::lanes(nz)
    per_block = -(-Nn // blocks)  # the groups a block takes in one round
    threads = min(_EVAL_THREADS, -(-per_block * G // 32) * 32)
    return blocks, threads // G, threads


def crown_supported(prep, opts) -> bool:
    """The fused crown path applies: moderate block dim, f32 factors, a
    static regularization (the kernel's LM shift)."""
    return (prep.G <= _MAX_G and prep.nxm <= 16
            and opts.factor_dtype == "float32"
            and opts.reg_type in ("always", "none"))


def _crown_blocks(ABk, ztp, dvals, sW, sUt, Wadd):
    """Scaled crown blocks W [NpG, G, G] and Ut [NpG, nxm, G]."""
    NpG, K, nxm, nz = ABk.shape
    G = K * nxm
    AB = ABk.reshape(NpG, G, nz)
    W = _dense.outer_sum(AB, AB, ztp) + torch.diag_embed(dvals)
    W = W * sW[:, :, None] * sW[:, None, :] + Wadd
    # Ut[i, k*nxm + c] = -ztp[i] A_k[c, i]  (x rows only)
    Ut = -(ztp[:, :nxm, None] * AB[:, :, :nxm].transpose(1, 2))
    Ut = Ut * sUt[:, :, None] * sW[:, None, :]
    return W.contiguous(), Ut.contiguous()


def crown_factor_ref(W, Ut, prep, reg=0.0, levels=None):
    """Plain PyTorch twin of the kernel (see ``crown_factor``)."""
    sched = _get_sched(prep, levels)
    K, nxm = sched.K, sched.nxm
    # every group but the root is factorized on its level, after its kids
    # have updated its block: the factors overwrite the blocks in place
    CholW, CholUt = W.clone(), torch.zeros_like(Ut)
    Wv = CholW.view(W.shape[0], K, nxm, K, nxm)
    for g, d, s in _level_index(sched, W.device):
        Lf = _dense.chol(CholW[g], reg=reg, clamp_diag=True)
        CU = _dense.rtrsm_t(Lf, Ut[g])
        CholW[g], CholUt[g] = Lf, CU
        # one child per (parent, slot): a plain indexed update
        Wv[d, s, :, s, :] -= _dense.outer_sum(CU, CU)
    CholW[0] = _dense.chol(CholW[0], reg=reg, clamp_diag=True)
    return CholW, CholUt


def _crown_check(name, sched, nxm):
    if not (0 < sched.NpG and 0 < nxm <= 16 and sched.G <= _MAX_G):
        raise ValueError(f"{name}: unsupported shape NpG={sched.NpG} G={sched.G} "
                         f"nxm={nxm}")


def crown_factor(W, Ut, prep, reg=0.0, levels=None):
    """Level-synchronous tree block Cholesky of given equilibrated blocks,
    deepest level first: CholW_g = chol(W_g + reg I) (pivot floor 1e-8,
    clamped diagonal), CholUt_g = Ut_g CholW_g^-T, and the Schur block
    CholUt_g CholUt_g' subtracted from the parent's slot diagonal block;
    then the root group.

    W [NpG, G, G], Ut [NpG, nxm, G], f32. ``levels`` (default: every level
    of ``prep``) is a deepest-first list of group-id arrays; with the root
    they list the NpG groups of W (``_get_sched``). Returns CholW
    [NpG, G, G], CholUt [NpG, nxm, G] for ``crown_solve``.
    """
    if W.device.type == "cpu":
        return crown_factor_ref(W, Ut, prep, reg, levels)
    name = "crown_factor"
    sched = _get_sched(prep, levels)
    NpG, K, nxm, G = sched.NpG, sched.K, sched.nxm, sched.G
    dev = W.device
    _build.require(name, "W", W, (NpG, G, G), dev)
    _build.require(name, "Ut", Ut, (NpG, nxm, G), dev)
    _crown_check(name, sched, nxm)
    CholW = torch.empty((NpG, G, G), dtype=torch.float32, device=dev)
    CholUt = torch.empty((NpG, nxm, G), dtype=torch.float32, device=dev)
    t = sched.on(dev)
    err = _build.lib().tq_crown_factor(
        W.data_ptr(), Ut.data_ptr(), t["lev_ptr"].data_ptr(),
        t["lev_child"].data_ptr(), t["lev_parent"].data_ptr(),
        t["lev_slot"].data_ptr(), CholW.data_ptr(), CholUt.data_ptr(), NpG, K, nxm,
        sched.n_lev, float(reg), *_factor_launch(sched), _build.stream(dev))
    _build.check(err, name)
    crown_factor.launches += 1
    return CholW, CholUt


crown_factor.launches = 0


def crown_solve_ref(CholW, CholUt, rg, prep, levels=None):
    """Plain PyTorch twin of the kernel (see ``crown_solve``)."""
    sched = _get_sched(prep, levels)
    NpG, K, n = sched.NpG, sched.K, sched.nxm
    idx = _level_index(sched, CholW.device)
    rv = rg.clone()
    rvv = rv.view(NpG, K, n)
    ycr = torch.zeros_like(rv)
    for g, d, s in idx:
        y = _dense.ltrsv(CholW[g], rv[g])
        ycr[g] = y
        rvv[d, s] -= _dense.mv(CholUt[g], y)
    dg = torch.zeros_like(rv)
    dg[0] = _dense.uttrsv(CholW[0], _dense.ltrsv(CholW[0], rv[0]))
    for g, d, s in reversed(idx):
        dp = dg.view(NpG, K, n)[d, s]
        dg[g] = _dense.uttrsv(CholW[g], ycr[g] - _dense.mv(CholUt[g], dp, trans=True))
    return dg


def crown_solve(CholW, CholUt, rg, prep, levels=None):
    """Solve M dlam = rg with ``crown_factor``'s factors (the same
    ``levels``): backward right-hand-side sweep, root solve, forward
    substitution.

    CholW [NpG, G, G], CholUt [NpG, nxm, G], rg [NpG, G], f32. Returns
    dlam [NpG, G]."""
    if CholW.device.type == "cpu":
        return crown_solve_ref(CholW, CholUt, rg, prep, levels)
    name = "crown_solve"
    sched = _get_sched(prep, levels)
    NpG, K, nxm, G = sched.NpG, sched.K, sched.nxm, sched.G
    dev = CholW.device
    for arg, t, shape in (("CholW", CholW, (NpG, G, G)),
                          ("CholUt", CholUt, (NpG, nxm, G)), ("rg", rg, (NpG, G))):
        _build.require(name, arg, t, shape, dev)
    _crown_check(name, sched, nxm)
    f32 = dict(dtype=torch.float32, device=dev)
    rv, ycr, dg = (torch.empty((NpG, G), **f32) for _ in range(3))
    t = sched.on(dev)
    err = _build.lib().tq_crown_solve(
        CholW.data_ptr(), CholUt.data_ptr(), rg.data_ptr(),
        t["lev_ptr"].data_ptr(), t["lev_child"].data_ptr(),
        t["lev_parent"].data_ptr(), t["lev_slot"].data_ptr(), rv.data_ptr(),
        ycr.data_ptr(), dg.data_ptr(), NpG, K, nxm, sched.n_lev, *_solve_launch(sched),
        _build.stream(dev))
    _build.check(err, name)
    crown_solve.launches += 1
    return dg


crown_solve.launches = 0


def crown_blocks_factor_ref(ABk, ztp, dvals, sW, sUt, Wadd, prep, reg=0.0):
    """Plain PyTorch twin of the kernel (see ``crown_blocks_factor``)."""
    W, Ut = _crown_blocks(ABk, ztp, dvals, sW, sUt, Wadd)
    return crown_factor_ref(W, Ut, prep, reg)


def crown_blocks_factor(ABk, ztp, dvals, sW, sUt, Wadd, prep, reg=0.0):
    """Crown block build (sibling cross terms A_i qtp A_j' + the kids' own
    qtilde, dual_Newton_tree_clipping.c:264-355) + Jacobi scaling + the
    additive chain-Schur term + the level-synchronous block Cholesky with a
    static LM shift ``reg``.

    ABk [NpG, K, nxm, nz] kids' masked [A B]; ztp [NpG, nz] the parent
    node's masked inverses; dvals [NpG, G] kids' own qtilde diagonals (1 on
    empty slots); sW [NpG, G] Jacobi scales; sUt [NpG, nxm] the dad-row
    scales; Wadd [NpG, G, G] pre-scaled additive term (the negated chain
    Schur complements). All f32. Returns CholW [NpG, G, G], CholUt
    [NpG, nxm, G].
    """
    if ABk.device.type == "cpu":
        return crown_blocks_factor_ref(ABk, ztp, dvals, sW, sUt, Wadd, prep, reg)
    name = "crown_blocks_factor"
    sched = _get_sched(prep)
    NpG, K, nxm, G = sched.NpG, sched.K, sched.nxm, sched.G
    nz = ABk.shape[-1]
    dev = ABk.device
    for arg, t, shape in (("ABk", ABk, (NpG, K, nxm, nz)), ("ztp", ztp, (NpG, nz)),
                          ("dvals", dvals, (NpG, G)), ("sW", sW, (NpG, G)),
                          ("sUt", sUt, (NpG, nxm)), ("Wadd", Wadd, (NpG, G, G))):
        _build.require(name, arg, t, shape, dev)
    if not (0 < NpG and 0 < nxm <= 16 and G <= _MAX_G and nxm <= nz):
        raise ValueError(f"{name}: unsupported shape {tuple(ABk.shape)}")
    f32 = dict(dtype=torch.float32, device=dev)
    CholW = torch.empty((NpG, G, G), **f32)
    CholUt = torch.empty((NpG, nxm, G), **f32)
    t = sched.on(dev)
    err = _build.lib().tq_crown_blocks_factor(
        ABk.data_ptr(), ztp.data_ptr(), dvals.data_ptr(), sW.data_ptr(),
        sUt.data_ptr(), Wadd.data_ptr(), t["lev_ptr"].data_ptr(),
        t["lev_child"].data_ptr(), t["lev_parent"].data_ptr(),
        t["lev_slot"].data_ptr(), CholW.data_ptr(), CholUt.data_ptr(), NpG, K,
        nxm, nz, sched.n_lev, float(reg), *_factor_launch(sched, nz), _build.stream(dev))
    _build.check(err, name)
    crown_blocks_factor.launches += 1
    return CholW, CholUt


crown_blocks_factor.launches = 0


def eval_sched(prep, device) -> dict:
    """The crown's tree as int32 index tensors on ``device`` (cached on the
    prep): par [Nn] (par[0] = 0, masked by nrxm); the kids of each node in
    slot order, kid_idx[kid_ptr[n]:kid_ptr[n+1]] (the order of the kid sum
    of ``tdunes._kid_sum``); kidsP [NpG, K] with -1 on empty slots; and
    each node's group and slot (group_of_node, slot_of_node)."""
    cache = prep.__dict__.setdefault("_eval_sched", {})
    device = torch.device(device)
    hit = cache.get(device)
    if hit is None:
        kids = [[] for _ in range(len(prep.par))]
        for g, p in enumerate(prep.gnodes):
            kids[p] = [int(c) for c, v in zip(prep.kidsP[g], prep.kvalid[g]) if v]
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int64), dtype=torch.int32,
                                        device=device)
        hit = dict(par=i32(prep.par),
                   kid_ptr=i32(np.cumsum([0] + [len(k) for k in kids])),
                   kid_idx=i32([c for k in kids for c in k]),
                   kidsP=i32(np.where(prep.kvalid > 0, prep.kidsP, -1)),
                   group_of_node=i32(prep.group_of_node),
                   slot_of_node=i32(prep.slot_of_node))
        cache[device] = hit
    return hit


def crown_eval_data(qp, prep, xm, um, nrxm, dtype=torch.float32):
    """Loop-invariant operands of ``crown_eval`` (and of the crown half of
    ``iter_kernel.newton_iter``; with ``dtype=torch.float64``, of
    ``df_eval_kernels.crown_eval_df``), node-major, from the crown
    TreeQPIn and its (x, u, nonroot-x) masks. Padding rows get identity
    weights."""
    c = lambda v: v.to(dtype).contiguous()
    xmf, umf = xm.to(dtype), um.to(dtype)
    Qd = torch.diagonal(qp.Q, dim1=1, dim2=2).to(dtype) * xmf + (1.0 - xmf)
    Rd = torch.diagonal(qp.R, dim1=1, dim2=2).to(dtype) * umf + (1.0 - umf)
    return dict(ABt=c(torch.cat([qp.A, qp.B], dim=2)), q=c(qp.q), r=c(qp.r),
                b=c(qp.b), Qd=c(Qd), Rd=c(Rd), Qinv=c(1.0 / Qd), Rinv=c(1.0 / Rd),
                xmin=c(qp.xmin), xmax=c(qp.xmax), umin=c(qp.umin),
                umax=c(qp.umax), xm=c(xm), um=c(um), nrxm=c(nrxm))


def crown_data_shapes(Nn, nx, nu) -> dict:
    """The shape of each ``crown_eval_data`` field."""
    wide = dict(ABt=(nx, nx + nu), r=(nu,), Rd=(nu,), Rinv=(nu,), umin=(nu,),
                umax=(nu,), um=(nu,))
    return {k: (Nn, *wide.get(k, (nx,))) for k in CROWN_DATA_KEYS}


def crown_eval_ref(data, lam, extra, prep):
    """Plain PyTorch twin of the kernel (see ``crown_eval``)."""
    AB = data["ABt"]
    nx = AB.shape[1]
    lam = lam.to(AB.dtype)
    sum_AB = _kid_sum(_dense.mv(AB, lam, trans=True), prep) + extra
    qmod = (-data["q"] + lam - sum_AB[:, :nx]) * data["xm"]
    rmod = (-data["r"] - sum_AB[:, nx:]) * data["um"]
    xU = data["Qinv"] * qmod
    uU = data["Rinv"] * rmod
    x = torch.minimum(torch.maximum(xU, data["xmin"]), data["xmax"]) * data["xm"]
    u = torch.minimum(torch.maximum(uU, data["umin"]), data["umax"]) * data["um"]
    qt = torch.where((xU > data["xmax"]) | (xU < data["xmin"]), 0.0, data["Qinv"])
    rt = torch.where((uU > data["umax"]) | (uU < data["umin"]), 0.0, data["Rinv"])
    par = prep.on(lam.device)["par"]
    zp = torch.cat([x[par], u[par]], dim=1)
    res = (_dense.mv(AB, zp) + data["b"] - x) * data["nrxm"]
    tx = x * (qmod - 0.5 * data["Qd"] * x) - data["b"] * lam * data["nrxm"]
    tu = u * (rmod - 0.5 * data["Rd"] * u)
    return dict(x=x, u=u, qtilde=qt, rtilde=rt, xUnc=xU, uUnc=uU, res=res,
                fcr=_dense.sum_last(tx) + _dense.sum_last(tu))


def crown_eval(data, lam, extra, prep):
    """Crown stage evaluation at the dual point ``lam`` [Nn, nxm] (masked
    by nrxm): modified gradients with the chain-root contributions
    ``extra`` [Nn, nz] added at their root nodes (zero elsewhere), the
    clipping stage solve, the active-set masked inverses, the dual residual
    and the dual-value partials.

    ``data`` from ``crown_eval_data``; ``lam`` and ``extra`` are cast to
    f32. Returns dict(x, u, qtilde, rtilde, xUnc, uUnc, res [Nn, ...]; fcr
    [Nn] the per-node dual-value partial sums). All f32.
    """
    if lam.device.type == "cpu":
        return crown_eval_ref(data, lam, extra, prep)
    out = eval_launch("crown_eval", "tq_crown_eval", data, lam, extra, prep,
                      torch.float32)
    crown_eval.launches += 1
    return out


crown_eval.launches = 0


def eval_launch(name, entry, data, lam, extra, prep, dtype):
    """Check the operands of a crown evaluation kernel of ``dtype`` (f32
    ``crown_eval`` or f64 ``crown_eval_df``) and launch it on
    ``_crown_eval_launch``'s team; returns its outputs (see
    ``crown_eval``)."""
    Nn, nx, nz = data["ABt"].shape
    nu = nz - nx
    dev = lam.device
    lam = lam.to(dtype).contiguous()
    extra = extra.to(dtype).contiguous()
    _build.require(name, "lam", lam, (Nn, nx), dev, dtype)
    _build.require(name, "extra", extra, (Nn, nz), dev, dtype)
    check_data(name, data, prep, dev, dtype)
    kw = dict(dtype=dtype, device=dev)
    out = dict(x=torch.empty((Nn, nx), **kw), u=torch.empty((Nn, nu), **kw),
               qtilde=torch.empty((Nn, nx), **kw), rtilde=torch.empty((Nn, nu), **kw),
               xUnc=torch.empty((Nn, nx), **kw), uUnc=torch.empty((Nn, nu), **kw),
               res=torch.empty((Nn, nx), **kw), fcr=torch.empty((Nn,), **kw))
    t = eval_sched(prep, dev)
    atb = torch.empty((Nn, nz), **kw)
    ptrs = _build.ptr_array(
        [data[k] for k in CROWN_DATA_KEYS]
        + [t["par"], t["kid_ptr"], t["kid_idx"], lam, extra, atb]
        + [out[k] for k in ("x", "u", "qtilde", "rtilde", "xUnc", "uUnc", "res", "fcr")]
        + [None])
    blocks, _, threads = _crown_eval_launch(Nn, nx, nu)
    err = getattr(_build.lib(), entry)(ptrs, Nn, nx, nu, blocks, threads, _build.stream(dev))
    _build.check(err, name)
    return out


def check_data(name, data, prep, dev, dtype):
    """Raise unless ``data`` holds ``crown_eval_data``'s fields of
    ``dtype`` on ``dev`` for the crown of ``prep``."""
    Nn, nx, nz = data["ABt"].shape
    for k, shape in crown_data_shapes(Nn, nx, nz - nx).items():
        _build.require(name, k, data[k], shape, dev, dtype)
    if not (0 < nx <= 16 and nz > nx and Nn == len(prep.par)):
        raise ValueError(f"{name}: unsupported shape {tuple(data['ABt'].shape)}")

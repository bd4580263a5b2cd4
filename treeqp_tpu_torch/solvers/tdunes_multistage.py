"""Scenario-split dual Newton for multistage robust-MPC trees.

Port of ``treeqp_tpu/solvers/tdunes_multistage.py``. A multistage tree
(branch ``md`` ways for ``Nr`` stages, then chains to horizon ``Nh``,
reference ``setup_multistage_tree`` tree.c:247-280) splits into:

* the **crown** — stages 0..Nr, a small generic tree;
* ``S = md**Nr`` independent **chains** of length ``L = Nh - Nr``, stored as
  stacked ``[S, L, ...]`` tensors.

One Newton iteration of the f64 phase evaluates the stage QPs and the dual
residual in the data dtype (f64), factorizes the dual Hessian in f32 (at
the bench's options two kernels: ``ops.chain_kernels.chain_blocks_factor``
and ``ops.crown_kernels.crown_blocks_factor``), solves the Newton system in
f32 (``ops.system_kernels.system_solve``), restores an f64-quality
direction by iterative refinement against the f64 Hessian action, and
takes an Armijo step on the dual function.

The two-phase solve (``f32_phase_tol > 0``) first runs a coarse phase with
everything in f32: with inf-norm termination one launch of
``ops.iter_kernel.newton_iter`` per common-path iteration; otherwise the
per-kernel loop on ``ops.chain_kernels.chain_eval`` and
``ops.crown_kernels.crown_eval``. Both refactorize with
``chain_blocks_factor_lanes`` and ``crown_blocks_factor`` when the active
set changes, and search with the batched Armijo rule. The high-precision
phase then finishes from the coarse duals: with ``df64_phase`` the loop of
``solvers.ms_df64`` (its evaluations, Hessian action and dual values in
native f64 kernels; it reuses the coarse phase's last factorization when
the active-set pattern is unchanged), otherwise the f64 loop above.

The JAX version is one jitted ``while_loop``; here the loop is Python
control flow, so each termination test, Armijo acceptance and
factorization-reuse comparison reads a scalar back to the host.

Every option the JAX package takes, on one device: the one- and two-phase
solves (with or without ``df64_phase``), the sequential and batched Armijo
searches, the full-step restart, the coarse phase's stall exit, the reuse
of the factorization on an unchanged active set and both refinement
variants, on the route the JAX package chooses by the options alone. With
``chain_backend="pallas"`` and f32 factors the chain side runs on the
kernels above; the crown side, the fused system solve and the fused
iteration also need a static regularization (``reg_type`` "always" or
"none"): under ``reg_type="on_the_fly"`` the crown is factored and solved
by the plain tree Cholesky between the chain kernels' sweeps (three calls
a solve), and the coarse phase is the per-kernel loop. With
``chain_backend="xla"`` every step is plain PyTorch: the chain blocks built
op by op, the banded chain factor and sweeps with the regularized block
Cholesky, the plain tree Cholesky of the crown. Like the JAX package's,
the solver takes only the clipping stage solver and rejects the chain
kernels with factors in the data dtype (``ValueError``); ``axis_name``
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TreeQPIn, TreeQPOut, QP_FIELDS
from treeqp_tpu_torch.utils.tree import TreeStructure
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers.tdunes import (
    TdunesOpts, TDUNES_OPTIMAL, TDUNES_MAX_ITER, TDUNES_NOT_DESCENT, _armijo)
from treeqp_tpu_torch.ops import _dense
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import crown_kernels as ckr
from treeqp_tpu_torch.ops import iter_kernel as ik
from treeqp_tpu_torch.ops import system_kernels as sk

__all__ = ["MultistageQP", "split_multistage", "tdunes_ms_solve",
           "merge_output", "chain_node_ids", "split_duals", "multistage_applicable"]

CHAIN_FIELDS = ("Qd", "Rd", "q", "r", "xmin", "xmax", "umin", "umax",
                "A", "B", "b")
# the general C/D rows of the chain nodes: None on trees without rows
GENERAL_FIELDS = ("C", "D", "dmin", "dmax")


@dataclasses.dataclass(frozen=True)
class _MsMeta:
    md: int
    Nr: int
    Nh: int
    S: int
    L: int
    nx: int
    nu: int
    crown_topo: TreeStructure
    full_topo: TreeStructure
    # crown node ids of the S chain roots (stage-Nr nodes), scenario order
    root_ids: tuple


@dataclasses.dataclass(frozen=True)
class MultistageQP:
    """A multistage tree QP in crown + stacked-chain layout."""

    crown: TreeQPIn  # crown tree (stages 0..Nr); stage-Nr nodes keep real nu
    # chain tensors [S, L, ...]; j-th entry = chain node at stage Nr+1+j
    Qd: torch.Tensor  # [S, L, nx] diagonal weights (identity-padded)
    Rd: torch.Tensor  # [S, L, nu]
    q: torch.Tensor
    r: torch.Tensor
    xmin: torch.Tensor
    xmax: torch.Tensor
    umin: torch.Tensor
    umax: torch.Tensor
    A: torch.Tensor  # [S, L, nx, nx] edge into chain node j (j=0: from crown node)
    B: torch.Tensor  # [S, L, nx, nu]
    b: torch.Tensor  # [S, L, nx]
    meta: _MsMeta
    # general C/D rows of the chain nodes ([S, L, ncm, nx/nu], [S, L, ncm]),
    # None when the tree has none; the multistage IPM reads them, the
    # multistage dual Newton refuses them
    C: torch.Tensor = None
    D: torch.Tensor = None
    dmin: torch.Tensor = None
    dmax: torch.Tensor = None

    def to(self, device=None, dtype=None) -> "MultistageQP":
        """Every tensor moved to ``device`` and/or cast to ``dtype``."""
        kw = {f: getattr(self, f).to(device=device, dtype=dtype)
              for f in CHAIN_FIELDS + GENERAL_FIELDS if getattr(self, f) is not None}
        return dataclasses.replace(self, crown=self.crown.to(device, dtype), **kw)


def chain_node_ids(meta) -> np.ndarray:
    """[S, L] grid of full-tree node ids of the chain nodes (scenario s,
    chain position j = stage Nr+1+j). Stage-contiguous BFS numbering keeps
    scenario order within each stage."""
    ss = meta.full_topo.stage_start
    return np.stack([np.arange(int(ss[meta.Nr + 1 + j]),
                               int(ss[meta.Nr + 2 + j]))
                     for j in range(meta.L)], axis=1).astype(np.int64)


def split_duals(ms: MultistageQP, lam_nodes):
    """Split a full-tree dual warm start [Nn, nxm] into the crown+chain
    layout (lam0_crown [Ncrown, nxm_cr], lam0_chain [S, L, nx]) — the
    multistage counterpart of treeqp_tdunes_set_dual_initialization. On
    ``lam_nodes``'s device."""
    meta = ms.meta
    lam_nodes = torch.as_tensor(lam_nodes)
    ids = torch.as_tensor(chain_node_ids(meta), device=lam_nodes.device)
    lam_cr = lam_nodes[: meta.crown_topo.Nn, : meta.crown_topo.nxm]
    lam_ch = lam_nodes[ids][:, :, : ms.q.shape[-1]]
    return lam_cr, lam_ch


def multistage_applicable(qp: TreeQPIn) -> bool:
    """True when the crown+chains speed path applies: multistage scenario
    tree (setup_multistage_tree shape) with clipping-class data."""
    if qp.topo.multistage_params is None:
        return False
    return td.clipping_applicable(qp)


def _ms_meta(topo: TreeStructure) -> _MsMeta:
    """Crown/chain split of a multistage topology."""
    params = topo.multistage_params
    if params is None:
        raise ValueError("not a multistage scenario tree")
    md, Nr, Nh = params
    S = md**Nr if md > 1 else 1
    L = Nh - Nr
    ss = topo.stage_start
    root_ids = tuple(range(int(ss[Nr]), int(ss[Nr + 1])))
    assert len(root_ids) == S
    crown_nodes = int(ss[Nr + 1])
    crown_topo = TreeStructure.from_parent(
        topo.parent[:crown_nodes], topo.nx[:crown_nodes],
        topo.nu[:crown_nodes], topo.nc[:crown_nodes])
    meta = _MsMeta(md=md, Nr=Nr, Nh=Nh, S=S, L=L, nx=topo.nx[root_ids[0]],
                   nu=topo.nu[root_ids[0]], crown_topo=crown_topo,
                   full_topo=topo, root_ids=root_ids)
    # consistency: each chain node's parent is the previous chain node
    ids = chain_node_ids(meta)
    par = topo.parent_np
    assert np.array_equal(par[ids[:, 0]], np.asarray(root_ids))
    for j in range(1, L):
        assert np.array_equal(par[ids[:, j]], ids[:, j - 1])
    return meta


def split_multistage(qp: TreeQPIn) -> MultistageQP:
    """Split a multistage TreeQPIn into crown + stacked chains.

    Layout requirement: diagonal Q/R, zero S. General C/D rows are carried
    in stacked chain tensors (the crown keeps its own): the multistage IPM
    (``ipm_ms_solve``) handles them, ``tdunes_ms_solve`` refuses them."""
    if not td.diag_weights_applicable(qp):
        raise ValueError("multistage solver requires diagonal Q/R and zero S "
                         "(general C/D rows are allowed for the IPM)")
    topo = qp.topo
    meta = _ms_meta(topo)
    ids = torch.as_tensor(chain_node_ids(meta), device=qp.device)
    xm = torch.as_tensor(topo.x_mask, dtype=qp.dtype, device=qp.device)[ids]
    um = torch.as_tensor(topo.u_mask, dtype=qp.dtype, device=qp.device)[ids]
    Qd = torch.diagonal(qp.Q, dim1=1, dim2=2)[ids] * xm + (1 - xm)
    Rd = torch.diagonal(qp.R, dim1=1, dim2=2)[ids] * um + (1 - um)
    crown_nodes = meta.crown_topo.Nn
    crown = TreeQPIn(**{f: getattr(qp, f)[:crown_nodes] for f in QP_FIELDS},
                     topo=meta.crown_topo)
    # ncm is padded to >= 1 even without rows: carry them only if present
    general = ({f: getattr(qp, f)[ids] for f in GENERAL_FIELDS}
               if max(topo.nc) > 0 else {})
    return MultistageQP(
        crown=crown, Qd=Qd, Rd=Rd,
        **{f: getattr(qp, f)[ids] for f in CHAIN_FIELDS if f not in ("Qd", "Rd")},
        meta=meta, **general)


# ---------------------------------------------------------------------------
# chain operations (all batched over [S, L])


def _chain_stage_solve(ms: MultistageQP, lam_ch):
    """Clipping stage solve for all chain nodes.

    qmod[s,j] = -q + lam[s,j] - A[s,j+1]' lam[s,j+1]   (last j: no kid term)
    """
    nx = ms.A.shape[-1]
    AB = torch.cat([ms.A, ms.B], dim=3)[:, 1:]
    ABup = torch.einsum("sljn,slj->sln", AB, lam_ch[:, 1:])
    qmod = -ms.q + lam_ch
    qmod[:, :-1] -= ABup[..., :nx]
    rmod = -ms.r
    rmod[:, :-1] -= ABup[..., nx:]
    Qinv, Rinv = 1.0 / ms.Qd, 1.0 / ms.Rd
    xUnc = Qinv * qmod
    uUnc = Rinv * rmod
    x = torch.clamp(xUnc, ms.xmin, ms.xmax)
    u = torch.clamp(uUnc, ms.umin, ms.umax)
    qt = torch.where((xUnc > ms.xmax) | (xUnc < ms.xmin), 0.0, Qinv)
    rt = torch.where((uUnc > ms.umax) | (uUnc < ms.umin), 0.0, Rinv)
    return dict(qmod=qmod, rmod=rmod, x=x, u=u, xUnc=xUnc, uUnc=uUnc, qt=qt, rt=rt)


def _chain_root_contrib(ms: MultistageQP, lam_ch, rid):
    """-A0'lam0 / -B0'lam0 terms to inject into the crown stage-Nr nodes'
    modified gradients, in crown [Ncrown, nxm/num] layout."""
    nx = ms.A.shape[-1]
    AB0 = torch.cat([ms.A, ms.B], dim=3)[:, 0]
    cqr = torch.einsum("sjn,sj->sn", AB0, lam_ch[:, 0])
    Ncrown = ms.meta.crown_topo.Nn
    extra = torch.zeros((Ncrown, cqr.shape[-1]), dtype=cqr.dtype, device=cqr.device)
    extra[rid] = cqr
    return extra[:, :nx], extra[:, nx:]


def _chain_residual(ms: MultistageQP, ch, x_crown, u_crown, rid):
    """res[s,j] = A x_parent + B u_parent + b - x  over all chain edges."""
    xp = torch.cat([x_crown[rid][:, None], ch["x"][:, :-1]], dim=1)
    up = torch.cat([u_crown[rid][:, None], ch["u"][:, :-1]], dim=1)
    AB = torch.cat([ms.A, ms.B], dim=3)
    zp = torch.cat([xp, up], dim=2)
    return torch.einsum("slij,slj->sli", AB, zp) + ms.b - ch["x"]


def _chain_dual_terms(ms: MultistageQP, ch, lam_ch):
    """Chain contribution to f = -g: per node -1/2 x'Qx + qmod'x (+u terms),
    minus sum over chain edges b'lam."""
    x, u = ch["x"], ch["u"]
    tx = x * (ch["qmod"] - 0.5 * ms.Qd * x) - ms.b * lam_ch
    tu = u * (ch["rmod"] - 0.5 * ms.Rd * u)
    return torch.sum(tx) + torch.sum(tu)


def _chain_blocks(ms: MultistageQP, ch, qt_crown, rt_crown, rid, dtype):
    """Dual-Hessian chain blocks built op by op in ``dtype`` (the JAX
    package's ``_chain_blocks``): Wc [S, L, nx, nx] = A_j qt_p A_j' + B_j
    rt_p B_j' + diag(qt_j) and Utc [S, L, nx, nx] = -qt_p A_j' (p the parent
    of node j: the chain's crown root at j = 0)."""
    qt_p = torch.cat([qt_crown[rid][:, None], ch["qt"][:, :-1]], dim=1).to(dtype)
    rt_p = torch.cat([rt_crown[rid][:, None], ch["rt"][:, :-1]], dim=1).to(dtype)
    A, B = ms.A.to(dtype), ms.B.to(dtype)
    AB = torch.cat([A, B], dim=3)
    Wc = torch.einsum("slin,sln,sljn->slij", AB, torch.cat([qt_p, rt_p], dim=2), AB)
    Wc = Wc + torch.diag_embed(ch["qt"].to(dtype))
    return Wc, -(qt_p[..., :, None] * A.transpose(2, 3))


def _chain_factor(Wc, Utc, opts):
    """Banded backward block Cholesky of each chain, j = L-1 .. 0 (the
    reference's per-scenario reverse Cholesky,
    dual_Newton_scenarios.c:590-689): ``chain_factor`` with
    ``chain_backend="pallas"`` (f32 factors, no LM shift), else plain at the
    factor dtype with ``tdunes._reg_cholesky`` on each block. Returns (Ls,
    CUs [S, L, n, n], schur0 [S, n, n] in Wc's dtype)."""
    out_dt = Wc.dtype
    fdt = td._factor_dtype(opts, out_dt)
    Wc, Utc = Wc.to(fdt), Utc.to(fdt)
    if opts.chain_backend == "pallas":
        Ls, CUs, schur0 = ck.chain_factor(Wc.contiguous(), Utc.contiguous())
        return Ls, CUs, schur0.to(out_dt)
    S, L, n, _ = Wc.shape
    Ls, CUs = torch.empty_like(Wc), torch.empty_like(Wc)
    schur = torch.zeros((S, n, n), dtype=fdt, device=Wc.device)
    for j in range(L - 1, -1, -1):
        Lb = td._reg_cholesky(Wc[:, j] - schur, opts)
        CU = torch.linalg.solve_triangular(Lb.mT, Utc[:, j], upper=True, left=False)
        Ls[:, j], CUs[:, j] = Lb, CU
        schur = CU @ CU.mT
    return Ls, CUs, schur.to(out_dt)


def _chain_solve_bwd(Ls, CUs, res_ch, opts):
    """Right-hand-side backward sweep with ``_chain_factor``'s factors, at
    their dtype: y_j = L_j^-1 (r_j - CU_{j+1} y_{j+1}) for j = L-1 .. 0
    (``chain_solve_bwd`` with ``chain_backend="pallas"``). Returns (ys, the
    update radd0 [S, n] of each chain's crown-parent right-hand side in
    res_ch's dtype)."""
    out_dt = res_ch.dtype
    r = res_ch.to(Ls.dtype)
    if opts.chain_backend == "pallas":
        ys, radd0 = ck.chain_solve_bwd(Ls, CUs, r.contiguous())
        return ys, radd0.to(out_dt)
    ys = torch.empty_like(r)
    radd = torch.zeros_like(r[:, 0])
    for j in range(Ls.shape[1] - 1, -1, -1):
        ys[:, j] = td._tri_solve(Ls[:, j], r[:, j] - radd)
        radd = td._bmv(CUs[:, j], ys[:, j])
    return ys, radd.to(out_dt)


def _chain_forward(Ls, CUs, ys, droot, opts):
    """Forward substitution down each chain, j = 0 .. L-1: dl_j = L_j^-T (y_j
    - CU_j' dl_{j-1}) from dl_{-1} = droot [S, n], the crown's direction at
    each chain's edge (``chain_forward`` with ``chain_backend="pallas"``).
    Returns dls [S, L, n] in droot's dtype."""
    out_dt = droot.dtype
    dp = droot.to(Ls.dtype)
    if opts.chain_backend == "pallas":
        return ck.chain_forward(Ls, CUs, ys, dp.contiguous()).to(out_dt)
    dls = torch.empty_like(ys)
    for j in range(Ls.shape[1]):
        dp = td._tri_solve(Ls[:, j], ys[:, j] - td._bmv_t(CUs[:, j], dp), trans=True)
        dls[:, j] = dp
    return dls.to(out_dt)


# ---------------------------------------------------------------------------
# full solve


def _ms_stage_solve(ms: MultistageQP, crown_data, lam_cr, lam_ch, opts,
                    prep_cr, rid):
    ch = _chain_stage_solve(ms, lam_ch)
    extra_q, extra_r = _chain_root_contrib(ms, lam_ch, rid)
    cr = td._stage_solve(ms.crown, lam_cr, crown_data, opts, prep_cr,
                         extra_q, extra_r)
    return cr, ch


def _ms_apply_M(ms: MultistageQP, cr, ch, dlam_cr, dlam_ch, prep_cr, rid):
    """Apply the exact dual Hessian M = J P J' to a direction, in the data
    dtype. Used for iterative refinement of f32-factored Newton solves:
    M d = -(linearized dynamics residual of the linear stage response)."""
    qp = ms.crown
    xm, um, nrxm = td._masks(qp, prep_cr)
    par = prep_cr.on(qp.device)["par"]
    # crown linear stage response
    nxc = qp.A.shape[-1]
    ABr = torch.cat([qp.A, qp.B], dim=2)
    sum_AB = td._kid_sum(torch.einsum("nji,nj->ni", ABr, dlam_cr), prep_cr)
    eq, er = _chain_root_contrib(ms, dlam_ch, rid)
    xl = cr["qtilde"] * (dlam_cr - sum_AB[..., :nxc] - eq) * xm
    ul = cr["rtilde"] * (-sum_AB[..., nxc:] - er) * um
    # chain linear stage response
    nx = ms.A.shape[-1]
    ABc = torch.cat([ms.A, ms.B], dim=3)[:, 1:]
    ABup = torch.einsum("sljn,slj->sln", ABc, dlam_ch[:, 1:])
    qml = dlam_ch.clone()
    qml[:, :-1] -= ABup[..., :nx]
    rml = torch.zeros_like(ch["rmod"])
    rml[:, :-1] -= ABup[..., nx:]
    xlc = ch["qt"] * qml
    ulc = ch["rt"] * rml
    # linearized residuals
    zpr = torch.cat([xl[par], ul[par]], dim=1)
    res_cr = (torch.einsum("nij,nj->ni", ABr, zpr) - xl) * nrxm
    xp = torch.cat([xl[rid][:, None], xlc[:, :-1]], dim=1)
    up = torch.cat([ul[rid][:, None], ulc[:, :-1]], dim=1)
    zpc = torch.cat([xp, up], dim=2)
    res_ch = torch.einsum("slij,slj->sli", torch.cat([ms.A, ms.B], dim=3), zpc) - xlc
    return -res_cr, -res_ch


def _ms_dual_value(ms, crown_data, lam_cr, lam_ch, cr, ch, opts):
    return (td._dual_value(ms.crown, lam_cr, cr, crown_data, opts)
            + _chain_dual_terms(ms, ch, lam_ch))


def _schur_scatter(schur0, g_of, slot, prep, nxm):
    """Per-scenario [nxm, nxm] chain-root Schur blocks -> the [NpG, G, G]
    crown-group layout: each block lands on its group's kid-slot diagonal
    block. One writer per (group, slot), so a plain indexed write."""
    NpG, K = prep.NpG, prep.K
    out = torch.zeros((NpG, K, nxm, K, nxm), dtype=schur0.dtype,
                      device=schur0.device)
    out[g_of, slot, :, slot, :] = schur0
    return out.view(NpG, K * nxm, K * nxm)


def _solve_ctx(ms: MultistageQP, prep_cr) -> dict:
    """Per-solve constants of the factorize: the chain-root index tensors,
    the crown nonroot mask, and the loop-invariant f32 dynamics operands
    of the two factor kernels."""
    meta = ms.meta
    dev, dt = ms.q.device, ms.q.dtype
    t = prep_cr.on(dev)
    rid = np.asarray(meta.root_ids)
    nxm = meta.crown_topo.nxm
    # crown-group position of each chain root's lambda-edge: the Schur
    # complement of chain j=0 lands on the diagonal block of the crown group
    # holding lam(edge into root_ids[s])
    slot = prep_cr.slot_of_node[rid]
    lng = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)
    f32 = torch.float32
    crown_AB32 = torch.cat([ms.crown.A, ms.crown.B], dim=2).to(f32)
    return dict(
        rid=lng(rid), g_of=lng(prep_cr.group_of_node[rid]), slot=lng(slot),
        rows=lng(slot[:, None] * nxm + np.arange(nxm)[None, :]),
        dt=dt, nrxm_cr=td._masks(ms.crown, prep_cr)[2],
        ABt=torch.cat([ms.A, ms.B], dim=3).to(f32).contiguous(),
        ABk=torch.where(t["kvalid"][:, :, None, None],
                        crown_AB32[t["kidsP"]], 0.0).contiguous())


def _eval_data(ms: MultistageQP, prep_cr):
    """The f32 operands of the evaluation kernels (chain_eval, crown_eval,
    newton_iter): loop-invariant, made once per solve."""
    data_ch = ck.chain_eval_data(ms.A, ms.B, ms.q, ms.r, ms.Qd, ms.Rd, ms.xmin,
                                 ms.xmax, ms.umin, ms.umax, ms.b)
    data_cr = ckr.crown_eval_data(ms.crown, prep_cr, *td._masks(ms.crown, prep_cr))
    return data_ch, data_cr


def _factor_inputs(qtilde_cr, rtilde_cr, qt_ch, rt_ch, prep_cr, ctx, lanes=False):
    """The f32 operands of the two factor kernels for one active set.

    Returns dict(chain=(ABt, ztp, qtc, s_root) for chain_blocks_factor, or
    with ``lanes`` (ABt, qt, rt, ztp_root, s_root) for
    chain_blocks_factor_lanes; crown=(ABk, ztp, dvals, sW, sUt) for
    crown_blocks_factor (which also takes the chain Schur term); s_node
    [Ncrown, nxm] the crown Jacobi scales in node layout, in the data
    dtype)."""
    f32 = torch.float32
    prep = prep_cr
    g_of, rows = ctx["g_of"], ctx["rows"]
    t = prep.on(qtilde_cr.device)
    kv = t["kvalid"]
    # analytic diagonal of the crown W blocks (the only crown-block
    # quantity needed outside the kernels): sum_n ABk[.., n]^2 ztp[n] +
    # the kids' own qtilde
    ABk = ctx["ABk"]
    qtilde32 = qtilde_cr.to(f32)
    ztp = torch.cat([qtilde32, rtilde_cr.to(f32)], dim=-1)[t["gnodes"]]
    dvals = torch.where(kv[:, :, None], qtilde32[t["kidsP"]],
                        1.0).reshape(prep.NpG, prep.G)
    diagW = (torch.einsum("gkin,gn,gkin->gki", ABk, ztp, ABk)
             .reshape(prep.NpG, prep.G) + dvals)
    sW = torch.rsqrt(torch.clamp(diagW, min=1e-12))
    sUt = sW[t["gdad_safe"][:, None], t["gslot_cols"]]
    s_node = td._group_to_nodes_mm(sW, prep, ctx["dt"]) * ctx["nrxm_cr"]

    chain = _chain_inputs(qtilde_cr, rtilde_cr, qt_ch, rt_ch, sW[g_of[:, None], rows], ctx,
                          lanes)
    return dict(chain=chain, crown=(ABk, ztp, dvals, sW, sUt), s_node=s_node)


def _chain_inputs(qtilde_cr, rtilde_cr, qt_ch, rt_ch, s_root, ctx, lanes=False):
    """The f32 operands of ``chain_blocks_factor`` (ABt, ztp, qtc, s_root),
    or with ``lanes`` of ``chain_blocks_factor_lanes`` (ABt, qt, rt,
    ztp_root, s_root); ``s_root`` [S, nxm] the crown's Jacobi scales at
    the chain roots' lambdas."""
    f32 = torch.float32
    rid = ctx["rid"]
    ztp_root = torch.cat([qtilde_cr[rid], rtilde_cr[rid]], dim=-1).to(f32)
    s_root = s_root.to(f32)
    qt32 = qt_ch.to(f32).contiguous()
    if lanes:
        return (ctx["ABt"], qt32, rt_ch.to(f32).contiguous(), ztp_root, s_root)
    ztp_ch = torch.cat([qt_ch, rt_ch], dim=-1).to(f32)
    ztp_c = torch.cat([ztp_root[:, None], ztp_ch[:, :-1]], dim=1)
    return (ctx["ABt"], ztp_c, qt32, s_root)


def _fused_chain(opts) -> bool:
    """The chain side of the factorize is one kernel
    (``chain_blocks_factor(_lanes)``): the JAX package's ``fused_chain``,
    ``chain_backend="pallas"`` with f32 factors (the stage solver is
    clipping)."""
    return opts.chain_backend == "pallas" and opts.factor_dtype == "float32"


def _solve_backends(prep_cr, meta, opts):
    """(crown_kernels, fused): whether the crown's factor and solve are the
    crown kernels (``crown_kernels.crown_supported``), and whether the whole
    Newton solve is one ``system_solve`` (``system_kernels.system_supported``),
    as the JAX package's ``_solve_backends`` decides them. Both need
    ``chain_backend="pallas"``, f32 factors and a static
    regularization."""
    if not (td._tree_kernels(opts) and ckr.crown_supported(prep_cr, opts)):
        return False, False
    return True, sk.system_supported(prep_cr, meta, opts)


def _ms_factorize(ms, qtilde_cr, rtilde_cr, qt_ch, rt_ch, opts, prep_cr, ctx,
                  lanes=False):
    """Factorize the crown+chains dual Hessian: blocks, Jacobi
    equilibration and factorization of each side, by the JAX package's four
    branches. The chain side is one kernel (``chain_blocks_factor``, or with
    ``lanes`` the variant that reads the chain evaluation's qt/rt directly)
    where ``_fused_chain``, else ``_chain_blocks`` and ``_chain_factor``;
    the crown side is one kernel with the chain Schur term
    (``crown_blocks_factor``) where the chain side is fused and the crown
    kernels apply, else the crown's blocks built at the factor dtype, the
    chain Schur blocks subtracted, and ``tdunes._tree_chol_factor``.
    Returns dict(Ls, CUs, CholW, CholUt, s_node, sc), with kind="plain"
    where the crown's factors are the plain tree Cholesky's."""
    fused_chain = _fused_chain(opts)
    fused_crown = fused_chain and _solve_backends(prep_cr, ms.meta, opts)[0]
    rid, g_of, rows = ctx["rid"], ctx["g_of"], ctx["rows"]
    fdt = td._factor_dtype(opts, ms.q.dtype)
    if fused_crown:
        inp = _factor_inputs(qtilde_cr, rtilde_cr, qt_ch, rt_ch, prep_cr, ctx, lanes)
        sW, s_node = inp["crown"][3], inp["s_node"]
    else:
        W, Ut = td._build_dual_hessian(ms.crown, dict(qtilde=qtilde_cr, rtilde=rtilde_cr),
                                       None, opts, prep_cr, dtype=fdt)
        sW, W, Ut = td._equilibrate(W, Ut, prep_cr)
        s_node = td._group_to_nodes_mm(sW, prep_cr, ctx["dt"]) * ctx["nrxm_cr"]
    if fused_chain:
        chain = (inp["chain"] if fused_crown else _chain_inputs(
            qtilde_cr, rtilde_cr, qt_ch, rt_ch, sW[g_of[:, None], rows], ctx, lanes))
        chain_factor = ck.chain_blocks_factor_lanes if lanes else ck.chain_blocks_factor
        Ls, CUs, schur0, sc = chain_factor(*chain)
    else:
        Wc, Utc = _chain_blocks(ms, dict(qt=qt_ch, rt=rt_ch), qtilde_cr, rtilde_cr, rid, fdt)
        sc = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Wc, dim1=2, dim2=3), min=1e-12))
        scp = torch.cat([sW[g_of[:, None], rows][:, None].to(sc.dtype), sc[:, :-1]], dim=1)
        Ls, CUs, schur0 = _chain_factor(Wc * sc[..., :, None] * sc[..., None, :],
                                        Utc * scp[..., :, None] * sc[..., None, :], opts)
    if fused_crown:
        Wadd = -_schur_scatter(schur0, g_of, ctx["slot"], prep_cr, prep_cr.nxm)
        reg = opts.reg_value if opts.reg_type == "always" else 0.0
        CholW, CholUt = ckr.crown_blocks_factor(*inp["crown"], Wadd, prep_cr, reg=reg)
        crown = dict(CholW=CholW, CholUt=CholUt)
    else:
        W = W - _schur_scatter(schur0.to(W.dtype), g_of, ctx["slot"], prep_cr, prep_cr.nxm)
        crown = td._tree_chol_factor(W, Ut, opts, prep_cr)
    return dict(Ls=Ls, CUs=CUs, s_node=s_node, sc=sc, **crown)


def _make_ms_solve(fact, meta, prep_cr, dt, nrxm_cr, opts, rid):
    """solve(rcr, rch) -> (dcr, dch) with the stored factors, in the JAX
    package's three forms (``_solve_backends``): one ``system_solve`` call;
    or three calls, the chain backward sweeps (``_chain_solve_bwd``), the
    crown's solve (``tdunes._tree_chol_solve``: the crown kernel or plain)
    and the chain forward sweeps (``_chain_forward``), joined at the chain
    roots; ``dt`` is the dtype of the crown direction."""
    s_node, sc, Ls, CUs = fact["s_node"], fact["sc"], fact["Ls"], fact["CUs"]
    # the crown's factors (with kind "plain" from the plain tree Cholesky)
    crown = {k: fact[k] for k in ("kind", "CholW", "CholUt") if k in fact}
    if _solve_backends(prep_cr, meta, opts)[1]:
        def solve(rcr, rch):
            rcr_s, rch_s = rcr * s_node, rch * sc
            rg = td._nodes_to_group_mm(rcr_s, prep_cr)
            dg, dch_s = sk.system_solve(Ls, CUs, crown["CholW"], crown["CholUt"],
                                        rg, rch_s, prep_cr, meta.root_ids)
            dcr_s = td._group_to_nodes_mm(dg, prep_cr, dt) * nrxm_cr
            return dcr_s * s_node, dch_s.to(dt) * sc
        return solve

    t = prep_cr.on(Ls.device)
    dad, slot = t["group_of_node"][rid], t["node_cols"][rid]

    def solve(rcr, rch):
        rcr_s, rch_s = rcr * s_node, rch * sc
        ys, radd0 = _chain_solve_bwd(Ls, CUs, rch_s, opts)
        rg = td._nodes_to_group_mm(rcr_s, prep_cr)
        rg[dad[:, None], slot] -= radd0.to(rg.dtype)
        dg = td._tree_chol_solve(crown, rg, prep_cr)
        dcr_s = td._group_to_nodes_mm(dg, prep_cr, dt) * nrxm_cr
        dch_s = _chain_forward(Ls, CUs, ys, dcr_s[rid], opts)
        return dcr_s * s_node, dch_s * sc
    return solve


def _check_opts(ms: MultistageQP, opts: TdunesOpts):
    """Raise on options the multistage solver does not take, as the JAX
    package does: a stage solver other than clipping, the chain kernels
    (``chain_backend="pallas"``) with factors in the data dtype (they are
    f32 only), and ``axis_name`` (multi-device, not ported yet)."""
    if opts.stage_solver != "clipping":
        raise ValueError("the multistage solver supports only the clipping stage "
                         f"solver, not stage_solver={opts.stage_solver!r}")
    if opts.chain_backend == "pallas" and opts.factor_dtype != "float32":
        raise ValueError("chain_backend='pallas' needs factor_dtype='float32' "
                         "(the chain kernels are f32)")
    if opts.axis_name is not None:
        raise NotImplementedError(
            "axis_name (multi-device) is not ported yet (ROADMAP.md, port queue)")


def _sets_equal(a, b) -> bool:
    # With clipping, the masked inverses are Qinv-or-0: exact equality is
    # active-set-pattern equality, and equal patterns give bitwise-identical
    # factorization inputs.
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _pattern_equal(a, b) -> bool:
    """Active-set PATTERN equality across representations: the masked
    inverses are value-or-0, so (x != 0) is the active-set pattern even when
    the values came from different data (the coarse phase's f32 against the
    high-precision phase's f64)."""
    return all(torch.equal(x != 0, y != 0) for x, y in zip(a, b))


def _error_of(opts, res_cr, res_ch):
    """The termination measure of the dual residuals (0-dim tensor)."""
    if opts.termination == "infnorm":
        return torch.maximum(res_cr.abs().max(), res_ch.abs().max())
    sq = torch.sum(res_cr**2) + torch.sum(res_ch**2)
    return torch.sqrt(sq) if opts.termination == "twonorm" else sq


def _ms_newton_loop(ms: MultistageQP, lam0_crown, lam0_chain,
                    opts: TdunesOpts, it0: int = 0, patience: int = 0):
    """The dual-Newton loop in the dtype of ``ms``'s data, counting
    iterations from ``it0``.

    With f32 data, ``chain_backend="pallas"`` and f32 factors (the coarse
    phase's per-kernel loop, the JAX package's ``fused_eval``) the stage
    evaluations are the chain_eval and crown_eval kernels and the
    factorize reads their active sets directly (chain_blocks_factor_lanes);
    otherwise they are plain PyTorch in the data dtype.
    ``patience > 0`` adds the coarse phase's stall exit: stop once the
    error has not improved by 10% for ``patience`` consecutive iterations.

    Returns (lam_cr, lam_ch, it, status, ls_it, cr, ch, err, handover); err
    is a 0-dim tensor, handover the (fact, sets) of the last step's
    factorization, for a high-precision phase that follows."""
    meta = ms.meta
    prep_cr = td._get_prep(meta.crown_topo)
    dt = ms.q.dtype
    crown_data = td._stage_data(ms.crown, opts, prep_cr)
    ctx = _solve_ctx(ms, prep_cr)
    rid, nrxm_cr = ctx["rid"], ctx["nrxm_cr"]
    fused_eval = dt == torch.float32 and _fused_chain(opts)
    if fused_eval:
        data_ch, data_cr = _eval_data(ms, prep_cr)

    def stage_solve(lam_cr, lam_ch):
        if fused_eval:
            ch = ck.chain_eval(data_ch, lam_ch)
            extra = torch.zeros_like(data_cr["ABt"][:, 0])
            extra[rid] = ch["cqr"]
            return ckr.crown_eval(data_cr, lam_cr, extra, prep_cr), ch
        return _ms_stage_solve(ms, crown_data, lam_cr, lam_ch, opts, prep_cr, rid)

    def dual_value(lam_cr, lam_ch, cr, ch):
        if fused_eval:
            return cr["fcr"].sum() + ch["fch"].sum()
        return _ms_dual_value(ms, crown_data, lam_cr, lam_ch, cr, ch, opts)

    def residuals_of(cr, ch):
        if fused_eval:
            # chain rows j >= 1 come out of chain_eval; row 0 still needs
            # A_0 z_crown from this crown solution
            zr = torch.cat([cr["x"][rid], cr["u"][rid]], dim=1)
            res_ch = ch["res_part"].clone()
            res_ch[:, 0] = res_ch[:, 0] + _dense.mv(ctx["ABt"][:, 0], zr)
            return cr["res"], res_ch
        return (td._dual_residual(ms.crown, cr, prep_cr),
                _chain_residual(ms, ch, cr["x"], cr["u"], rid))

    def factorize(cr, ch):
        return _ms_factorize(ms, cr["qtilde"], cr["rtilde"], ch["qt"],
                             ch["rt"], opts, prep_cr, ctx, lanes=fused_eval)

    def active_sig(cr, ch):
        return (cr["qtilde"], cr["rtilde"], ch["qt"], ch["rt"])

    def newton_step(lam_cr, lam_ch, status, restart, f0, cr, ch, res_cr,
                    res_ch, fact_prev, sig_prev):
        sig = active_sig(cr, ch)
        if opts.reuse_factorization and _sets_equal(sig, sig_prev):
            fact = fact_prev
        else:
            fact = factorize(cr, ch)
        solve = _make_ms_solve(fact, meta, prep_cr, dt, nrxm_cr, opts, rid)

        def newton_resnorm(dcr, dch):
            mcr, mch = _ms_apply_M(ms, cr, ch, dcr, dch, prep_cr, rid)
            n = float(torch.sum((res_cr - mcr) ** 2) + torch.sum((res_ch - mch) ** 2))
            return n, mcr, mch

        dlam_cr, dlam_ch = solve(res_cr, res_ch)
        if opts.refine_steps > 0 and not opts.refine_safeguard:
            for _ in range(opts.refine_steps):
                mcr, mch = _ms_apply_M(ms, cr, ch, dlam_cr, dlam_ch, prep_cr, rid)
                ccr, cch = solve(res_cr - mcr, res_ch - mch)
                dlam_cr = dlam_cr + ccr
                dlam_ch = dlam_ch + cch
        elif opts.refine_steps > 0:
            # safeguarded: iterate unconditionally, keep the best iterate by
            # Newton-system residual norm
            n_best, mcr, mch = newton_resnorm(dlam_cr, dlam_ch)
            best_cr, best_ch = dlam_cr, dlam_ch
            for _ in range(opts.refine_steps):
                ccr, cch = solve(res_cr - mcr, res_ch - mch)
                dlam_cr = dlam_cr + ccr
                dlam_ch = dlam_ch + cch
                n_new, mcr, mch = newton_resnorm(dlam_cr, dlam_ch)
                if n_new < n_best:
                    best_cr, best_ch, n_best = dlam_cr, dlam_ch, n_new
            dlam_cr, dlam_ch = best_cr, best_ch

        # --- Armijo line search on f = -g over (crown, chain) jointly
        dot = -(torch.sum(res_cr * dlam_cr) + torch.sum(res_ch * dlam_ch))

        def f_at(tau):
            lc = lam_cr + tau * dlam_cr
            lh = lam_ch + tau * dlam_ch
            cr2, ch2 = stage_solve(lc, lh)
            return dual_value(lc, lh, cr2, ch2), (cr2, ch2)

        # every path returns the accepted tau's stage solution and dual
        # value too, so the next iteration reuses them
        one = torch.ones((), dtype=dt, device=dot.device)
        f1, rest1 = f_at(one)
        tau, f_t, (cr_t, ch_t), ls_it, acc = _armijo(f_at, f0, dot, f1, rest1, opts)
        restart = restart + 1 if not acc else 0
        if opts.ls_restart_trigger > 0 and restart >= opts.ls_restart_trigger:
            # full-step restart: tau forced to 1; f_at(1)'s solution is rest1
            restart = 0
            tau, f_t, (cr_t, ch_t) = one, f1, rest1
        if bool(dot < 1e-10):  # the JAX package's documented < 0 deviation
            lam_cr = lam_cr + tau * dlam_cr
            lam_ch = lam_ch + tau * dlam_ch
        else:
            f_t, cr_t, ch_t = f0, cr, ch
            status = TDUNES_NOT_DESCENT
        return lam_cr, lam_ch, status, restart, ls_it, fact, sig, f_t, cr_t, ch_t

    # step-then-evaluate: the loop state always holds the stage solution,
    # residuals and error AT the current lam
    lam_cr, lam_ch = lam0_crown, lam0_chain
    cr, ch = stage_solve(lam_cr, lam_ch)
    res_cr, res_ch = residuals_of(cr, ch)
    err = _error_of(opts, res_cr, res_ch)
    f0 = dual_value(lam_cr, lam_ch, cr, ch)
    # the initial factorization matches cr/ch's active set, so the first
    # step's reuse-compare is a true hit and uses exactly this one
    fact = factorize(cr, ch)
    sig = active_sig(cr, ch)
    it, status, restart, ls_it = it0, TDUNES_OPTIMAL, 0, 0
    best, noimp = err, 0
    while (bool(err >= opts.tol) and status == TDUNES_OPTIMAL
           and it < opts.max_iter and (patience <= 0 or noimp < patience)):
        lam_cr, lam_ch, status, restart, ls_it, fact, sig, f0, cr, ch = \
            newton_step(lam_cr, lam_ch, status, restart, f0, cr, ch, res_cr,
                        res_ch, fact, sig)
        it += 1
        res_cr, res_ch = residuals_of(cr, ch)
        err = _error_of(opts, res_cr, res_ch)
        noimp = 0 if bool(err < 0.9 * best) else noimp + 1
        best = torch.minimum(best, err)
    return lam_cr, lam_ch, it, status, ls_it, cr, ch, err, (fact, sig)


def _mega_applicable(prep_cr, meta, opts) -> bool:
    """The coarse phase runs on the fused iteration kernel
    (ops/iter_kernel.py), as the JAX package's ``_mega_applicable`` decides:
    ``chain_backend="pallas"``, f32 factors, inf-norm termination, no
    refinement, and the fused system solve's options
    (``iter_kernel.iter_supported``)."""
    return (opts.chain_backend == "pallas" and opts.factor_dtype == "float32"
            and opts.termination == "infnorm" and opts.refine_steps == 0
            and ik.iter_supported(prep_cr, meta, opts))


def _ms_newton_loop_mega(ms: MultistageQP, lam0_crown, lam0_chain,
                         opts: TdunesOpts, it0: int, patience: int = 0):
    """The f32 coarse-phase loop on the fused iteration kernel: the common
    path of every iteration (system solve, tau = 1 trial, stage
    evaluation, residuals, error and dual-value partials) is ONE
    ``newton_iter`` launch; the acceptance bookkeeping, the reject-only
    line search (``newton_iter(mode="eval")`` per candidate) and the
    refactorization on an active-set change stay outside. Same Armijo rule,
    restart and patience as ``_ms_newton_loop``.

    Returns (lam_cr, lam_ch, it, handover): handover is the (fact, sets) of
    the last iterate's active set, for the high-precision phase."""
    meta = ms.meta
    prep_cr = td._get_prep(meta.crown_topo)
    ctx = _solve_ctx(ms, prep_cr)
    data_ch, data_cr = _eval_data(ms, prep_cr)

    def kcall(fact, lam_cr, lam_ch, res_cr, res_ch, mode):
        state = dict(lam_cr=lam_cr, lam_ch=lam_ch, res_cr=res_cr, res_ch=res_ch)
        return ik.newton_iter(data_ch, data_cr, fact, state, prep_cr,
                              meta.root_ids, mode=mode)

    def scal(p):
        return p[0].sum() + p[1].sum()

    def errof(p):
        return torch.maximum(p[0].max(), p[1].max())

    def sets_of(out):
        return (out["qtilde"], out["rtilde"], out["qt"], out["rt"])

    def factorize(sets):
        return _ms_factorize(ms, *sets, opts, prep_cr, ctx, lanes=True)

    # initial evaluation (the factors are not read in eval mode)
    lam_cr = lam0_crown.to(torch.float32) * ctx["nrxm_cr"]
    lam_ch = lam0_chain.to(torch.float32)
    out0 = kcall(None, lam_cr, lam_ch, None, None, "eval")
    res_cr, res_ch = out0["res2_cr"], out0["res2_ch"]
    f0, err = scal(out0["f1p"]), errof(out0["errp"])
    sets = sets_of(out0)
    fact = factorize(sets)
    it, status, restart = it0, TDUNES_OPTIMAL, 0
    best, noimp = err, 0
    while (bool(err >= opts.tol) and status == TDUNES_OPTIMAL
           and it < opts.max_iter and (patience <= 0 or noimp < patience)):
        out = kcall(fact, lam_cr, lam_ch, res_cr, res_ch, "iter")
        dot = scal(out["dotp"])
        f1 = scal(out["f1p"])
        rest1 = (out["lam2_cr"], out["lam2_ch"], out["res2_cr"], out["res2_ch"],
                 sets_of(out), errof(out["errp"]))

        def f_at(tau):
            lc = lam_cr + tau * out["dcr"]
            lh = lam_ch + tau * out["dch"]
            oe = kcall(None, lc, lh, None, None, "eval")
            return scal(oe["f1p"]), (lc, lh, oe["res2_cr"], oe["res2_ch"],
                                     sets_of(oe), errof(oe["errp"]))

        _, f_t, rest, _, acc = _armijo(f_at, f0, dot, f1, rest1, opts)
        restart = restart + 1 if not acc else 0
        if opts.ls_restart_trigger > 0 and restart >= opts.ls_restart_trigger:
            restart = 0
            f_t, rest = f1, rest1
        if bool(dot < 1e-10):
            lam_cr, lam_ch, res_cr, res_ch, sets2, err = rest
            f0 = f_t
        else:
            sets2 = sets
            status = TDUNES_NOT_DESCENT
        if not (opts.reuse_factorization and _sets_equal(sets2, sets)):
            fact = factorize(sets2)
        sets = sets2
        it += 1
        noimp = 0 if bool(err < 0.9 * best) else noimp + 1
        best = torch.minimum(best, err)
    return lam_cr, lam_ch, it, (fact, sets)


def tdunes_ms_solve(ms: MultistageQP, lam0_crown=None, lam0_chain=None,
                    opts: TdunesOpts = TdunesOpts()):
    """Dual Newton solve in crown+chains layout.

    Returns (crown_out dict, chain_out dict, info dict). Use
    ``merge_output`` for a full-tree TreeQPOut. Runs on the device of
    ``ms``'s tensors; ``lam0_crown`` [Ncrown, nxm] / ``lam0_chain``
    [S, L, nx] warm-start the duals (zeros when None).

    With ``opts.f32_phase_tol > 0`` and f64 data the solve runs two phases:
    a coarse phase with everything in f32 (the fused iteration kernel with
    inf-norm termination, the per-kernel loop otherwise) down to
    f32_phase_tol or a stall of ``f32_patience`` iterations, then the
    high-precision phase with refinement to ``opts.tol`` from where it
    stopped. With ``opts.df64_phase`` (f64 data, f32 factors, one device)
    that phase is ``ms_df64.ms_newton_loop_df``, with or without a coarse
    phase before it. ``info["iter_f32"]`` counts the coarse iterations,
    ``info["iter"]`` both phases. General C/D rows (``ms.C`` not None) are
    refused: the multistage dual Newton needs clipping stage QPs; such
    trees go to ``ipm_ms_solve``."""
    if ms.C is not None:
        raise ValueError("the multistage dual Newton needs nc = 0 (general C/D "
                         "rows: use ipm_ms_solve)")
    _check_opts(ms, opts)
    meta = ms.meta
    prep_cr = td._get_prep(meta.crown_topo)
    dt, dev = ms.q.dtype, ms.q.device
    crown_data = td._stage_data(ms.crown, opts, prep_cr)
    xm_cr, um_cr, nrxm_cr = td._masks(ms.crown, prep_cr)

    if lam0_crown is None:
        lam0_crown = torch.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm),
                                 dtype=dt, device=dev)
    if lam0_chain is None:
        lam0_chain = torch.zeros_like(ms.q)
    lam0_crown = lam0_crown * nrxm_cr

    it0 = 0
    handover = None  # (fact, sets) of the coarse phase's last factorization
    if opts.f32_phase_tol > 0 and dt == torch.float64 and opts.factor_dtype == "float32":
        f32 = torch.float32
        ms32 = ms.to(dtype=f32)
        opts32 = dataclasses.replace(
            opts, refine_steps=0, tol=max(opts.f32_phase_tol, opts.tol),
            ls_batch=opts.ls_batch if opts.ls_batch > 0 else 4)
        if _mega_applicable(prep_cr, meta, opts32):
            lam_cr32, lam_ch32, it0, handover = _ms_newton_loop_mega(
                ms32, lam0_crown.to(f32), lam0_chain.to(f32), opts32, it0,
                patience=opts.f32_patience)
        else:
            lam_cr32, lam_ch32, it0, *_, handover = _ms_newton_loop(
                ms32, lam0_crown.to(f32), lam0_chain.to(f32), opts32, it0,
                patience=opts.f32_patience)
        # the coarse phase's status is dropped: a not-descent there is
        # expected noise near the f32 residual floor, not a failure
        lam0_crown, lam0_chain = lam_cr32.to(dt), lam_ch32.to(dt)

    if (opts.df64_phase and dt == torch.float64
            and opts.factor_dtype == "float32" and opts.axis_name is None):
        from treeqp_tpu_torch.solvers.ms_df64 import ms_newton_loop_df
        lam_cr, lam_ch, it, status, ls_it, cr, ch, err = ms_newton_loop_df(
            ms, lam0_crown, lam0_chain, opts, it0, handover=handover)
    else:
        lam_cr, lam_ch, it, status, ls_it, cr, ch, err, _ = _ms_newton_loop(
            ms, lam0_crown, lam0_chain, opts, it0)
    err = float(err)
    if status == TDUNES_OPTIMAL and err >= opts.tol:
        status = TDUNES_MAX_ITER

    crown_out = dict(x=cr["x"], u=cr["u"], lam=lam_cr * nrxm_cr,
                     mu_x=crown_data["Qd"] * (cr["xUnc"] - cr["x"]) * xm_cr,
                     mu_u=crown_data["Rd"] * (cr["uUnc"] - cr["u"]) * um_cr)
    chain_out = dict(x=ch["x"], u=ch["u"], lam=lam_ch,
                     mu_x=ms.Qd * (ch["xUnc"] - ch["x"]),
                     mu_u=ms.Rd * (ch["uUnc"] - ch["u"]))
    info = dict(iter=it, status=status, error=err, ls_iter=ls_it, iter_f32=it0)
    return crown_out, chain_out, info


def merge_output(ms: MultistageQP, crown_out, chain_out, info) -> TreeQPOut:
    """Assemble a full-tree TreeQPOut in the original node numbering."""
    meta = ms.meta
    topo = meta.full_topo
    dt, dev = ms.q.dtype, ms.q.device
    ids = torch.as_tensor(chain_node_ids(meta), device=dev)

    def assemble(crown_v, chain_v, width):
        out = torch.zeros((topo.Nn, width), dtype=dt, device=dev)
        out[: meta.crown_topo.Nn] = crown_v
        out[ids] = chain_v
        return out

    mask = lambda m: torch.as_tensor(m, dtype=dt, device=dev)
    xm, um = mask(topo.x_mask), mask(topo.u_mask)
    mu_d = torch.zeros((topo.Nn, topo.ncm), dtype=dt, device=dev)
    if "mu_d" in crown_out:  # the multistage IPM's general-row multipliers
        mu_d = assemble(crown_out["mu_d"], chain_out["mu_d"], topo.ncm) * mask(topo.c_mask)
    return TreeQPOut(
        x=assemble(crown_out["x"], chain_out["x"], topo.nxm) * xm,
        u=assemble(crown_out["u"], chain_out["u"], topo.num) * um,
        lam=assemble(crown_out["lam"], chain_out["lam"], topo.nxm) * xm,
        mu_x=assemble(crown_out["mu_x"], chain_out["mu_x"], topo.nxm) * xm,
        mu_u=assemble(crown_out["mu_u"], chain_out["mu_u"], topo.num) * um,
        mu_d=mu_d, info=info)

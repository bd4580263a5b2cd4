"""Multistage (crown + chains) tree IPM.

Port of ``treeqp_tpu/solvers/ipm_multistage.py``: the Mehrotra IPM of
``solvers/ipm.py`` in the crown + chains layout of ``MultistageQP``. The
chain Riccati sweeps run batched over all scenarios ([S, L, ...] tensors),
the crown runs the tree recursion seeded with the chains' root terms W0 /
w0. Box constraints keep the barrier matrix diagonal; general C/D rows
(``ms.C`` not None, hpipm_tree.c:376-379) densify the stage Hessians
through G'Gamma G, so those instances run the dense chain Riccati and the
dense crown recursion.

Routing, as in JAX: on the f32-factored iterations with
``chain_backend="pallas"`` the chains run the CUDA kernels
``ric_chain_factor`` (diagonal or dense hbar), ``ric_chain_bwd`` and
``ric_chain_fwd`` (``ops/riccati_kernels.py``) and, on box-only trees, the
crown runs ``crown_ric_factor`` and ``crown_ric_solve``
(``ops/crown_riccati.py``; without the JAX kernel's node and depth caps);
with general rows the crown runs the plain ``ipm._riccati_factor`` /
``_riccati_solve`` in f32. The f64 phase and ``chain_backend="xla"`` run
the plain batched sweeps below (``_chain_riccati_*``) and the plain crown
recursion, as XLA runs them in JAX. The JAX one-hot matmul forms of the
index operations (TPU only) are not carried over.

With ``axis_name`` set the solver runs on one rank of a sharded solve (the
JAX package's ``_IpmShard`` under ``shard_map``): ``ms`` holds the rank's
chains (``parallel.sharding.shard_multistage``), the crown replicated;
the chain roots' Riccati terms W0 [S, nz, nz] (per factorization) and w0
[S, nz] (per solve) and the boundary forms c0 [S, nz] of the residuals
and the KKT action are all-gathered, the chain sections' sums reduced,
res4 max-reduced and the step length min-reduced, and the NaN guard
agreed on, so every host decision reads a value all ranks share.
"""

from __future__ import annotations

import numpy as np
import torch

from treeqp_tpu_torch.ops import crown_riccati as crk
from treeqp_tpu_torch.ops import riccati_kernels as rk
from treeqp_tpu_torch.parallel import sharding
from treeqp_tpu_torch.solvers.ipm import (
    IpmOpts, _INF_THRESH, _bmv, _check_opts, _cholesky, _chol_solve, _get_ipm_prep,
    _ipm_loop, _kid_sum, _max_step, _riccati_factor, _riccati_solve)
from treeqp_tpu_torch.solvers.tdunes_multistage import MultistageQP, chain_node_ids

__all__ = ["ipm_ms_solve"]

_CHAIN_TAGS = ("ch", "chg")


def _box_data(lo, hi, mask):
    """Finite-side masks of a stacked bound pair (``ipm._constraint_data``
    with G = I)."""
    m_lo = ((lo > -_INF_THRESH) & (mask > 0)).to(lo.dtype)
    m_hi = ((hi < _INF_THRESH) & (mask > 0)).to(lo.dtype)
    return m_lo, m_hi


def _chain_riccati_factor(hbar, AB, opts: IpmOpts, fdt=None):
    """Batched backward Riccati along all chains at once (the plain path).

    hbar [S, L, nz] diagonal stage Hessians (barrier included) or
    [S, L, nz, nz] dense ones; AB [S, L, nx, nz] the edge into chain node
    j. For j = L-1 .. 0: M_j = Hbar_j + W, W = AB_j' P_j AB_j. Returns
    dict(P, Luu, K, Mxu [S, L, ...], AB, W0 [S, nz, nz] the term flowing
    into each chain's crown parent)."""
    if fdt is not None:
        hbar = hbar.to(fdt)
    dt = hbar.dtype
    AB = AB.to(dt)
    S, L, nx, nz = AB.shape
    num = nz - nx
    reg = opts.reg_eps * torch.eye(num, dtype=dt, device=AB.device)
    W = torch.zeros((S, nz, nz), dtype=dt, device=AB.device)
    outs = []
    for j in range(L - 1, -1, -1):
        hb = hbar[:, j]
        M = W + (hb if hbar.dim() == 4 else torch.diag_embed(hb))
        Lb = _cholesky(M[:, nx:, nx:] + reg)
        Kb = -_chol_solve(Lb, M[:, nx:, :nx])
        Mxu = M[:, :nx, nx:]
        Pb = M[:, :nx, :nx] + Mxu @ Kb
        Pb = 0.5 * (Pb + Pb.mT)
        ABj = AB[:, j]
        W = ABj.mT @ (Pb @ ABj)
        outs.append((Pb, Lb, Kb, Mxu))
    P, Luu, K, Mxu = (torch.stack(v[::-1], dim=1) for v in zip(*outs))
    return dict(P=P, Luu=Luu, K=K, Mxu=Mxu, AB=AB, W0=W)


def _chain_riccati_bwd(fact, rg, rb):
    """Batched backward rhs sweep (``ipm._riccati_solve``'s first half):
    rg [S, L, nz], rb [S, L, nx] -> (p, k [S, L, ...], w0 [S, nz])."""
    P, Luu, Mxu, AB = fact["P"], fact["Luu"], fact["Mxu"], fact["AB"]
    dt = P.dtype
    rg, rb = rg.to(dt), rb.to(dt)
    S, L, nx, nz = AB.shape
    w = torch.zeros((S, nz), dtype=dt, device=P.device)
    ps, ks = [], []
    for j in range(L - 1, -1, -1):
        m = rg[:, j] + w
        kb = -_chol_solve(Luu[:, j], m[:, nx:, None])[..., 0]
        pb = m[:, :nx] + torch.einsum("bxu,bu->bx", Mxu[:, j], kb)
        v = torch.einsum("bxy,by->bx", P[:, j], rb[:, j]) + pb
        w = torch.einsum("bxz,bx->bz", AB[:, j], v)
        ps.append(pb)
        ks.append(kb)
    return torch.stack(ps[::-1], dim=1), torch.stack(ks[::-1], dim=1), w


def _chain_riccati_fwd(fact, p, k, rb, z_root):
    """Batched forward substitution down the chains from the crown's step
    at the chain roots' parents, z_root [S, nz]. Returns (dz [S, L, nz],
    dlam [S, L, nx])."""
    P, K, AB = fact["P"], fact["K"], fact["AB"]
    dt = P.dtype
    rb, zp = rb.to(dt), z_root.to(dt)
    dzs, dls = [], []
    for j in range(AB.shape[1]):
        dx = torch.einsum("bxz,bz->bx", AB[:, j], zp) + rb[:, j]
        du = torch.einsum("bux,bx->bu", K[:, j], dx) + k[:, j]
        dls.append(torch.einsum("bxy,by->bx", P[:, j], dx) + p[:, j])
        zp = torch.cat([dx, du], dim=1)
        dzs.append(zp)
    return torch.stack(dzs, dim=1), torch.stack(dls, dim=1)


def _scatter_rows(v, rid, Nc):
    """[S, ...] rows placed at the chain roots' crown rows of a zero
    [Nc, ...] tensor (one row per root)."""
    out = torch.zeros((Nc,) + v.shape[1:], dtype=v.dtype, device=v.device)
    out[rid] = v
    return out


def ipm_ms_solve(ms: MultistageQP, opts: IpmOpts = IpmOpts(), ws=None):
    """Mehrotra predictor-corrector IPM in crown + chains layout.

    Returns (crown_out dict, chain_out dict, info) like ``tdunes_ms_solve``
    (``merge_output`` gives the full-tree TreeQPOut); with general rows
    both dicts carry ``mu_d``. ``ws``: an optional (crown_out, chain_out)
    warm start pair, ``mu_d`` included where present. info = dict(iter,
    iter_f32 (the f32-factored phase's share), status, res4 (tensor [4])).

    With ``opts.axis_name`` set, one rank of a sharded solve (the module
    docstring; ``parallel.shard_solver.ipm_ms_solve_shmap``): ``ms`` and the
    chain half of ``ws`` hold the rank's chains, the chain outputs are the
    rank's, the rest is the same on every rank, and ``info["comm"]`` counts
    the collectives (``bytes``, ``calls``, ``max_call``,
    ``bytes_per_iter``)."""
    _check_opts(opts)
    meta = ms.meta
    qp = ms.crown
    topo = qp.topo
    prep = _get_ipm_prep(topo)
    dt, dev = ms.q.dtype, ms.q.device
    f32 = torch.float32
    Nc, nxm, num = topo.Nn, topo.nxm, topo.num
    nz = nxm + num
    S, L = ms.q.shape[:2]
    # the crown side scatters all S chain roots (``rid``), the chain side
    # reads this rank's (``rid_l``)
    rid = torch.as_tensor(np.asarray(meta.root_ids), dtype=torch.long, device=dev)
    shard = sharding.shard_for(opts.axis_name, S)
    rid_l = shard.slice_s(rid)
    par = prep.par_on(dev)
    t = lambda m: torch.as_tensor(m, dtype=dt, device=dev)

    xm, um, nrxm = t(topo.x_mask), t(topo.u_mask), t(topo.nonroot_x_mask)
    zmask_cr = torch.cat([xm, um], dim=1)
    # chain masks from the full topology (identity-padded weights cannot
    # tell padding apart)
    ids = shard.slice_s(torch.as_tensor(chain_node_ids(meta), device=dev))
    full = meta.full_topo
    xmask_ch, umask_ch = t(full.x_mask)[ids], t(full.u_mask)[ids]
    zmask_ch = torch.cat([xmask_ch, umask_ch], dim=2)

    # stacked diagonal Hessians / gradients / bounds ([.., nz])
    Hd_cr = torch.cat([torch.diagonal(qp.Q, dim1=1, dim2=2) * xm + (1 - xm),
                       torch.diagonal(qp.R, dim1=1, dim2=2) * um + (1 - um)], dim=1)
    h_cr = torch.cat([qp.q, qp.r], dim=1) * zmask_cr
    lo_cr = torch.cat([qp.xmin, qp.umin], dim=1)
    hi_cr = torch.cat([qp.xmax, qp.umax], dim=1)
    Hd_ch = torch.cat([ms.Qd, ms.Rd], dim=2)
    h_ch = torch.cat([ms.q, ms.r], dim=2) * zmask_ch
    lo_ch = torch.cat([ms.xmin, ms.umin], dim=2)
    hi_ch = torch.cat([ms.xmax, ms.umax], dim=2)
    AB_cr = torch.cat([qp.A, qp.B], dim=2)          # [Nc, nxm, nz]
    AB_ch = torch.cat([ms.A, ms.B], dim=3)          # [S, L, nxm, nz]
    AB_cr32, AB_ch32 = AB_cr.to(f32).contiguous(), AB_ch.to(f32).contiguous()

    # constraint sections: tag -> (lo, hi, m_lo, m_hi); box sections project
    # t = z, general sections t = [C D] z
    SEC = dict(cr=(lo_cr, hi_cr, *_box_data(lo_cr, hi_cr, zmask_cr)),
               ch=(lo_ch, hi_ch, *_box_data(lo_ch, hi_ch, zmask_ch)))
    HG = ms.C is not None
    if HG:
        cm_cr = t(full.c_mask)[:Nc]
        Gc_cr = torch.cat([qp.C * cm_cr[:, :, None], qp.D * cm_cr[:, :, None]], dim=2)
        cm_ch = t(full.c_mask)[ids]
        Gc_ch = torch.cat([ms.C * cm_ch[..., None], ms.D * cm_ch[..., None]], dim=3)
        SEC["crg"] = (qp.dmin, qp.dmax, *_box_data(qp.dmin, qp.dmax, cm_cr))
        SEC["chg"] = (ms.dmin, ms.dmax, *_box_data(ms.dmin, ms.dmax, cm_ch))
    TAGS = tuple(SEC)

    def tproj(tag, zc, zh):
        if tag == "cr":
            return zc
        if tag == "ch":
            return zh
        if tag == "crg":
            return _bmv(Gc_cr, zc)
        return _bmv(Gc_ch, zh)

    def sum_split(per_tag):
        """A per-section scalar summed as JAX sums it: the crown sections,
        then the chain sections (over every rank's chains), then the two."""
        t_cr = sum(per_tag(tag) for tag in TAGS if tag not in _CHAIN_TAGS)
        t_ch = sum((per_tag(tag) for tag in TAGS if tag in _CHAIN_TAGS),
                   start=torch.zeros((), dtype=dt, device=dev))
        return t_cr + shard.psum(t_ch)  # the crown terms replicated, the chains sharded

    n_ineq = torch.clamp(sum_split(lambda tag: SEC[tag][2].sum() + SEC[tag][3].sum()),
                         min=1.0)

    def root_add(r_cr, c0):
        """r_cr with the chain roots' terms c0 [S, nz] added at their rows."""
        r_cr = r_cr.clone()
        r_cr[rid] += c0
        return r_cr

    def chain_pull(r_ch, lam_ch):
        """-lam_j on the x rows, + AB_{j+1}' lam_{j+1}, masked."""
        up = _bmv(AB_ch[:, 1:].mT, lam_ch[:, 1:])
        r_ch = torch.cat([r_ch[..., :nxm] - lam_ch, r_ch[..., nxm:]], dim=2)
        return torch.cat([r_ch[:, :-1] + up, r_ch[:, -1:]], dim=1) * zmask_ch

    def crown_pull(r_cr, lam_cr, lam_ch):
        lamn = lam_cr * nrxm
        r_cr = torch.cat([r_cr[:, :nxm] - lamn, r_cr[:, nxm:]], dim=1)
        r_cr = r_cr + _kid_sum(_bmv(AB_cr.mT, lamn), topo)
        # chain-root lambdas pull on their crown parents (all-gathered
        # boundary form [S, nz])
        return root_add(r_cr, shard.gather_s(_bmv(AB_ch[:, 0].mT, lam_ch[:, 0]))) * zmask_cr

    def dyn(z_cr, z_ch, b_cr=0.0, b_ch=0.0):
        """A z_parent + b - z over the crown (masked by nrxm) and the
        chains."""
        r_cr = (_bmv(AB_cr, z_cr[par]) + b_cr - z_cr[:, :nxm]) * nrxm
        zp = torch.cat([z_cr[rid_l][:, None], z_ch[:, :-1]], dim=1)
        return r_cr, _bmv(AB_ch, zp) + b_ch - z_ch[:, :, :nxm]

    def residuals(st):
        """res_g / res_b and per-section res_d / res_m."""
        z_cr, z_ch = st["z_cr"], st["z_ch"]
        rg_cr = Hd_cr * z_cr + h_cr + (st["lhi_cr"] - st["llo_cr"]) * zmask_cr
        rg_ch = Hd_ch * z_ch + h_ch + (st["lhi_ch"] - st["llo_ch"]) * zmask_ch
        if HG:
            rg_cr = rg_cr + _bmv(Gc_cr.mT, st["lhi_crg"] - st["llo_crg"])
            rg_ch = rg_ch + _bmv(Gc_ch.mT, st["lhi_chg"] - st["llo_chg"])
        rg_cr = crown_pull(rg_cr, st["lam_cr"], st["lam_ch"])
        rg_ch = chain_pull(rg_ch, st["lam_ch"])
        rb_cr, rb_ch = dyn(z_cr, z_ch, qp.b, ms.b)
        rd, rm = {}, {}
        for tag in TAGS:
            lo, hi, mlo, mhi = SEC[tag]
            tt = tproj(tag, z_cr, z_ch)
            s_lo, s_hi = st["slo_" + tag], st["shi_" + tag]
            l_lo, l_hi = st["llo_" + tag], st["lhi_" + tag]
            rd[tag] = ((s_lo - (tt - lo)) * mlo, (s_hi - (hi - tt)) * mhi)
            rm[tag] = (s_lo * l_lo * mlo, s_hi * l_hi * mhi)
        return rg_cr, rg_ch, rb_cr, rb_ch, rd, rm

    def res4_of(rg_cr, rg_ch, rb_cr, rb_ch, rd, rm):
        mx = lambda *a: torch.stack([v.abs().max() for v in a]).max()
        # the crown terms replicated, so the max over ranks is the global one
        return shard.pmax(torch.stack([mx(rg_cr, rg_ch), mx(rb_cr, rb_ch),
                                       mx(*[v for tag in TAGS for v in rd[tag]]),
                                       mx(*[v for tag in TAGS for v in rm[tag]])]))

    def kkt_rhs(rg, rd_pair, rm_pair, s_lo, s_hi, l_lo, l_hi, mlo, mhi):
        """Eliminate (ds, dl) per section, elementwise in the section's row
        space (general sections fold through G' outside)."""
        rd_lo, rd_hi = rd_pair
        rm_lo, rm_hi = rm_pair
        inv_slo = torch.where(mlo > 0, 1.0 / s_lo, 0.0)
        inv_shi = torch.where(mhi > 0, 1.0 / s_hi, 0.0)
        gamma = l_lo * inv_slo + l_hi * inv_shi
        qx = (rm_lo - l_lo * rd_lo) * inv_slo - (rm_hi - l_hi * rd_hi) * inv_shi
        return rg + qx, gamma

    def expand_step(dz, rd_pair, rm_pair, s_lo, s_hi, l_lo, l_hi, mlo, mhi):
        rd_lo, rd_hi = rd_pair
        rm_lo, rm_hi = rm_pair
        ds_lo = (dz - rd_lo) * mlo
        ds_hi = (-dz - rd_hi) * mhi
        inv_slo = torch.where(mlo > 0, 1.0 / s_lo, 0.0)
        inv_shi = torch.where(mhi > 0, 1.0 / s_hi, 0.0)
        dl_lo = (-(rm_lo + l_lo * ds_lo) * inv_slo) * mlo
        dl_hi = (-(rm_hi + l_hi * ds_hi) * inv_shi) * mhi
        return ds_lo, ds_hi, dl_lo, dl_hi

    def kkt_apply(hbars, dzc, dzh, dlc, dlh):
        """Exact data-dtype action of the KKT operator the Riccati solves
        (``ipm._kkt_apply``); ``hbars`` = (diag_cr, diag_ch, gam_crg,
        gam_chg): the general rows' term applies factored, G'(Gamma (G dz))."""
        hb_cr_d, hb_ch_d, g_crg, g_chg = hbars
        r1_cr = hb_cr_d * dzc
        r1_ch = hb_ch_d * dzh
        if HG:
            r1_cr = r1_cr + _bmv(Gc_cr.mT, g_crg * _bmv(Gc_cr, dzc))
            r1_ch = r1_ch + _bmv(Gc_ch.mT, g_chg * _bmv(Gc_ch, dzh))
        d_cr, d_ch = dyn(dzc, dzh)
        return (crown_pull(r1_cr, dlc, dlh), chain_pull(r1_ch, dlh), -d_cr, -d_ch)

    def solve_kkt(fact_ch, fact_cr, kernels, rhs_cr, rhs_ch, rb_cr, rb_ch, hbars):
        """Whole-tree Riccati solve, chain bwd -> crown -> chain fwd
        (``kernels`` = (chain kernels, crown kernels) in use), refined
        ``refine_steps`` times against the exact KKT operator."""
        chain_k, crown_k = kernels

        def one_solve(rhs_cr_, rhs_ch_, rb_cr_, rb_ch_):
            bwd = rk.ric_chain_bwd if chain_k else _chain_riccati_bwd
            p_ch, k_ch, w0 = bwd(fact_ch, rhs_ch_, rb_ch_)
            wsum0 = _scatter_rows(shard.gather_s(w0), rid, Nc)  # [S, nz] boundary vector
            if crown_k:
                dz_cr, dlam_cr = crk.crown_ric_solve(fact_cr, rhs_cr_, rb_cr_, wsum0, prep)
            else:
                dz_cr, dlam_cr = _riccati_solve(qp, fact_cr, rhs_cr_, rb_cr_, prep,
                                                wsum0=wsum0)
            fwd = rk.ric_chain_fwd if chain_k else _chain_riccati_fwd
            dz_ch, dlam_ch = fwd(fact_ch, p_ch, k_ch, rb_ch_, dz_cr[rid_l])
            out = rhs_cr_.dtype
            return dz_cr.to(out), dz_ch.to(out), dlam_cr.to(out), dlam_ch.to(out)

        dzc, dzh, dlc, dlh = one_solve(rhs_cr, rhs_ch, rb_cr, rb_ch)
        for _ in range(opts.refine_steps):
            r1c, r1h, r2c, r2h = kkt_apply(hbars, dzc, dzh, dlc, dlh)
            # one_solve(rg', rb') gives L1 = -rg', L2 = rb'
            cc, ch_, lc, lh = one_solve(rhs_cr + r1c, rhs_ch + r1h, rb_cr - r2c,
                                        rb_ch - r2h)
            dzc, dzh, dlc, dlh = dzc + cc, dzh + ch_, dlc + lc, dlh + lh
        return dzc, dzh, dlc, dlh

    # --- initial point (cf. ipm_solve's cold / warm start)
    if ws is None:
        s_init = float(np.sqrt(opts.mu0))
        st0 = dict(z_cr=torch.zeros((Nc, nz), dtype=dt, device=dev),
                   z_ch=torch.zeros((S, L, nz), dtype=dt, device=dev),
                   lam_cr=torch.zeros((Nc, nxm), dtype=dt, device=dev),
                   lam_ch=torch.zeros((S, L, nxm), dtype=dt, device=dev))
        for tag in TAGS:
            lo, hi, mlo, mhi = SEC[tag]
            s_lo = torch.where(mlo > 0, torch.clamp(-lo, min=s_init), 1.0)
            s_hi = torch.where(mhi > 0, torch.clamp(hi, min=s_init), 1.0)
            st0["slo_" + tag], st0["shi_" + tag] = s_lo, s_hi
            st0["llo_" + tag] = torch.where(mlo > 0, opts.mu0 / s_lo, 0.0)
            st0["lhi_" + tag] = torch.where(mhi > 0, opts.mu0 / s_hi, 0.0)
    else:
        crown_ws, chain_ws = ws
        eps = opts.ws_eps
        z_cr = torch.cat([crown_ws["x"], crown_ws["u"]], dim=1).to(dt) * zmask_cr
        z_ch = torch.cat([chain_ws["x"], chain_ws["u"]], dim=2).to(dt) * zmask_ch
        st0 = dict(z_cr=z_cr, z_ch=z_ch, lam_cr=crown_ws["lam"].to(dt) * nrxm,
                   lam_ch=chain_ws["lam"].to(dt))
        mu_ws = dict(cr=torch.cat([crown_ws["mu_x"], crown_ws["mu_u"]], dim=1).to(dt),
                     ch=torch.cat([chain_ws["mu_x"], chain_ws["mu_u"]], dim=2).to(dt))
        if HG:
            for tag, w in (("crg", crown_ws), ("chg", chain_ws)):
                mu_ws[tag] = (w["mu_d"].to(dt) if "mu_d" in w
                              else torch.zeros_like(SEC[tag][0]))
        for tag in TAGS:
            lo, hi, mlo, mhi = SEC[tag]
            tt = tproj(tag, z_cr, z_ch)
            mu = mu_ws[tag]
            st0["slo_" + tag] = torch.where(mlo > 0, torch.clamp(tt - lo, min=eps), 1.0)
            st0["shi_" + tag] = torch.where(mhi > 0, torch.clamp(hi - tt, min=eps), 1.0)
            st0["llo_" + tag] = torch.where(mlo > 0, torch.clamp(-mu, min=eps), 0.0)
            st0["lhi_" + tag] = torch.where(mhi > 0, torch.clamp(mu, min=eps), 0.0)
    tf = opts.tau_frac_general if HG else opts.tau_frac

    def iteration(st, fdt):
        rg_cr, rg_ch, rb_cr, rb_ch, rd, rm = residuals(st)
        fdt_ = fdt or dt

        def sec_args(tag):
            _, _, mlo, mhi = SEC[tag]
            return (st["slo_" + tag], st["shi_" + tag], st["llo_" + tag],
                    st["lhi_" + tag], mlo, mhi)

        def make_rhs(rm_use):
            rhs_cr, gam_cr = kkt_rhs(rg_cr, rd["cr"], rm_use["cr"], *sec_args("cr"))
            rhs_ch, gam_ch = kkt_rhs(rg_ch, rd["ch"], rm_use["ch"], *sec_args("ch"))
            gams = dict(cr=gam_cr, ch=gam_ch)
            if HG:
                qx_crg, gams["crg"] = kkt_rhs(torch.zeros_like(SEC["crg"][0]), rd["crg"],
                                              rm_use["crg"], *sec_args("crg"))
                qx_chg, gams["chg"] = kkt_rhs(torch.zeros_like(SEC["chg"][0]), rd["chg"],
                                              rm_use["chg"], *sec_args("chg"))
                rhs_cr = rhs_cr + _bmv(Gc_cr.mT, qx_crg)
                rhs_ch = rhs_ch + _bmv(Gc_ch.mT, qx_chg)
            return rhs_cr, rhs_ch, gams

        rhs_cr_a, rhs_ch_a, gams = make_rhs(rm)
        hbar_d_cr = Hd_cr + gams["cr"]
        hbar_d_ch = Hd_ch + gams["ch"]
        hbars = (hbar_d_cr, hbar_d_ch, gams.get("crg"), gams.get("chg"))
        if HG:
            # general rows densify the barrier matrix, Hbar = diag + G'Gamma G,
            # built in the factor dtype (it feeds only the factorization;
            # refinement applies the factored form in the data dtype)
            Gf_cr, Gf_ch = Gc_cr.to(fdt_), Gc_ch.to(fdt_)
            hbar_cr = (torch.diag_embed(hbar_d_cr.to(fdt_))
                       + torch.einsum("nci,nc,ncj->nij", Gf_cr, gams["crg"].to(fdt_), Gf_cr))
            hbar_ch = (torch.diag_embed(hbar_d_ch.to(fdt_))
                       + torch.einsum("slci,slc,slcj->slij", Gf_ch, gams["chg"].to(fdt_),
                                      Gf_ch))
        else:
            hbar_cr, hbar_ch = hbar_d_cr, hbar_d_ch
        chain_k = opts.chain_backend == "pallas" and fdt == f32
        crown_k = chain_k and not HG
        if chain_k:
            fact_ch, W0ch = rk.ric_chain_factor(hbar_ch.to(f32).contiguous(), AB_ch32,
                                                reg=opts.reg_eps)
        else:
            fact_ch = _chain_riccati_factor(hbar_ch, AB_ch, opts, fdt)
            W0ch = fact_ch["W0"]
        # the chain roots' Riccati terms: the boundary tensor of the
        # scenario decomposition ([S, nz, nz] a factorization)
        Wsum0 = _scatter_rows(shard.gather_s(W0ch), rid, Nc)
        if crown_k:
            fact_cr = crk.crown_ric_factor(hbar_cr.to(f32).contiguous(), AB_cr32, Wsum0,
                                           prep, nxm, reg=opts.reg_eps)
        else:
            Hbar_cr = hbar_cr if hbar_cr.dim() == 3 else torch.diag_embed(hbar_cr)
            fact_cr = _riccati_factor(qp, Hbar_cr, prep, opts, fdt, Wsum0=Wsum0)
        kernels = (chain_k, crown_k)

        def expand_all(dzc, dzh, rm_use):
            return {tag: expand_step(tproj(tag, dzc, dzh), rd[tag], rm_use[tag],
                                     *sec_args(tag)) for tag in TAGS}

        def alpha_of(exp, frac=1.0):
            steps = []
            for tag in TAGS:
                _, _, mlo, mhi = SEC[tag]
                for v, dv, m in ((st["slo_" + tag], exp[tag][0], mlo),
                                 (st["shi_" + tag], exp[tag][1], mhi),
                                 (st["llo_" + tag], exp[tag][2], mlo),
                                 (st["lhi_" + tag], exp[tag][3], mhi)):
                    steps.append(_max_step(v, dv, m, frac))
            a = steps[0]
            for s_ in steps[1:]:
                a = torch.minimum(a, s_)
            return shard.pmin(a)

        def mu_of(stx):
            return sum_split(lambda tag: (
                (stx["slo_" + tag] * stx["llo_" + tag] * SEC[tag][2]).sum()
                + (stx["shi_" + tag] * stx["lhi_" + tag] * SEC[tag][3]).sum())) / n_ineq

        def mu_shifted(exp, a):
            return sum_split(lambda tag: (
                ((st["slo_" + tag] + a * exp[tag][0])
                 * (st["llo_" + tag] + a * exp[tag][2]) * SEC[tag][2]).sum()
                + ((st["shi_" + tag] + a * exp[tag][1])
                   * (st["lhi_" + tag] + a * exp[tag][3]) * SEC[tag][3]).sum())) / n_ineq

        # predictor
        dzc_a, dzh_a, _, _ = solve_kkt(fact_ch, fact_cr, kernels, rhs_cr_a, rhs_ch_a,
                                       rb_cr, rb_ch, hbars)
        exp_a = expand_all(dzc_a, dzh_a, rm)
        a_aff = alpha_of(exp_a)
        mu = mu_of(st)
        mu_aff = mu_shifted(exp_a, a_aff)
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 0.0, 1.0)

        # corrector
        rm_c = {}
        for tag in TAGS:
            _, _, mlo, mhi = SEC[tag]
            rm_c[tag] = (rm[tag][0] + (exp_a[tag][0] * exp_a[tag][2] - sigma * mu) * mlo,
                         rm[tag][1] + (exp_a[tag][1] * exp_a[tag][3] - sigma * mu) * mhi)
        rhs_cr_c, rhs_ch_c, _ = make_rhs(rm_c)
        dzc, dzh, dlc, dlh = solve_kkt(fact_ch, fact_cr, kernels, rhs_cr_c, rhs_ch_c,
                                       rb_cr, rb_ch, hbars)
        exp = expand_all(dzc, dzh, rm_c)
        alpha = alpha_of(exp, tf)

        # NaN guard (cf. ipm_solve): exit as MIN_STEP with the last finite
        # iterate, the direction zeroed too
        ok = ~(torch.isnan(alpha) | torch.isnan(dzc.sum()) | torch.isnan(dzh.sum()))
        ok = shard.all_true(ok)  # the guard must not diverge across ranks
        alpha = torch.where(ok, alpha, 0.0)
        san = lambda v: torch.where(ok, v, 0.0)
        st2 = dict(z_cr=st["z_cr"] + alpha * san(dzc), z_ch=st["z_ch"] + alpha * san(dzh),
                   lam_cr=st["lam_cr"] + alpha * san(dlc) * nrxm,
                   lam_ch=st["lam_ch"] + alpha * san(dlh))
        for tag in TAGS:
            _, _, mlo, mhi = SEC[tag]
            for key, v, m, dflt in (("slo_", exp[tag][0], mlo, 1.0),
                                    ("shi_", exp[tag][1], mhi, 1.0),
                                    ("llo_", exp[tag][2], mlo, 0.0),
                                    ("lhi_", exp[tag][3], mhi, 0.0)):
                st2[key + tag] = torch.where(m > 0, st[key + tag] + alpha * san(v), dflt)
        res4 = res4_of(*residuals(st2))
        failed = (alpha < opts.alpha_min) | ~ok
        flags = torch.stack([res4.max(), failed.to(dt), mu_of(st2)])
        return st2, res4, flags, torch.cat([res4, torch.stack([alpha, mu, sigma])])

    st, it, it_f32, status, res4, _ = _ipm_loop(iteration, st0, opts, dt, dev)

    # --- export (signed fold mu = l_hi - l_lo, hpmpc_tree.c:405-433)
    mu_cr = st["lhi_cr"] - st["llo_cr"]
    mu_ch = st["lhi_ch"] - st["llo_ch"]
    crown_out = dict(x=st["z_cr"][:, :nxm] * xm, u=st["z_cr"][:, nxm:] * um,
                     lam=st["lam_cr"] * nrxm, mu_x=mu_cr[:, :nxm] * xm,
                     mu_u=mu_cr[:, nxm:] * um)
    chain_out = dict(x=st["z_ch"][:, :, :nxm] * xmask_ch,
                     u=st["z_ch"][:, :, nxm:] * umask_ch, lam=st["lam_ch"],
                     mu_x=mu_ch[:, :, :nxm] * xmask_ch, mu_u=mu_ch[:, :, nxm:] * umask_ch)
    if HG:
        crown_out["mu_d"] = (st["lhi_crg"] - st["llo_crg"]) * cm_cr
        chain_out["mu_d"] = (st["lhi_chg"] - st["llo_chg"]) * cm_ch
    info = dict(iter=it, iter_f32=it_f32, status=status, res4=res4)
    if opts.axis_name is not None:
        info["comm"] = shard.summary(it)
    return crown_out, chain_out, info

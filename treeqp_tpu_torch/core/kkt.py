"""KKT residual oracle — the universal correctness check.

Port of ``treeqp_tpu/core/kkt.py`` (reference tree_qp_common.c:540-788),
computed in the data dtype (f64) on the data's device. Every solve of the
port is certified by it.

Conventions (matching the reference exactly):

* stationarity_x = Q x + q + S' u + mu_x + C' mu_d - lam_self + sum_kids A_c' lam_c
* stationarity_u = R u + r + S x + mu_u + D' mu_d + sum_kids B_c' lam_c
* dynamics  = A_c x_parent + B_c u_parent + b_c - x_c          (non-root c)
* bound feasibility = one-sided violation (0 inside the box)
* complementarity   = mu * (z - upper) if mu > 0 else mu * (lower - z)

All terms are masked to the real (unpadded) dims; the reported value is the
max abs over all residual components.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.core.qp_data import TreeQPIn, TreeQPOut

__all__ = ["kkt_residuals", "max_kkt_residual"]


def kkt_residuals(qp: TreeQPIn, out: TreeQPOut) -> dict:
    """Return the per-family KKT residual tensors (masked, padded layout)."""
    topo = qp.topo
    kw = dict(dtype=qp.dtype, device=qp.device)
    xm = torch.as_tensor(topo.x_mask, **kw)
    um = torch.as_tensor(topo.u_mask, **kw)
    cm = torch.as_tensor(topo.c_mask, **kw)
    nrxm = torch.as_tensor(topo.nonroot_x_mask, **kw)
    par = torch.as_tensor(topo.parent_np, dtype=torch.long, device=qp.device)
    par = par.clamp(min=0)  # safe gather index for the root row (masked out)

    x, u, lam = out.x * xm, out.u * um, out.lam * nrxm
    mu_x, mu_u, mu_d = out.mu_x * xm, out.mu_u * um, out.mu_d * cm

    # --- stationarity
    st_x = (torch.einsum("nij,nj->ni", qp.Q, x) + qp.q
            + torch.einsum("nji,nj->ni", qp.S, u)
            + mu_x + torch.einsum("nji,nj->ni", qp.C, mu_d) - lam)
    st_u = (torch.einsum("nij,nj->ni", qp.R, u) + qp.r
            + torch.einsum("nij,nj->ni", qp.S, x)
            + mu_u + torch.einsum("nji,nj->ni", qp.D, mu_d))
    # + sum over children: A_c' lam_c into parent rows
    contrib_x = torch.einsum("nji,nj->ni", qp.A, lam)  # row c: A_c' lam_c
    contrib_u = torch.einsum("nji,nj->ni", qp.B, lam)
    st_x = st_x.index_add(0, par[1:], contrib_x[1:])
    st_u = st_u.index_add(0, par[1:], contrib_u[1:])
    st_x, st_u = st_x * xm, st_u * um

    # --- dynamics feasibility (non-root)
    xp, up = x[par], u[par]
    dyn = (torch.einsum("nij,nj->ni", qp.A, xp)
           + torch.einsum("nij,nj->ni", qp.B, up) + qp.b - x) * nrxm

    # --- bound feasibility / complementarity
    def box(z, lo, hi, mu, mask):
        feas = (torch.clamp(z - hi, min=0.0) + torch.clamp(lo - z, min=0.0)) * mask
        comp = torch.where(mu > 0, mu * (z - hi), mu * (lo - z)) * mask
        return feas, comp

    fx, cx = box(x, qp.xmin, qp.xmax, mu_x, xm)
    fu, cu = box(u, qp.umin, qp.umax, mu_u, um)
    t = (torch.einsum("nij,nj->ni", qp.C, x) + torch.einsum("nij,nj->ni", qp.D, u))
    fd, cd = box(t, qp.dmin, qp.dmax, mu_d, cm)

    return dict(stat_x=st_x, stat_u=st_u, dyn=dyn,
                feas_x=fx, feas_u=fu, feas_d=fd,
                comp_x=cx, comp_u=cu, comp_d=cd)


def max_kkt_residual(qp: TreeQPIn, out: TreeQPOut) -> float:
    """Max-norm KKT residual (``tree_qp_out_max_KKT_res``)."""
    parts = kkt_residuals(qp, out)
    return float(torch.stack([v.abs().max() for v in parts.values()]).max())

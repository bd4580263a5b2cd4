"""Tree interior-point method: its constraint stacking.

Port of ``_constraint_data`` of ``treeqp_tpu/solvers/ipm.py``, which the
general stage-QP solvers of ``solvers/tdunes.py`` (qpgen, mixed) share
with the IPM. The IPM solver itself (``ipm_solve``, with
``ipm_multistage.py`` and ``core/soft.py``) comes in a later slice of the
port, and will find this function where the JAX package has it.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.core.qp_data import TREEQP_INF, TreeQPIn

__all__ = []

_INF_THRESH = 0.5 * TREEQP_INF


def _constraint_data(qp: TreeQPIn):
    """Stack bounds + general constraints: t = G z in [lo, hi], with
    finite-side masks. G rows: [I 0; 0 I; C D] (ng = nxm + num + ncm), the
    identity rows and the C/D rows masked to each node's real dims.
    Returns (G [Nn, ng, nz], lo, hi, m_lo, m_hi [Nn, ng])."""
    topo = qp.topo
    kw = dict(dtype=qp.dtype, device=qp.device)
    Nn, nxm, num, ncm = topo.Nn, topo.nxm, topo.num, topo.ncm
    xm = torch.as_tensor(topo.x_mask, **kw)
    um = torch.as_tensor(topo.u_mask, **kw)
    cm = torch.as_tensor(topo.c_mask, **kw)
    nz = nxm + num
    G = torch.zeros((Nn, nxm + num + ncm, nz), **kw)
    G[:, :nxm, :nxm] = torch.diag_embed(xm)
    G[:, nxm:nz, nxm:] = torch.diag_embed(um)
    G[:, nz:, :nxm] = qp.C * cm[:, :, None]
    G[:, nz:, nxm:] = qp.D * cm[:, :, None]
    lo = torch.cat([qp.xmin, qp.umin, qp.dmin], dim=1)
    hi = torch.cat([qp.xmax, qp.umax, qp.dmax], dim=1)
    rmask = torch.cat([xm, um, cm], dim=1)
    m_lo = (lo > -_INF_THRESH) & (rmask > 0)
    m_hi = (hi < _INF_THRESH) & (rmask > 0)
    return G, lo, hi, m_lo.to(qp.dtype), m_hi.to(qp.dtype)

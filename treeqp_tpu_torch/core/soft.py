"""Soft constraints — the HPIPM engine capability class ``ns``.

Port of ``treeqp_tpu/core/soft.py``. Selected state bounds get slack pairs
(sl, su) >= 0 with quadratic + linear penalties,

    lb - sl <= v <= ub + su,
    cost += 1/2 sl' Zl sl + zl' sl + 1/2 su' Zu su + zu' su,

reduced EXACTLY to a hard tree QP that the IPM solves unchanged: each
softened coordinate's slack pair joins the node's control vector (diagonal
cost, [0, inf) bounds, zero columns in the dynamics B), and the softened
bound rows move from the box to one-sided general rows lb <= v + sl and
v - su <= ub. ``soften_bounds`` builds the augmented ``TreeQPIn``;
``recover_soft`` maps an augmented solution back to the original layout
(plus the slack values and the soft-bound multipliers). The augmentation
is host-side work in numpy f64; the result lands on the input's device
and dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TREEQP_INF, TreeQPIn, TreeQPOut
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["soften_bounds", "recover_soft", "SoftMap"]


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy().astype(np.float64)


@dataclasses.dataclass(frozen=True)
class SoftMap:
    """Mapping from the augmented hard QP back to the soft-QP layout."""

    topo: TreeStructure          # original topology
    aug_topo: TreeStructure
    soft_x: tuple                # per node: tuple of softened x coordinates
    nu_orig: tuple


def soften_bounds(qp: TreeQPIn, soft_x, Zl, Zu, zl=0.0, zu=0.0):
    """Return ``(qp_aug, SoftMap)`` with the listed state bounds softened.

    ``soft_x``: per-node iterable of x-coordinate indices whose box bounds
    become soft (both sides; a one-sided infinite bound leaves its slack
    unused). ``Zl/Zu/zl/zu``: scalar penalty coefficients.
    """
    topo = qp.topo
    Nn = topo.Nn
    soft_x = tuple(tuple(int(i) for i in soft_x[n]) for n in range(Nn))
    ns = [len(s) for s in soft_x]
    nu2 = tuple(topo.nu[n] + 2 * ns[n] for n in range(Nn))
    nc2 = tuple(topo.nc[n] + 2 * ns[n] for n in range(Nn))
    topo2 = TreeStructure.from_parent(topo.parent, topo.nx, nu2, nc2)
    num2, ncm2, nxm = topo2.num, topo2.ncm, topo.nxm

    R = np.zeros((Nn, num2, num2))
    S = np.zeros((Nn, num2, nxm))
    r = np.zeros((Nn, num2))
    umin = np.full((Nn, num2), -TREEQP_INF)
    umax = np.full((Nn, num2), TREEQP_INF)
    C = np.zeros((Nn, ncm2, nxm))
    D = np.zeros((Nn, ncm2, num2))
    dmin = np.full((Nn, ncm2), -TREEQP_INF)
    dmax = np.full((Nn, ncm2), TREEQP_INF)
    xmin, xmax = _np(qp.xmin).copy(), _np(qp.xmax).copy()
    B = np.zeros((Nn, nxm, num2))

    R0, S0, r0 = _np(qp.R), _np(qp.S), _np(qp.r)
    um0, uM0 = _np(qp.umin), _np(qp.umax)
    C0, D0 = _np(qp.C), _np(qp.D)
    dm0, dM0 = _np(qp.dmin), _np(qp.dmax)
    B0 = _np(qp.B)

    for n in range(Nn):
        nu0, nc0 = topo.nu[n], topo.nc[n]
        R[n, :nu0, :nu0] = R0[n, :nu0, :nu0]
        S[n, :nu0] = S0[n, :nu0]
        r[n, :nu0] = r0[n, :nu0]
        umin[n, :nu0] = um0[n, :nu0]
        umax[n, :nu0] = uM0[n, :nu0]
        C[n, :nc0] = C0[n, :nc0]
        D[n, :nc0, :nu0] = D0[n, :nc0, :nu0]
        dmin[n, :nc0] = dm0[n, :nc0]
        dmax[n, :nc0] = dM0[n, :nc0]
        if n > 0:
            # edge INTO node n: its columns index the PARENT's controls,
            # which keep their leading positions (slacks come after them)
            nu_p = topo.nu[topo.parent[n]]
            B[n, :, :nu_p] = B0[n, :, :nu_p]
        for j, i in enumerate(soft_x[n]):
            isl, isu = nu0 + 2 * j, nu0 + 2 * j + 1  # slacks sl, su of coordinate i
            R[n, isl, isl] = Zl
            R[n, isu, isu] = Zu
            r[n, isl] = zl
            r[n, isu] = zu
            umin[n, isl] = 0.0
            umin[n, isu] = 0.0
            # general rows: xmin_i <= x_i + sl  ;  x_i - su <= xmax_i
            rl, ru = nc0 + 2 * j, nc0 + 2 * j + 1
            C[n, rl, i] = 1.0
            D[n, rl, isl] = 1.0
            dmin[n, rl] = xmin[n, i]
            C[n, ru, i] = 1.0
            D[n, ru, isu] = -1.0
            dmax[n, ru] = xmax[n, i]
            # the hard box row is released
            xmin[n, i] = -TREEQP_INF
            xmax[n, i] = TREEQP_INF

    t = lambda a: torch.as_tensor(a, dtype=qp.dtype, device=qp.device)
    qp2 = qp.replace(R=t(R), S=t(S), r=t(r), xmin=t(xmin), xmax=t(xmax),
                     umin=t(umin), umax=t(umax), C=t(C), D=t(D), dmin=t(dmin),
                     dmax=t(dmax), B=t(B), topo=topo2)
    return qp2, SoftMap(topo=topo, aug_topo=topo2, soft_x=soft_x,
                        nu_orig=tuple(topo.nu))


def recover_soft(out: TreeQPOut, m: SoftMap):
    """Map an augmented-QP solution back to the original layout.

    Returns ``(out_orig, slacks)``: a TreeQPOut on the original topology
    (u truncated to the original controls; a soft coordinate's mu_x is the
    signed fold of its two general-row multipliers, so complementarity
    reads as for the soft bound) and ``slacks[n] = ((sl, su), ...)`` per
    softened coordinate."""
    topo = m.topo
    Nn, num = topo.Nn, topo.num
    u2, mu_u2, mu_d2 = _np(out.u), _np(out.mu_u), _np(out.mu_d)
    mu_x = _np(out.mu_x).copy()

    u = np.zeros((Nn, num))
    mu_u = np.zeros((Nn, num))
    mu_d = np.zeros((Nn, topo.ncm))
    slacks = []
    for n in range(Nn):
        nu0, nc0 = m.nu_orig[n], topo.nc[n]
        u[n, :nu0] = u2[n, :nu0]
        mu_u[n, :nu0] = mu_u2[n, :nu0]
        mu_d[n, :nc0] = mu_d2[n, :nc0]
        ssl = []
        for j, i in enumerate(m.soft_x[n]):
            isl, isu = nu0 + 2 * j, nu0 + 2 * j + 1
            rl, ru = nc0 + 2 * j, nc0 + 2 * j + 1
            ssl.append((float(u2[n, isl]), float(u2[n, isu])))
            # signed fold of the two one-sided soft rows (lower row active:
            # negative multiplier, as for hard boxes)
            mu_x[n, i] = mu_d2[n, rl] + mu_d2[n, ru]
        slacks.append(tuple(ssl))

    t = lambda a: torch.as_tensor(a, dtype=out.x.dtype, device=out.x.device)
    out2 = TreeQPOut(x=out.x, u=t(u), lam=out.lam, mu_x=t(mu_x), mu_u=t(mu_u),
                     mu_d=t(mu_d), info=out.info)
    return out2, tuple(slacks)

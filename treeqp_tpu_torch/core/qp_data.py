"""Tree QP data containers (the ``tree_qp_in`` / ``tree_qp_out`` equivalents).

Port of ``treeqp_tpu/core/qp_data.py``: the same stacked, zero-padded
``[Nn, nxm, ...]`` layout, one tensor per field, with the static topology
(``TreeStructure``) carried beside the tensors. The LTV batch setters and
``eliminate_x0`` are not ported yet.

The QP solved (tree_qp_common.h:85-116)::

    min   sum_n 1/2 [x_n;u_n]' [Q_n S_n'; S_n R_n] [x_n;u_n] + [q_n;r_n]'[x_n;u_n]
    s.t.  x_n = A_n x_{p(n)} + B_n u_{p(n)} + b_n          (edge into node n, n>0)
          xmin_n <= x_n <= xmax_n,  umin_n <= u_n <= umax_n
          dmin_n <= C_n x_n + D_n u_n <= dmax_n

Edge arrays are indexed by the child node ``n`` with row 0 unused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.utils.tree import TreeStructure

# Infinity convention of the reference (utils/types.h:37)
TREEQP_INF = 1e12

__all__ = ["TreeQPIn", "TreeQPOut", "TREEQP_INF", "QP_FIELDS", "OUT_FIELDS"]

QP_FIELDS = ("Q", "R", "S", "q", "r", "xmin", "xmax", "umin", "umax",
             "C", "D", "dmin", "dmax", "A", "B", "b")
OUT_FIELDS = ("x", "u", "lam", "mu_x", "mu_u", "mu_d")


@dataclasses.dataclass(frozen=True)
class TreeQPIn:
    """Tree QP problem data. Equivalent of ``tree_qp_in`` (tree_qp_common.h:85-116)."""

    # node data, padded to [Nn, nxm/num/ncm, ...]
    Q: torch.Tensor
    R: torch.Tensor
    S: torch.Tensor  # [Nn, num, nxm]
    q: torch.Tensor
    r: torch.Tensor
    xmin: torch.Tensor
    xmax: torch.Tensor
    umin: torch.Tensor
    umax: torch.Tensor
    C: torch.Tensor  # [Nn, ncm, nxm]
    D: torch.Tensor  # [Nn, ncm, num]
    dmin: torch.Tensor
    dmax: torch.Tensor
    # edge data, indexed by CHILD node (row 0 zero): x_n = A_n x_p + B_n u_p + b_n
    A: torch.Tensor  # [Nn, nxm, nxm]
    B: torch.Tensor  # [Nn, nxm, num]
    b: torch.Tensor  # [Nn, nxm]
    topo: TreeStructure

    def replace(self, **kw) -> "TreeQPIn":
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.Q.dtype

    @property
    def device(self) -> torch.device:
        return self.Q.device

    def to(self, device=None, dtype=None) -> "TreeQPIn":
        """Every field moved to ``device`` and/or cast to ``dtype``."""
        return self.replace(**{f: getattr(self, f).to(device=device, dtype=dtype)
                               for f in QP_FIELDS})

    @classmethod
    def zeros(cls, topo: TreeStructure, dtype=torch.float64,
              device="cuda") -> "TreeQPIn":
        """The empty QP of ``topo`` (zero data, +-TREEQP_INF bounds), on
        ``device``: the card unless the caller passes ``device="cpu"``, as
        for every data constructor of the port."""
        Nn, nxm, num, ncm = topo.Nn, topo.nxm, topo.num, topo.ncm
        kw = dict(dtype=dtype, device=device)
        z = lambda *s: torch.zeros(s, **kw)
        f = lambda v, *s: torch.full(s, v, **kw)
        inf = TREEQP_INF
        return cls(
            Q=z(Nn, nxm, nxm), R=z(Nn, num, num), S=z(Nn, num, nxm),
            q=z(Nn, nxm), r=z(Nn, num),
            xmin=f(-inf, Nn, nxm), xmax=f(inf, Nn, nxm),
            umin=f(-inf, Nn, num), umax=f(inf, Nn, num),
            C=z(Nn, ncm, nxm), D=z(Nn, ncm, num),
            dmin=f(-inf, Nn, ncm), dmax=f(inf, Nn, ncm),
            A=z(Nn, nxm, nxm), B=z(Nn, nxm, num), b=z(Nn, nxm),
            topo=topo,
        )

    @classmethod
    def from_node_edge_lists(cls, topo: TreeStructure, nodes: list,
                             edges_by_child: dict, dtype=torch.float64,
                             device="cuda") -> "TreeQPIn":
        """Build from per-node dicts of (unpadded) numpy arrays.

        ``nodes[i]`` may contain Q, R, S, q, r, xmin, xmax, umin, umax,
        C, D, dmin, dmax. ``edges_by_child[c]`` contains A, B, b of the edge
        into node c. Missing bounds default to +-TREEQP_INF; missing matrices
        to zero. Equivalent to the ~60 setters of tree_qp_common.c:874-2427.
        """
        Nn, nxm, num, ncm = topo.Nn, topo.nxm, topo.num, topo.ncm
        nx, nu, nc = topo.nx, topo.nu, topo.nc

        def alloc(shape, fill=0.0):
            return np.full(shape, fill, dtype=np.float64)

        F = dict(
            Q=alloc((Nn, nxm, nxm)), R=alloc((Nn, num, num)), S=alloc((Nn, num, nxm)),
            q=alloc((Nn, nxm)), r=alloc((Nn, num)),
            xmin=alloc((Nn, nxm), -TREEQP_INF), xmax=alloc((Nn, nxm), TREEQP_INF),
            umin=alloc((Nn, num), -TREEQP_INF), umax=alloc((Nn, num), TREEQP_INF),
            C=alloc((Nn, ncm, nxm)), D=alloc((Nn, ncm, num)),
            dmin=alloc((Nn, ncm), -TREEQP_INF), dmax=alloc((Nn, ncm), TREEQP_INF),
            A=alloc((Nn, nxm, nxm)), B=alloc((Nn, nxm, num)), b=alloc((Nn, nxm)),
        )
        shapes = dict(
            Q=lambda i: (nx[i], nx[i]), R=lambda i: (nu[i], nu[i]), S=lambda i: (nu[i], nx[i]),
            q=lambda i: (nx[i],), r=lambda i: (nu[i],),
            xmin=lambda i: (nx[i],), xmax=lambda i: (nx[i],),
            umin=lambda i: (nu[i],), umax=lambda i: (nu[i],),
            C=lambda i: (nc[i], nx[i]), D=lambda i: (nc[i], nu[i]),
            dmin=lambda i: (nc[i],), dmax=lambda i: (nc[i],),
        )
        for i, nd in enumerate(nodes):
            for k, v in nd.items():
                if k not in F:
                    continue
                v = np.asarray(v, dtype=np.float64).reshape(shapes[k](i))
                sl = tuple(slice(0, s) for s in v.shape)
                F[k][(i,) + sl] = v
        for c, ed in edges_by_child.items():
            p = topo.parent[c]
            F["A"][c, : nx[c], : nx[p]] = np.asarray(ed["A"], np.float64).reshape(nx[c], nx[p])
            F["B"][c, : nx[c], : nu[p]] = np.asarray(ed["B"], np.float64).reshape(nx[c], nu[p])
            F["b"][c, : nx[c]] = np.asarray(ed["b"], np.float64).reshape(nx[c])
        return cls(**{k: torch.as_tensor(v, dtype=dtype, device=device)
                      for k, v in F.items()}, topo=topo)

    @classmethod
    def lti_diag_weights(cls, topo: TreeStructure, A, B, b, dQ, dq, dP, dp, dR, dr,
                         xmin, xmax, umin, umax, x0=None, scale_by_stage=True,
                         dtype=torch.float64, device="cuda") -> "TreeQPIn":
        """LTI scenario-tree fill, mirroring ``tree_qp_in_fill_lti_data_diag_weights``
        (tree_qp_common.c:1837-1950).

        ``A/B/b`` are stacked realizations ``[md, nx, nx]`` etc.; the edge into
        node c uses realization ``topo.realization[c]``. Non-leaf nodes get
        diag(dQ)/diag(dR) weights, leaves diag(dP). When ``scale_by_stage``,
        objectives are scaled by num_leaves/nodes_in_stage (probability
        weighting, tree_qp_common.c:1909-1928). ``x0`` is embedded as equality
        bounds at the root.
        """
        A = np.asarray(A, dtype=np.float64)
        B = np.asarray(B, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        nodes = []
        stage = topo.stage
        n_in_stage = np.bincount(stage, minlength=topo.Nh + 1)
        num_leaves = int(np.sum(topo.nkids == 0))
        for i in range(topo.Nn):
            leaf = topo.nkids[i] == 0
            sf = (num_leaves / n_in_stage[stage[i]]) if scale_by_stage else 1.0
            nd = dict(
                Q=np.diag(np.asarray(dP if leaf else dQ, dtype=np.float64)) * sf,
                q=np.asarray(dp if leaf else dq, dtype=np.float64) * sf,
                xmin=xmin, xmax=xmax,
            )
            if topo.nu[i] > 0:
                nd.update(R=np.diag(np.asarray(dR, dtype=np.float64)) * sf,
                          r=np.asarray(dr, dtype=np.float64) * sf,
                          umin=umin, umax=umax)
            if i == 0 and x0 is not None:
                nd.update(xmin=x0, xmax=x0)
            nodes.append(nd)
        edges = {}
        for c in range(1, topo.Nn):
            re = int(topo.realization[c])
            edges[c] = dict(A=A[re], B=B[re], b=b[re])
        return cls.from_node_edge_lists(topo, nodes, edges, dtype=dtype,
                                        device=device)


@dataclasses.dataclass(frozen=True)
class TreeQPOut:
    """Tree QP solution. Equivalent of ``tree_qp_out`` (tree_qp_common.h:119-131).

    ``lam`` is the multiplier of the dynamics constraint of the edge INTO each
    node (row 0 zero). ``mu_x/mu_u/mu_d`` are signed bound multipliers
    (positive = upper bound active), matching the reference convention in
    tree_qp_out_calculate_KKT_res (tree_qp_common.c:540-765).
    """

    x: torch.Tensor  # [Nn, nxm]
    u: torch.Tensor  # [Nn, num]
    lam: torch.Tensor  # [Nn, nxm]
    mu_x: torch.Tensor  # [Nn, nxm]
    mu_u: torch.Tensor  # [Nn, num]
    mu_d: torch.Tensor  # [Nn, ncm]
    info: dict  # iter, status, error ... (Python scalars)

    def replace(self, **kw) -> "TreeQPOut":
        return dataclasses.replace(self, **kw)

"""Tree QP data containers (the ``tree_qp_in`` / ``tree_qp_out`` equivalents).

Port of ``treeqp_tpu/core/qp_data.py``: the same stacked, zero-padded
``[Nn, nxm, ...]`` layout, one tensor per field, with the static topology
(``TreeStructure``) carried beside the tensors; with the LTV batch setters,
``set_x0``, ``eliminate_x0`` and ``EliminatedTreeQP``, the MPC re-embedding
of a new root state into the x0-eliminated problem.

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

__all__ = ["TreeQPIn", "TreeQPOut", "EliminatedTreeQP", "TREEQP_INF", "QP_FIELDS",
           "OUT_FIELDS"]

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

    # ----------------------------------------------------- LTV batch setters
    # Reference tree_qp_in_set_ltv_* (tree_qp_common.c:1953-2153): flat
    # concatenated per-edge / per-node arrays (variable dims), unpacked in
    # node order. Each setter gathers the flat values into the padded layout
    # by index arrays built on the host, with one scatter on the QP's device.

    def _from_flat(self, shape, fill, pieces, flat):
        """A [Nn, ...] tensor of ``shape`` holding ``fill`` except at the
        flat destination indices of ``pieces`` ([(dst, src), ...]), which
        take ``flat[src]``; in f64, then cast to the QP's dtype."""
        flat = torch.as_tensor(flat, dtype=torch.float64, device=self.device).reshape(-1)
        dst = np.concatenate([d.ravel() for d, _ in pieces] + [np.zeros(0, np.int64)])
        src = np.concatenate([s.ravel() for _, s in pieces] + [np.zeros(0, np.int64)])
        if src.size != flat.numel():
            raise ValueError(f"flat input of length {flat.numel()}, the topology takes "
                             f"{src.size}")
        out = torch.full((int(np.prod(shape)),), fill, dtype=torch.float64,
                         device=self.device)
        idx = lambda a: torch.as_tensor(a, dtype=torch.long, device=self.device)
        out[idx(dst)] = flat[idx(src)]
        return out.reshape(shape).to(self.dtype)

    def set_ltv_dynamics(self, A_flat, B_flat, b_flat) -> "TreeQPIn":
        """``tree_qp_in_set_ltv_dynamics_colmajor``: A/B/b of every edge,
        flat-concatenated in child-node order 1..Nn-1 (column-major per
        matrix, matching the reference). Numpy arrays or tensors."""
        topo = self.topo
        Nn, nxm, num, nx, nu = topo.Nn, topo.nxm, topo.num, topo.nx, topo.nu
        pa, pb, pv = [], [], []
        ia = ib = iv = 0
        for c in range(1, Nn):
            p = topo.parent[c]
            m = nx[c]
            for pieces, off, ncol, ld in ((pa, ia, nx[p], nxm), (pb, ib, nu[p], num)):
                i, k = np.meshgrid(np.arange(m), np.arange(ncol), indexing="ij")
                pieces.append(((c * nxm + i) * ld + k, off + k * m + i))
            pv.append((c * nxm + np.arange(m), iv + np.arange(m)))
            ia, ib, iv = ia + m * nx[p], ib + m * nu[p], iv + m
        return self.replace(A=self._from_flat((Nn, nxm, nxm), 0.0, pa, A_flat),
                            B=self._from_flat((Nn, nxm, num), 0.0, pb, B_flat),
                            b=self._from_flat((Nn, nxm), 0.0, pv, b_flat))

    def set_ltv_objective_diag(self, Qd_flat, Rd_flat, q_flat, r_flat) -> "TreeQPIn":
        """``tree_qp_in_set_ltv_objective_diag``: diagonal weights + linear
        terms of every node, flat-concatenated in node order (S zeroed)."""
        topo = self.topo
        Nn, nxm, num = topo.Nn, topo.nxm, topo.num
        dq, dr, vq, vr = [], [], [], []
        iq = ir = 0
        for i in range(Nn):
            a, b = np.arange(topo.nx[i]), np.arange(topo.nu[i])
            dq.append(((i * nxm + a) * nxm + a, iq + a))
            vq.append((i * nxm + a, iq + a))
            dr.append(((i * num + b) * num + b, ir + b))
            vr.append((i * num + b, ir + b))
            iq, ir = iq + a.size, ir + b.size
        return self.replace(Q=self._from_flat((Nn, nxm, nxm), 0.0, dq, Qd_flat),
                            R=self._from_flat((Nn, num, num), 0.0, dr, Rd_flat),
                            S=torch.zeros_like(self.S),
                            q=self._from_flat((Nn, nxm), 0.0, vq, q_flat),
                            r=self._from_flat((Nn, num), 0.0, vr, r_flat))

    def set_ltv_bounds(self, xmin_flat, xmax_flat, umin_flat, umax_flat) -> "TreeQPIn":
        """Batch bound setter in node order (flat-concatenated, variable
        dims), cf. tree_qp_in_set_node_bounds applied node by node; entries
        past each node's dims are +-TREEQP_INF."""
        topo = self.topo
        Nn, nxm, num = topo.Nn, topo.nxm, topo.num
        px, pu = [], []
        ix = iu = 0
        for i in range(Nn):
            a, b = np.arange(topo.nx[i]), np.arange(topo.nu[i])
            px.append((i * nxm + a, ix + a))
            pu.append((i * num + b, iu + b))
            ix, iu = ix + a.size, iu + b.size
        inf = TREEQP_INF
        return self.replace(xmin=self._from_flat((Nn, nxm), -inf, px, xmin_flat),
                            xmax=self._from_flat((Nn, nxm), inf, px, xmax_flat),
                            umin=self._from_flat((Nn, num), -inf, pu, umin_flat),
                            umax=self._from_flat((Nn, num), inf, pu, umax_flat))

    # --------------------------------------------------------- MPC utilities

    def set_x0(self, x0) -> "TreeQPIn":
        """Embed the current state as equality bounds on the root
        (tree_qp_in_set_x0_* semantics, tree_qp_common.c:2154-2237)."""
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device)
        nx0 = self.topo.nx[0]
        x0p = torch.zeros((self.topo.nxm,), dtype=self.dtype, device=self.device)
        x0p[:nx0] = x0[:nx0]
        mask = torch.as_tensor(self.topo.x_mask[0], dtype=self.dtype, device=self.device)
        xmin, xmax = self.xmin.clone(), self.xmax.clone()
        xmin[0] = x0p * mask - TREEQP_INF * (1 - mask)
        xmax[0] = x0p * mask + TREEQP_INF * (1 - mask)
        return self.replace(xmin=xmin, xmax=xmax)

    def eliminate_x0(self, keep_originals: bool = False):
        """Fold a fixed root state into the data, shrinking node 0 to nx=0.

        Mirrors ``tree_qp_in_eliminate_x0`` (tree_qp_common.c:404-525): with
        x0 fixed (xmin[0]==xmax[0]), fold A_c x0 into b_c for each child c of
        the root, S_0 x0 into r_0, and C_0 x0 into the root's d bounds; zero
        Q_0, q_0, S_0, C_0 and the A of the edges out of the root. Returns a
        new TreeQPIn of the same padded shapes on a topology with nx[0] = 0
        (the root's x bounds stay, outside that topology).

        ``keep_originals=True`` instead returns an :class:`EliminatedTreeQP`
        holding the pre-elimination data, so the eliminated problem takes a
        NEW x0 every MPC step through ``.set_x0`` without rebuilding: the
        reference's qp_internal_t pattern (tree_qp_common.c:2154-2237).
        """
        topo = self.topo
        x0 = self.xmin[0] * torch.as_tensor(topo.x_mask[0], dtype=self.dtype,
                                            device=self.device)
        new_topo = TreeStructure.from_parent(topo.parent, (0,) + topo.nx[1:], topo.nu,
                                             topo.nc)
        kids0 = tuple(int(k) for k in topo.kids[0])
        idx = torch.as_tensor(kids0, dtype=torch.long, device=self.device)
        # the originals of the folded fields; EliminatedTreeQP.set_x0 folds x0 in
        f = {k: getattr(self, k).clone() for k in ("A", "S", "C", "Q", "q")}
        f["A"][idx] = 0.0
        for k in ("S", "C", "Q", "q"):
            f[k][0] = 0.0
        elim = EliminatedTreeQP(
            qp=self.replace(topo=new_topo, **f), A0=self.A[idx], b0=self.b[idx],
            S0=self.S[0], r0=self.r[0], C0=self.C[0], dmin0=self.dmin[0],
            dmax0=self.dmax[0], kids0=kids0).set_x0(x0)
        return elim if keep_originals else elim.qp


@dataclasses.dataclass(frozen=True)
class EliminatedTreeQP:
    """An x0-eliminated tree QP that can be re-embedded with a new x0 every
    MPC step (the reference's qp_internal_t pattern: originals are kept so
    ``tree_qp_in_set_x0_strvec`` works on the eliminated problem,
    tree_qp_common.h:58-80, tree_qp_common.c:2154-2237)."""

    qp: TreeQPIn          # the eliminated problem (nx[0] = 0 topology)
    A0: torch.Tensor      # original A of the edges out of the root [K0, nxm, nxm]
    b0: torch.Tensor      # original b of those edges [K0, nxm]
    S0: torch.Tensor      # original root S [num, nxm]
    r0: torch.Tensor      # original root r [num]
    C0: torch.Tensor      # original root C [ncm, nxm]
    dmin0: torch.Tensor
    dmax0: torch.Tensor
    kids0: tuple          # the root's children

    def set_x0(self, x0) -> "EliminatedTreeQP":
        """Re-embed a new root state into the eliminated data: only the
        folded fields (b of the root's children, r_0, the root's d bounds)
        are rewritten, on the QP's device."""
        qp = self.qp
        x0 = torch.as_tensor(x0, dtype=qp.dtype, device=qp.device)
        x0p = torch.zeros((qp.topo.nxm,), dtype=qp.dtype, device=qp.device)
        x0p[:x0.shape[0]] = x0
        kids0 = torch.as_tensor(self.kids0, dtype=torch.long, device=qp.device)
        b, r, dmin, dmax = qp.b.clone(), qp.r.clone(), qp.dmin.clone(), qp.dmax.clone()
        b[kids0] = self.b0 + torch.einsum("kij,j->ki", self.A0, x0p)
        r[0] = self.r0 + self.S0 @ x0p
        cshift = self.C0 @ x0p
        dmin[0] = self.dmin0 - cshift
        dmax[0] = self.dmax0 - cshift
        return dataclasses.replace(self, qp=qp.replace(b=b, r=r, dmin=dmin, dmax=dmax))


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

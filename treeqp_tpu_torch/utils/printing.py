"""Pretty printers and txt I/O (reference treeqp/utils/print.{h,c} and
utils.{h,c}: tree_qp_in_print, tree_qp_out_print, tree_qp_out_write_to_txt,
read/write_double_vector_from/to_txt).

Port of ``treeqp_tpu/utils/printing.py``, with the same text: it reads
tensors on either device (each field copied to the host once a call)."""

from __future__ import annotations

import numpy as np

from treeqp_tpu_torch.convert import _np
from treeqp_tpu_torch.core.qp_data import QP_FIELDS

__all__ = ["tree_qp_in_print", "tree_qp_out_print", "write_vector_txt",
           "read_vector_txt", "tree_qp_out_write_txt"]


def _fmt(a):
    return np.array2string(np.asarray(a), precision=6, suppress_small=True)


def tree_qp_in_print(qp, nodes=None, file=None):
    """Per-node dump of the QP data (print.c tree_qp_in_print)."""
    topo = qp.topo
    nodes = range(topo.Nn) if nodes is None else nodes
    h = {f: _np(getattr(qp, f)) for f in QP_FIELDS}
    p = lambda *a: print(*a, file=file)
    p(f"tree QP: Nn={topo.Nn} Nh={topo.Nh} dims nx={topo.nx[:8]}... "
      f"nu={topo.nu[:8]}... nc={topo.nc[:8]}...")
    for i in nodes:
        nx, nu, nc = topo.nx[i], topo.nu[i], topo.nc[i]
        p(f"--- node {i} (parent {topo.parent[i]}, stage {topo.stage[i]}, "
          f"nx={nx} nu={nu} nc={nc})")
        p("Q =", _fmt(h["Q"][i, :nx, :nx]))
        if nu:
            p("R =", _fmt(h["R"][i, :nu, :nu]))
            p("S =", _fmt(h["S"][i, :nu, :nx]))
        p("q =", _fmt(h["q"][i, :nx]))
        if nu:
            p("r =", _fmt(h["r"][i, :nu]))
        p("xmin =", _fmt(h["xmin"][i, :nx]), " xmax =", _fmt(h["xmax"][i, :nx]))
        if nu:
            p("umin =", _fmt(h["umin"][i, :nu]), " umax =", _fmt(h["umax"][i, :nu]))
        if nc:
            p("C =", _fmt(h["C"][i, :nc, :nx]), " D =", _fmt(h["D"][i, :nc, :nu]))
            p("dmin =", _fmt(h["dmin"][i, :nc]), " dmax =", _fmt(h["dmax"][i, :nc]))
        if i > 0:
            pnx = topo.nx[topo.parent[i]]
            pnu = topo.nu[topo.parent[i]]
            p("A =", _fmt(h["A"][i, :nx, :pnx]))
            p("B =", _fmt(h["B"][i, :nx, :pnu]))
            p("b =", _fmt(h["b"][i, :nx]))


def tree_qp_out_print(topo, out, nodes=None, file=None):
    """Per-node solution dump (print.c tree_qp_out_print)."""
    nodes = range(topo.Nn) if nodes is None else nodes
    p = lambda *a: print(*a, file=file)
    info = out.info  # Python scalars in the port's solver outputs
    h = {f: _np(getattr(out, f)) for f in ("x", "u", "lam", "mu_x", "mu_u")}
    p(f"solution: iter={info.get('iter')} status={info.get('status')}")
    for i in nodes:
        nx, nu = topo.nx[i], topo.nu[i]
        p(f"node {i}: x = {_fmt(h['x'][i, :nx])}  u = {_fmt(h['u'][i, :nu])}")
        p(f"        lam = {_fmt(h['lam'][i, :nx])}  mu_x = {_fmt(h['mu_x'][i, :nx])}"
          f"  mu_u = {_fmt(h['mu_u'][i, :nu])}")


def write_vector_txt(v, path):
    np.savetxt(path, _np(v).reshape(-1))


def read_vector_txt(path):
    return np.loadtxt(path).reshape(-1)


def tree_qp_out_write_txt(topo, out, prefix):
    """Txt export of the solution (print.c tree_qp_out_write_to_txt):
    x/u/lam/mu stacked in node order, real dims only."""
    x, u, lam = _np(out.x), _np(out.u), _np(out.lam)
    xs, us, lams = [], [], []
    for i in range(topo.Nn):
        xs.append(x[i, : topo.nx[i]])
        us.append(u[i, : topo.nu[i]])
        if i > 0:
            lams.append(lam[i, : topo.nx[i]])
    write_vector_txt(np.concatenate(xs), f"{prefix}_x.txt")
    write_vector_txt(np.concatenate(us) if us else np.zeros(0), f"{prefix}_u.txt")
    write_vector_txt(np.concatenate(lams) if lams else np.zeros(0), f"{prefix}_lam.txt")

"""JSON I/O compatible with the reference datasets and front-end.

Port of ``treeqp_tpu/core/json_io.py``: the same schema to the letter.
Reads/writes the QP format of ``examples/solve_qp_json.cpp`` (reference
:206-320 for the input schema, ``qpSolutionToJson`` :109-160 for the output)
and its datasets ``examples/random_qp_utils/data0*.json``.

Schema: ``nodes[]`` with Q,R,S,q,r and optional lx,ux,lu,uu,C,D,ld,ud,
xopt,uopt; ``edges[]`` with A,B,b,from,to. Dims: nx = len(q), nu = len(r),
nc = len(ld). Scalars stand in for 1-vectors; matrices with one row/col are
flat lists; general matrices are nested row-major lists
(``readColMajorMatrix``, solve_qp_json.cpp:92-107).

The loaders build the port's ``TreeQPIn`` on ``device`` (the card unless
the caller passes ``device="cpu"``); the writers read tensors on either
device, each field copied to the host once.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from treeqp_tpu_torch.convert import _np
from treeqp_tpu_torch.core.qp_data import QP_FIELDS, TreeQPIn
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["load_tree_qp_json", "load_tree_qp_file", "solution_to_json",
           "tree_qp_to_json"]


def _vec(js, n) -> np.ndarray:
    if n == 0:
        return np.zeros((0,))
    if n == 1 and not isinstance(js, list):
        return np.array([float(js)])
    return np.asarray(js, dtype=np.float64).reshape(n)


def _mat(js, m, n) -> np.ndarray:
    if m == 0 or n == 0:
        return np.zeros((m, n))
    if m == 1:
        return _vec(js, n).reshape(1, n)
    if n == 1:
        return _vec(js, m).reshape(m, 1)
    return np.asarray(js, dtype=np.float64).reshape(m, n)


def _size(js) -> int:
    if isinstance(js, list):
        return len(js)
    return 1  # scalar counts as size-1, matching nlohmann .size()


def _size_nonempty(js) -> bool:
    if js is None:
        return False
    if isinstance(js, list) and len(js) == 0:
        return False
    return True


def load_tree_qp_json(j: dict, device="cuda", dtype=torch.float64):
    """Parse a reference-format QP dict.

    Returns ``(qp_in, extras)`` where extras holds the embedded reference
    solution (``xopt``/``uopt`` stacked padded numpy arrays) and options,
    if present. ``qp_in`` is made on ``device`` in ``dtype``.
    """
    nodes, edges = j["nodes"], j["edges"]
    Nn = len(nodes)
    nx = [_size(nd["q"]) for nd in nodes]
    nu = [_size(nd["r"]) if _size_nonempty(nd.get("r")) else 0 for nd in nodes]
    nc = [_size(nd["ld"]) if _size_nonempty(nd.get("ld")) else 0 for nd in nodes]

    parent = [-1] * Nn
    for e in edges:
        parent[int(e["to"])] = int(e["from"])
    topo = TreeStructure.from_parent(parent, nx, nu, nc)

    node_dicts = []
    for i, nd in enumerate(nodes):
        d = dict(
            Q=_mat(nd["Q"], nx[i], nx[i]),
            R=_mat(nd.get("R", []), nu[i], nu[i]),
            S=_mat(nd.get("S", []), nu[i], nx[i]),
            q=_vec(nd["q"], nx[i]),
            r=_vec(nd.get("r", []), nu[i]),
        )
        for src, dst, n in (("lx", "xmin", nx[i]), ("ux", "xmax", nx[i]),
                            ("lu", "umin", nu[i]), ("uu", "umax", nu[i]),
                            ("ld", "dmin", nc[i]), ("ud", "dmax", nc[i])):
            if _size_nonempty(nd.get(src)):
                d[dst] = _vec(nd[src], n)
        if nc[i] > 0:
            d["C"] = _mat(nd.get("C", []), nc[i], nx[i])
            d["D"] = _mat(nd.get("D", []), nc[i], nu[i])
        node_dicts.append(d)

    edge_dicts = {}
    for e in edges:
        c, p = int(e["to"]), int(e["from"])
        edge_dicts[c] = dict(A=_mat(e["A"], nx[c], nx[p]),
                             B=_mat(e["B"], nx[c], nu[p]),
                             b=_vec(e["b"], nx[c]))

    qp_in = TreeQPIn.from_node_edge_lists(topo, node_dicts, edge_dicts,
                                          dtype=dtype, device=device)

    extras = {}
    if all("xopt" in nd for nd in nodes):
        xopt = np.zeros((Nn, topo.nxm))
        uopt = np.zeros((Nn, topo.num))
        for i, nd in enumerate(nodes):
            xopt[i, : nx[i]] = _vec(nd["xopt"], nx[i])
            uopt[i, : nu[i]] = _vec(nd.get("uopt", []), nu[i])
        extras["xopt"], extras["uopt"] = xopt, uopt
    if "options" in j:
        extras["options"] = j["options"]
    return qp_in, extras


def load_tree_qp_file(path: str, device="cuda", dtype=torch.float64):
    with open(path) as f:
        return load_tree_qp_json(json.load(f), device=device, dtype=dtype)


def tree_qp_to_json(qp_in: TreeQPIn, options: dict = None) -> dict:
    """Serialize a TreeQPIn to the reference input schema (the inverse of
    ``load_tree_qp_json``) — nodes[] with Q,R,S,q,r,lx,ux,lu,uu[,C,D,ld,ud],
    edges[] with A,B,b,from,to, plus an optional ``options`` object."""
    topo = qp_in.topo
    F = {f: _np(getattr(qp_in, f)) for f in QP_FIELDS}

    def mat_js(M, m, n):
        M = M[:m, :n]
        if m == 0 or n == 0:
            return []
        if m == 1 or n == 1:
            return M.reshape(-1).tolist()
        return M.tolist()

    nodes = []
    for i in range(topo.Nn):
        nx, nu, nc = topo.nx[i], topo.nu[i], topo.nc[i]
        nd = dict(
            Q=mat_js(F["Q"][i], nx, nx), R=mat_js(F["R"][i], nu, nu),
            S=mat_js(F["S"][i], nu, nx),
            q=F["q"][i, :nx].tolist(), r=F["r"][i, :nu].tolist(),
            lx=F["xmin"][i, :nx].tolist(), ux=F["xmax"][i, :nx].tolist(),
            lu=F["umin"][i, :nu].tolist(), uu=F["umax"][i, :nu].tolist(),
        )
        if nc > 0:
            nd["C"] = mat_js(F["C"][i], nc, nx)
            nd["D"] = mat_js(F["D"][i], nc, nu)
            nd["ld"] = F["dmin"][i, :nc].tolist()
            nd["ud"] = F["dmax"][i, :nc].tolist()
        nodes.append(nd)

    edges = []
    for c in range(1, topo.Nn):
        p = int(topo.parent[c])
        edges.append({
            "A": mat_js(F["A"][c], topo.nx[c], topo.nx[p]),
            "B": mat_js(F["B"][c], topo.nx[c], topo.nu[p]),
            "b": F["b"][c, : topo.nx[c]].tolist(),
            "from": p, "to": c,
        })
    j = dict(nodes=nodes, edges=edges)
    if options is not None:
        j["options"] = options
    return j


def solution_to_json(qp_in: TreeQPIn, out, kkt=None, num_iter=None, cpu_time=None,
                     status=None, solver_time=None, interface_time=None) -> dict:
    """Serialize a solution the way ``qpSolutionToJson`` does
    (solve_qp_json.cpp:109-160): per-node x/u/mu lists + solver info."""
    topo = qp_in.topo
    x, u, lam = _np(out.x), _np(out.u), _np(out.lam)
    mu_x, mu_u, mu_d = _np(out.mu_x), _np(out.mu_u), _np(out.mu_d)
    nodes = []
    for i in range(topo.Nn):
        nodes.append(dict(
            x=x[i, : topo.nx[i]].tolist(),
            u=u[i, : topo.nu[i]].tolist(),
            mu_x=mu_x[i, : topo.nx[i]].tolist(),
            mu_u=mu_u[i, : topo.nu[i]].tolist(),
            mu_d=mu_d[i, : topo.nc[i]].tolist(),
        ))
    edges = [dict(lam=lam[c, : topo.nx[c]].tolist(), to=c, **{"from": int(topo.parent[c])})
             for c in range(1, topo.Nn)]
    info = {}
    if kkt is not None:
        info["kkt_tol"] = float(kkt)
    if num_iter is not None:
        info["num_iter"] = int(num_iter)
    if cpu_time is not None:
        info["cpu_time"] = float(cpu_time)
    if status is not None:
        info["status"] = int(status)
    # solver-vs-interface time split (treeqp_info_t, tree_qp_common.h:43-51)
    if solver_time is not None:
        info["solver_time"] = float(solver_time)
    if interface_time is not None:
        info["interface_time"] = float(interface_time)
    return dict(nodes=nodes, edges=edges, info=info)

"""PyTorch port, ``core/json_io``: the reference-format JSON reader and
writers against the JAX package's on the same data, on the CPU.

The instances come from the JAX side's ``benchmarks.models`` (written with
the JAX ``tree_qp_to_json``); no dataset is read from disk. Bit for bit:
every array the loaders build is equal, and the writers give equal dicts
(the same keys, lists and floats)."""

import json

import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core import json_io as jio
from treeqp_tpu.core.qp_data import TreeQPOut as JaxOut

from treeqp_tpu_torch import convert, load_tree_qp_file, load_tree_qp_json
from treeqp_tpu_torch.core import json_io as tio
from treeqp_tpu_torch.core.qp_data import QP_FIELDS, OUT_FIELDS, TreeQPOut

torch.set_num_threads(1)


def _spring(rows: bool):
    qp, _ = jmodels.spring_mass_chain(nm=1, md=2, Nr=1, Nh=4)
    return jmodels.with_general_rows(qp, cmax=0.5) if rows else qp


def _with_opt(j, seed=0):
    """``j`` with a seeded xopt / uopt on every node."""
    rng = np.random.default_rng(seed)
    for nd in j["nodes"]:
        nd["xopt"] = rng.standard_normal(len(nd["q"])).tolist()
        nd["uopt"] = rng.standard_normal(len(nd["r"])).tolist()
    return j


def _assert_same_load(j):
    jq, jx = jio.load_tree_qp_json(j)
    tq, tx = load_tree_qp_json(j, device="cpu")
    assert tq.device.type == "cpu" and tq.dtype == torch.float64
    assert (tq.topo.parent, tq.topo.nx, tq.topo.nu, tq.topo.nc) == (
        tuple(jq.topo.parent), tuple(jq.topo.nx), tuple(jq.topo.nu), tuple(jq.topo.nc))
    for f in QP_FIELDS:
        np.testing.assert_array_equal(getattr(tq, f).numpy(), np.asarray(getattr(jq, f)),
                                      err_msg=f)
    assert sorted(tx) == sorted(jx)
    for k in ("xopt", "uopt"):
        if k in jx:
            np.testing.assert_array_equal(tx[k], jx[k], err_msg=k)
    assert tx.get("options") == jx.get("options")
    return jq, tq


@pytest.mark.parametrize("rows", [False, True])
def test_load_matches_jax(rows):
    """Every array from ``load_tree_qp_json`` equals JAX's, on a box-only
    tree and on one with a general C/D row on every node, both carrying
    xopt / uopt and options."""
    j = _with_opt(jio.tree_qp_to_json(_spring(rows), options=dict(solver="tdunes", maxit=7)))
    _assert_same_load(json.loads(json.dumps(j)))


@pytest.mark.parametrize("rows", [False, True])
def test_writers_match_jax(rows):
    """``tree_qp_to_json`` and ``solution_to_json`` give equal dicts for the
    same data: the QP with and without general rows, and a seeded solution
    with its info."""
    jq = _spring(rows)
    tq = convert.qp_from_numpy(convert.qp_arrays(jq), convert.topo_from(jq.topo), device="cpu")
    opts = dict(solver="sdunes", NREP=2)
    assert tio.tree_qp_to_json(tq, options=opts) == jio.tree_qp_to_json(jq, options=opts)
    assert tio.tree_qp_to_json(tq) == jio.tree_qp_to_json(jq)
    rng = np.random.default_rng(5)
    shapes = dict(x=jq.q.shape, u=jq.r.shape, lam=jq.q.shape, mu_x=jq.q.shape,
                  mu_u=jq.r.shape, mu_d=jq.dmin.shape)
    arrs = {f: rng.standard_normal(shapes[f]) for f in OUT_FIELDS}
    jout = JaxOut(**arrs, info={})
    tout = TreeQPOut(**{f: torch.tensor(v) for f, v in arrs.items()}, info={})
    kw = dict(kkt=1.5e-13, num_iter=4, cpu_time=0.25, status=0, solver_time=0.125,
              interface_time=0.125)
    assert tio.solution_to_json(tq, tout, **kw) == jio.solution_to_json(jq, jout, **kw)
    assert tio.solution_to_json(tq, tout) == jio.solution_to_json(jq, jout)


def _handmade(case):
    """Hand-written datasets in the reference's scalar and flat-list forms:
    nx = nu = 1 with scalars for 1-vectors and 1x1 matrices; nu = 0 leaves
    (no r, R, S, lu, uu keys); one-row matrices (C, D with nc = 1 as flat
    lists) and a one-column B (nu = 1) as a flat list; a row-major 2x3 A."""
    if case == "scalars":
        nodes = [dict(Q=2.0, R=1.0, S=0.5, q=0.1, r=-0.2, lx=-1.0, ux=1.0, lu=-3.0, uu=3.0),
                 dict(Q=1.5, R=0.5, S=0.0, q=0.0, r=0.3),
                 dict(Q=1.0, q=0.2, lx=-2.0, ux=2.0)]
        edges = [dict(A=0.9, B=0.1, b=0.0, **{"from": 0, "to": 1}),
                 dict(A=1.1, B=0.2, b=0.05, **{"from": 1, "to": 2})]
    elif case == "leaves":
        nodes = [dict(Q=[[2.0, 0.1], [0.1, 1.0]], R=[[1.0]], S=[0.2, 0.0], q=[0.1, 0.2],
                      r=[0.3], lu=[-1.0], uu=[1.0]),
                 dict(Q=[[1.0, 0.0], [0.0, 1.0]], q=[0.0, 0.1], lx=[-1.0, -2.0], ux=[1.0, 2.0]),
                 dict(Q=[[3.0, 0.0], [0.0, 3.0]], q=[1.0, 0.0], r=[], R=[], S=[])]
        edges = [dict(A=[[1.0, 0.1], [0.0, 1.0]], B=[0.0, 0.1], b=[0.0, 0.0],
                      **{"from": 0, "to": 1}),
                 dict(A=[[0.9, 0.0], [0.2, 1.0]], B=[0.1, 0.0], b=[0.01, 0.0],
                      **{"from": 0, "to": 2})]
    else:  # "rows"
        nodes = [dict(Q=[[2.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], R=[[1.0]],
                      S=[0.0, 0.1, 0.0], q=[0.0, 0.1, 0.2], r=[0.0],
                      C=[1.0, 0.5, 0.0], D=[0.5], ld=[-1.0], ud=[1.0]),
                 dict(Q=[[1.0, 0.0], [0.0, 1.0]], R=[[2.0]], S=[0.0, 0.0], q=[0.3, 0.0],
                      r=[0.1], C=[[1.0, 0.0], [0.0, 1.0]], D=[0.0, 1.0], ld=[-1.0, -2.0],
                      ud=[1.0, 2.0])]
        edges = [dict(A=[[1.0, 0.0, 0.5], [0.0, 1.0, 0.0]], B=[0.1, 0.2], b=[0.0, 0.1],
                      **{"from": 0, "to": 1})]
    return dict(nodes=nodes, edges=edges)


@pytest.mark.parametrize("case", ["scalars", "leaves", "rows"])
def test_scalar_and_flat_forms(case, tmp_path):
    """The reference's edge forms load alike in both packages, through
    ``load_tree_qp_file`` too, and write back alike."""
    j = _handmade(case)
    jq, tq = _assert_same_load(j)
    path = tmp_path / "qp.json"
    path.write_text(json.dumps(j))
    fq, _ = load_tree_qp_file(str(path), device="cpu")
    for f in QP_FIELDS:
        assert torch.equal(getattr(fq, f), getattr(tq, f)), f
    assert tio.tree_qp_to_json(tq) == jio.tree_qp_to_json(jq)


def test_load_defaults_to_the_card():
    """The loaders build on the card unless asked for the CPU: without a
    CUDA device the default raises (no fallback)."""
    if torch.cuda.is_available():
        qp, _ = load_tree_qp_json(_handmade("scalars"))
        assert qp.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        load_tree_qp_json(_handmade("scalars"))

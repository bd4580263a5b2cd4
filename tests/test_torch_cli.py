"""PyTorch port, ``interfaces/cli``: ``solve_request`` on the CPU against the
JAX package's on the same request, on every dispatch branch, and the
one-shot file mode and the JSON-lines server as processes.

The requests are spring_mass_chain(nm=1, md=2, Nr=1, Nh=4) and its
``with_general_rows`` variant from the JAX side's ``benchmarks.models``,
written with the JAX ``tree_qp_to_json``. Tolerances (ROADMAP's whole-slice
bars): the same dispatched solver and status, iterations within one,
|dx|, |du| <= 1e-7, |dlam| <= 1e-6, the same JSON keys and list lengths."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.json_io import tree_qp_to_json
from treeqp_tpu.interfaces import cli as jcli

from treeqp_tpu_torch.interfaces import cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
X_TOL, U_TOL, LAM_TOL = 1e-7, 1e-7, 1e-6
TIMEOUT = 120


def _spring(rows=False):
    qp, x0 = jmodels.spring_mass_chain(nm=1, md=2, Nr=1, Nh=4)
    return (jmodels.with_general_rows(qp, cmax=0.5) if rows else qp), x0


def _flat(j, part, key):
    return np.concatenate([np.asarray(e[key], dtype=float) for e in j[part]]
                          or [np.zeros(0)])


def _assert_same_response(got, ref, iters_slack=1):
    assert got["info"]["solver"] == ref["info"]["solver"]
    assert got["info"]["status"] == ref["info"]["status"] == 0
    assert abs(got["info"]["num_iter"] - ref["info"]["num_iter"]) <= iters_slack
    assert got["info"]["kkt_tol"] < 1e-8
    assert sorted(got) == sorted(ref) and sorted(got["info"]) == sorted(ref["info"])
    assert sorted(got["init"]) == sorted(ref["init"])
    for part, keys in (("nodes", ("x", "u", "mu_x", "mu_u", "mu_d")), ("edges", ("lam",))):
        assert len(got[part]) == len(ref[part])
        for a, b in zip(got[part], ref[part]):
            assert sorted(a) == sorted(b)
            assert all(len(a[k]) == len(b[k]) for k in keys)
    assert np.abs(_flat(got, "nodes", "x") - _flat(ref, "nodes", "x")).max() <= X_TOL
    assert np.abs(_flat(got, "nodes", "u") - _flat(ref, "nodes", "u")).max() <= U_TOL
    assert np.abs(_flat(got, "edges", "lam") - _flat(ref, "edges", "lam")).max() <= LAM_TOL
    if "lam0_tree" in ref["init"]:
        assert len(got["init"]["lam0_tree"]) == len(ref["init"]["lam0_tree"])
        assert np.abs(np.subtract(got["init"]["lam0_tree"], ref["init"]["lam0_tree"])
                      ).max() <= LAM_TOL
    i = got["info"]
    assert i["solver_time"] > 0 and i["interface_time"] > 0
    assert i["cpu_time"] == pytest.approx(i["solver_time"] + i["interface_time"])


# (options, general rows, dispatched solver)
BRANCHES = {
    "tdunes_ms": (dict(solver="tdunes", clipping=True, maxit=60), False, "tdunes_ms"),
    "tdunes_clipping": (dict(solver="tdunes", clipping=True, maxit=60, multistage=False),
                        False, "tdunes"),
    "tdunes_boxqp": (dict(solver="tdunes", maxit=60), False, "tdunes"),
    "tdunes_qpgen": (dict(solver="tdunes", maxit=80), True, "tdunes"),
    "sdunes": (dict(solver="sdunes"), False, "sdunes"),
    "hpipm_ms": (dict(solver="hpipm", tol=1e-9), False, "hpipm_ms"),
    "ipm": (dict(solver="ipm", tol=1e-9, multistage=False), False, "ipm"),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_solve_request_matches_jax(branch):
    """Each dispatch branch on the CPU against the JAX front-end, NREP = 2
    (the determinism assert runs)."""
    opts, rows, solver = BRANCHES[branch]
    j = tree_qp_to_json(_spring(rows)[0], options={**opts, "NREP": 2})
    ref = jcli.solve_request(j)
    got = cli.solve_request(j, device="cpu")
    assert got["info"]["solver"] == solver
    _assert_same_response(got, ref)


@pytest.mark.parametrize("solver", ["tdunes_ms", "tdunes_boxqp"])
def test_warm_start_and_x0(solver):
    """``init.json``'s x0 and lam0_tree (the previous response's
    ``init.lam0_tree``) on the multistage and the generic dispatch."""
    opts, rows, _ = BRANCHES[solver]
    qp, x0 = _spring(rows)
    j = tree_qp_to_json(qp, options=opts)
    cold = jcli.solve_request(j)
    init = dict(x0=(0.9 * np.asarray(x0)).tolist(), lam0_tree=cold["init"]["lam0_tree"])
    ref = jcli.solve_request(j, init)
    got = cli.solve_request(j, init, device="cpu")
    _assert_same_response(got, ref)
    x_root = got["nodes"][0]["x"]
    assert np.allclose(x_root, init["x0"])


def test_eliminate_x0():
    """``--eliminate-x0`` folds the pinned root state into the data (root nx
    = 0 in the response), in both packages alike; an unpinned root is
    refused."""
    j = tree_qp_to_json(_spring()[0], options=dict(solver="tdunes", maxit=60))
    ref = jcli.solve_request(j, eliminate_x0=True)
    got = cli.solve_request(j, eliminate_x0=True, device="cpu")
    assert got["nodes"][0]["x"] == []
    _assert_same_response(got, ref)
    for nd in j["nodes"][:1]:
        nd["lx"] = [-1e12] * len(nd["lx"])
    with pytest.raises(SystemExit, match="pinned root"):
        cli.solve_request(j, eliminate_x0=True, device="cpu")


def test_dispatch_errors():
    """``multistage: true`` on a tree with general rows and an unknown solver
    are refused with a message, as in the JAX front-end."""
    j = tree_qp_to_json(_spring(rows=True)[0], options=dict(solver="tdunes", multistage=True))
    with pytest.raises(SystemExit, match="multistage=true"):
        cli.solve_request(j, device="cpu")
    j["options"] = dict(solver="osqp")
    with pytest.raises(SystemExit, match="unknown solver"):
        cli.solve_request(j, device="cpu")


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")  # the child as this module: one thread
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cli(*args, **kw):
    return subprocess.run([sys.executable, "-m", "treeqp_tpu_torch.interfaces.cli", *args],
                          cwd=ROOT, env=_env(), capture_output=True, text=True,
                          timeout=TIMEOUT, **kw)


def test_run_file_mode(tmp_path):
    """The one-shot file mode with ``--device cpu``: qp.json + init.json in,
    the schema out, the same solution as ``solve_request``."""
    qp, x0 = _spring()
    j = tree_qp_to_json(qp, options=dict(solver="tdunes", clipping=True, maxit=60))
    (tmp_path / "qp.json").write_text(json.dumps(j))
    (tmp_path / "init.json").write_text(json.dumps(dict(x0=list(x0))))
    out = tmp_path / "out.json"
    res = _cli(str(tmp_path / "qp.json"), str(tmp_path / "init.json"), "-o", str(out),
               "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "solver=tdunes_ms" in res.stdout and "device=cpu" in res.stdout
    got = json.loads(out.read_text())
    _assert_same_response(got, cli.solve_request(j, dict(x0=list(x0)), device="cpu"),
                          iters_slack=0)


def test_serve_protocol():
    """The JSON-lines server with ``--device cpu``: the handshake, three
    requests (the last one warm from the first's lam0_tree and one with an
    error), then quit and exit 0."""
    qp, _ = _spring()
    j = tree_qp_to_json(qp, options=dict(solver="tdunes", clipping=True, maxit=60))
    proc = subprocess.Popen([sys.executable, "-m", "treeqp_tpu_torch.interfaces.cli",
                             "--serve", "--device", "cpu"], cwd=ROOT, env=_env(),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        assert json.loads(proc.stdout.readline()) == {"ready": True}

        def ask(req):
            proc.stdin.write(json.dumps(req) + "\n")
            proc.stdin.flush()
            return json.loads(proc.stdout.readline())

        first = ask(dict(qp=j))
        assert first["info"]["solver"] == "tdunes_ms" and first["info"]["status"] == 0
        _assert_same_response(first, cli.solve_request(j, device="cpu"), iters_slack=0)
        bad = ask(dict(qp={**j, "options": dict(solver="osqp")}))
        assert "unknown solver" in bad["error"]
        warm = ask(dict(qp=j, init=dict(lam0_tree=first["init"]["lam0_tree"]), nrep=2))
        assert warm["info"]["status"] == 0
        assert warm["info"]["num_iter"] <= first["info"]["num_iter"]
        proc.stdin.write(json.dumps({"cmd": "quit"}) + "\n")
        proc.stdin.flush()
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_no_card_no_fallback(tmp_path):
    """Without a card and without ``--device cpu`` the file mode and the
    server exit non-zero with a message, and the server writes no
    handshake."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    j = tree_qp_to_json(_spring()[0], options=dict(solver="tdunes"))
    (tmp_path / "qp.json").write_text(json.dumps(j))
    res = _cli(str(tmp_path / "qp.json"), "-o", str(tmp_path / "out.json"))
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not (tmp_path / "out.json").exists()
    res = _cli("--serve", input=json.dumps(dict(qp=j)) + "\n")
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert res.stdout == ""
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.solve_request(j)

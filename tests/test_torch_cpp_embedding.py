"""PyTorch port, the C++ embedding API (``interfaces/cpp/treeqp_cpp.hpp``):
the demo built with g++ drives the port's solve server through
``SolverSession`` on the CPU (device ``cpu``, its third argument), on a
generated dataset that carries the JAX package's solution as xopt / uopt,
and checks it to 1e-8 and the KKT residual to 1e-10; the port's Makefile
builds the demo and the host library; without a card the default device
fails cleanly."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.json_io import tree_qp_to_json
from treeqp_tpu.interfaces import cli as jcli

ROOT = Path(__file__).resolve().parents[1]
CPP = ROOT / "treeqp_tpu_torch" / "interfaces" / "cpp"
TIMEOUT = 180


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    out = tmp_path_factory.mktemp("cpp") / "treeqp_cpp_demo"
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-o", str(out),
                    str(CPP / "treeqp_cpp_demo.cpp")], check=True, timeout=TIMEOUT)
    return out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """spring_mass_chain(nm=1, md=2, Nr=1, Nh=4) with the JAX front-end's
    solution (tdunes, the demo's options) as each node's xopt / uopt."""
    qp, _ = jmodels.spring_mass_chain(nm=1, md=2, Nr=1, Nh=4)
    j = tree_qp_to_json(qp, options=dict(solver="tdunes", maxit=200,
                                         stationarityTolerance=1e-12))
    sol = jcli.solve_request(j)
    assert sol["info"]["status"] == 0
    j.pop("options")
    for nd, s in zip(j["nodes"], sol["nodes"]):
        nd["xopt"], nd["uopt"] = s["x"], s["u"]
    path = tmp_path_factory.mktemp("data") / "qp_with_opt.json"
    path.write_text(json.dumps(j))
    return path


def _run(demo, dataset, *args):
    # one intra-op thread in the server child, as every in-process torch test
    # sets it: parallel test workers each spawning a full thread pool slow a
    # tiny solve a hundredfold
    env = dict(os.environ, TREEQP_ROOT=str(ROOT), TREEQP_PYTHON=sys.executable,
               OMP_NUM_THREADS="1")
    return subprocess.run([str(demo), str(dataset), *args], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT)


def test_cpp_demo_on_cpu(demo, dataset):
    """The demo's cold solve matches JAX's optimum and its warm solves reuse
    the server child: exit 0 and its two lines."""
    res = _run(demo, dataset, "5", "cpu")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert len(lines) == 2, res.stdout
    assert lines[0].startswith("device=cpu solver=tdunes") and "status=0" in lines[0]
    assert lines[1].startswith("warm x5:")


def test_cpp_demo_without_card(demo, dataset):
    """The demo's default device is the card: without one, the server exits
    before its handshake and the demo exits 1 with a message."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    res = _run(demo, dataset, "1")
    assert res.returncode == 1
    assert "no CUDA device" in res.stderr and "treeqp_cpp_demo:" in res.stderr


def test_makefile_builds_into_build_dir(tmp_path):
    """The port's Makefile builds the host library and the demo into the
    directory it is given."""
    res = subprocess.run(["make", "-C", str(CPP), f"BUILD={tmp_path}"], capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "libtreeqp_host.so").exists() and (tmp_path / "treeqp_cpp_demo").exists()

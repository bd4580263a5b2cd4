"""PyTorch port, the C++ embedding API (``interfaces/cpp/treeqp_cpp.hpp``):
the demo built with g++ drives the port's solve server through
``SolverSession`` on the CPU (device ``cpu``, its third argument), on a
generated dataset that carries the JAX package's solution as xopt / uopt,
and checks it to 1e-8 and the KKT residual to 1e-10; the port's Makefile
builds the demo and the host library; without a card the default device
fails cleanly; ``SolverSession`` leaves the host's SIGPIPE handler
installed and a dead server child raises instead of signalling."""

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


# A host that installs its own SIGPIPE handler, then drives a SolverSession:
# the handler must be the one installed after Start() and after Stop(), and
# (with the "dead" argument, against a server that closes its stdin) a
# request must raise the documented runtime_error without a SIGPIPE reaching
# the host.
HOST_SRC = r"""
#include <signal.h>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include "treeqp_cpp.hpp"

static volatile sig_atomic_t host_sigpipes = 0;
static void host_handler(int) { host_sigpipes = host_sigpipes + 1; }

static bool host_handler_installed() {
  struct sigaction now;
  sigaction(SIGPIPE, nullptr, &now);
  return !(now.sa_flags & SA_SIGINFO) && now.sa_handler == host_handler;
}

int main(int argc, char** argv) {
  struct sigaction sa;
  std::memset(&sa, 0, sizeof sa);
  sa.sa_handler = host_handler;
  sigemptyset(&sa.sa_mask);
  sigaction(SIGPIPE, &sa, nullptr);
  const bool dead = argc > 1 && std::strcmp(argv[1], "dead") == 0;
  treeqp::SolverSession session("cpu");
  session.Start();
  std::printf("after Start: %d\n", host_handler_installed());
  if (dead) {
    try {
      treeqp::Json req = treeqp::Json::Object();
      req["cmd"] = treeqp::Json(std::string("ping"));
      session.Request(req);
      std::printf("no error\n");
    } catch (const std::runtime_error& e) {
      std::printf("error: %s\n", e.what());
    }
    sigset_t pending;
    sigpending(&pending);
    std::printf("pending: %d\n", sigismember(&pending, SIGPIPE));
  }
  session.Stop();
  std::printf("after Stop: %d\n", host_handler_installed());
  std::printf("host SIGPIPEs: %d\n", (int)host_sigpipes);
  return 0;
}
"""


@pytest.fixture(scope="module")
def sigpipe_host(tmp_path_factory):
    d = tmp_path_factory.mktemp("sigpipe")
    (d / "host.cpp").write_text(HOST_SRC)
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", f"-I{CPP}", "-o",
                    str(d / "host"), str(d / "host.cpp")], check=True, timeout=TIMEOUT)
    return d / "host"


def test_session_keeps_the_host_sigpipe_handler(sigpipe_host):
    """A host's own SIGPIPE handler, installed before SolverSession::Start(),
    is still the installed one after Start() (the port's server child up on
    the CPU) and after Stop()."""
    env = dict(os.environ, TREEQP_ROOT=str(ROOT), TREEQP_PYTHON=sys.executable,
               OMP_NUM_THREADS="1")
    res = subprocess.run([str(sigpipe_host)], env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == ["after Start: 1", "after Stop: 1", "host SIGPIPEs: 0"]


def test_dead_server_raises_without_sigpipe(sigpipe_host, tmp_path):
    """A server child that has closed its stdin after its handshake: the
    request's write fails with the documented runtime_error, no SIGPIPE
    reaches the host's handler or stays pending, and the host's handler is
    still installed."""
    fake = tmp_path / "fake_server"
    fake.write_text("#!/bin/sh\nexec 0<&-\necho '{\"ready\": true}'\n")
    fake.chmod(0o755)
    env = dict(os.environ, TREEQP_ROOT=str(ROOT), TREEQP_PYTHON=str(fake))
    res = subprocess.run([str(sigpipe_host), "dead"], env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == [
        "after Start: 1", "error: treeqp: server write failed", "pending: 0",
        "after Stop: 1", "host SIGPIPEs: 0"]

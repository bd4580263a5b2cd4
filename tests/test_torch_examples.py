"""PyTorch port, the examples (``examples_torch/``) against the JAX
package's (``examples/``), on the CPU.

The thesis example's QP bit for bit JAX's, its tdunes and IPM solutions
within 1e-7 of JAX's and its own asserts passing; the spring-mass example
on a data.c / x0.txt written in the reference's format
(``chip_smoke.write_spring_mass_data``), where JAX's cold tdunes and sdunes
solves converge, its six asserts passing and its tdunes and IPM x within
1e-7 of JAX's; both scripts from the command line with ``--device cpu``,
and without a card and without it their refusal; and no module of the
port, its examples, its smoke or its profiling scripts importing ``jax``,
``treeqp_tpu`` or ``benchmarks``."""

import ast
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks import models as jmodels
from treeqp_tpu.solvers.ipm import IpmOpts as JIpmOpts, ipm_solve as jipm_solve
from treeqp_tpu.solvers.sdunes import SdunesOpts as JSdunesOpts, scenario_data, sdunes_solve
from treeqp_tpu.solvers.tdunes import TdunesOpts as JTdunesOpts, tdunes_solve as jtdunes_solve

from treeqp_tpu_torch import convert, models
from treeqp_tpu_torch.core.qp_data import QP_FIELDS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
X_TOL = U_TOL = 1e-7
TIMEOUT = 300
SCRIPTS = ("thesis_example.py", "spring_mass.py")


@functools.lru_cache(maxsize=None)
def load(path):
    """The example script at ``path`` (relative to the repo root) as a
    module of its own name."""
    name = "ex_" + path.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sm_dir(tmp_path_factory):
    return chip_smoke.write_spring_mass_data(str(tmp_path_factory.mktemp("spring_mass_utils")))


def test_thesis_build_qp_matches_jax():
    """The port's 6-node thesis tree and data bit for bit JAX's."""
    qj = load("examples/thesis_example.py").build_qp()
    qp = load("examples_torch/thesis_example.py").build_qp(device="cpu")
    assert qp.topo == convert.topo_from(qj.topo)
    a, b = convert.qp_arrays(qp), convert.qp_arrays(qj)
    for f in QP_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_thesis_example_matches_jax():
    """main(device="cpu") passes its asserts (tdunes KKT < 1e-10, IPM KKT <
    1e-8, the two x within 1e-7); its tdunes and IPM x and u lie within
    1e-7 of JAX's at the example's options."""
    qj = load("examples/thesis_example.py").build_qp()
    res = load("examples_torch/thesis_example.py").main(device="cpu")
    outs_j = {"tdunes": jtdunes_solve(qj, None, JTdunesOpts(stage_solver="clipping",
                                                            max_iter=100)),
              "ipm": jipm_solve(qj, JIpmOpts())}
    for name, oj in outs_j.items():
        assert int(oj.info["status"]) == res[name].info["status"] == 0, name
        assert np.max(np.abs(res[name].x.numpy() - np.asarray(oj.x))) <= X_TOL, name
        assert np.max(np.abs(res[name].u.numpy() - np.asarray(oj.u))) <= U_TOL, name


def test_spring_mass_example_matches_jax(sm_dir):
    """On the written instance JAX's cold tdunes and sdunes solves reach
    status 0; then main(device="cpu", data_dir) passes its six asserts
    (status 0, KKT < 1e-8, x within 1e-7 of tdunes), and its tdunes and IPM
    x lie within 1e-7 of JAX's at the example's options."""
    qj, _ = jmodels.spring_mass_qp(data_dir=sm_dir)
    tj = jtdunes_solve(qj, None, JTdunesOpts(stage_solver="clipping", tol=1e-10,
                                             max_iter=100))
    sinfo = sdunes_solve(scenario_data(qj), None, None, JSdunesOpts(tol=1e-8, max_iter=100))[3]
    assert int(tj.info["status"]) == 0 and int(sinfo["status"]) == 0
    ij = jipm_solve(qj, JIpmOpts(tol=1e-10, max_iter=40))
    assert int(ij.info["status"]) == 0
    res = load("examples_torch/spring_mass.py").main(device="cpu", data_dir=sm_dir)
    assert set(res) == {"tdunes", "tdunes_ms", "ipm", "ipm_ms", "sdunes", "sdunes_ws"}
    for name, oj in (("tdunes", tj), ("ipm", ij)):
        assert np.max(np.abs(res[name].x.numpy() - np.asarray(oj.x))) <= X_TOL, name


def _run_script(script, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(ROOT / "examples_torch" / script), *args],
                          env=env, capture_output=True, text=True, timeout=TIMEOUT)


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_script_on_cpu(script, sm_dir):
    """``python examples_torch/<script> --device cpu`` (the spring-mass one
    with ``--data-dir``) passes its asserts and prints every solve."""
    args = ("--data-dir", sm_dir) if script == "spring_mass.py" else ()
    res = _run_script(script, "--device", "cpu", *args)
    assert res.returncode == 0, res.stderr
    want = ("tdunes", "ipm") if script == "thesis_example.py" else (
        "tdunes ", "tdunes_ms", "ipm ", "ipm_ms", "sdunes ", "sdunes_ws")
    for w in want:
        assert any(line.startswith(w) for line in res.stdout.splitlines()), (w, res.stdout)


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_script_without_card(script, sm_dir):
    """The examples' default device is the card: without one, each exits
    non-zero with "no CUDA device" and solves nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    res = _run_script(script, "--data-dir", sm_dir) if script == "spring_mass.py" \
        else _run_script(script)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "status=" not in res.stdout


FORBIDDEN = ("jax", "jaxlib", "treeqp_tpu", "benchmarks")
PORT_FILES = {
    "package": sorted((ROOT / "treeqp_tpu_torch").rglob("*.py")),
    "examples": sorted((ROOT / "examples_torch").glob("*.py")),
    "smoke": [ROOT / "chip_smoke.py"],
    # the scripts that run on the card (replay_torch_sdunes_depth.py and
    # depth_parity_*.py run the JAX package on the CPU beside the port)
    "scripts": sorted((ROOT / "scripts").glob("prof_torch_*.py"))
    + [ROOT / "scripts" / n for n in ("prof_common.py", "replay_torch_sdunes_f32.py")],
}


@pytest.mark.parametrize("group", list(PORT_FILES))
def test_port_imports_no_jax(group):
    """No module of the port, its examples, its smoke or its profiling
    scripts imports jax, treeqp_tpu or benchmarks (any import statement,
    top level or inside a function)."""
    files = PORT_FILES[group]
    assert files, group
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path.name, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad

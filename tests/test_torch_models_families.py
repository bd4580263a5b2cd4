"""PyTorch port, the model families of ``models.py`` that complete the port
of ``benchmarks/models.py``: the crane, the linear chain and the reference
spring-mass loader, held against the JAX package's generators.

The same arguments go through both packages: every TreeQPIn field within
FIELD_TOL (1e-12) and the same topology, the plants within 1e-12 at seeded
states and controls, the crane's closed loop against JAX's
``closed_loop_mpc`` (tdunes with its IPM bootstrap, the JAX default
options on both sides), and ``spring_mass_qp`` bit for bit on a data.c /
x0.txt written in the reference's format (``chip_smoke.write_spring_mass_data``)."""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks import models as jmodels
from benchmarks.closed_loop import closed_loop_mpc
from treeqp_tpu.utils import ref_data as jref

from treeqp_tpu_torch import IpmOpts, TdunesOpts, convert, ipm_solve, models, tdunes_solve
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.core.qp_data import QP_FIELDS
from treeqp_tpu_torch.utils import ref_data

torch.set_num_threads(1)

FIELD_TOL = 1e-12
PLANT_TOL = 1e-12
X_TOL = 1e-7
KKT_TOL = 1e-6  # the reference's closed-loop bar (treeqp_main.m:28)

FAMILIES = {
    "crane": ("crane", dict(md=2, Nr=2, Nh=8)),
    "linear_chain_small": ("linear_chain", dict(nm=2, nu_count=1, md=2, Nr=1, Nh=6)),
    "linear_chain_default": ("linear_chain", dict(md=2, Nr=2, Nh=6)),
}


@functools.lru_cache(maxsize=None)
def family(name):
    """(JAX model, port model) of the same arguments."""
    fn, kw = FAMILIES[name]
    return getattr(jmodels, fn)(**kw), getattr(models, fn)(**kw, device="cpu")


def assert_same_qp(qp, qj, tol, what):
    assert qp.topo == convert.topo_from(qj.topo), what
    a, b = convert.qp_arrays(qp), convert.qp_arrays(qj)
    for f in QP_FIELDS:
        assert a[f].shape == b[f].shape, (what, f)
        assert np.max(np.abs(a[f] - b[f]), initial=0.0) <= tol, (what, f)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_data_matches_jax(name):
    """Every field of the port's QP within 1e-12 of JAX's, the same tree,
    x0, reference, weights and sampling time."""
    mj, m = family(name)
    assert_same_qp(m.qp, mj.qp, FIELD_TOL, name)
    np.testing.assert_array_equal(m.x0, np.asarray(mj.x0))
    np.testing.assert_array_equal(m.xref, mj.xref)
    assert m.Ts == mj.Ts and m.weights.keys() == mj.weights.keys()
    for k, v in m.weights.items():
        np.testing.assert_array_equal(v, mj.weights[k])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_plant_matches_jax(name):
    """The nonlinear plant (RK4 at the seeded true parameter) against
    JAX's at seeded states and controls: within 1e-12."""
    mj, m = family(name)
    nx, nu = m.qp.topo.nx[0], m.qp.topo.nu[0]
    rng = np.random.default_rng(11)
    for _ in range(3):
        x, u = 0.3 * rng.standard_normal(nx), rng.uniform(-0.5, 0.5, nu)
        got = m.simulate(x, u)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_allclose(got, np.asarray(mj.simulate(x, u)), rtol=0, atol=PLANT_TOL)


def test_crane_closed_loop_matches_jax():
    """The crane's 10-step closed loop (JAX's closed_loop_mpc with tdunes:
    an IPM bootstrap on the first step, the duals kept after) run by the
    port step for step: every step status 0 with KKT <= 1e-6, iterations
    within one of JAX's, the states within X_TOL, and the load driven to
    xref = 0.2 within 0.05."""
    nsim = 10
    mj, m = family("crane")
    log = closed_loop_mpc(mj, "tdunes", nsim=nsim)
    assert log.kkt_violations == 0
    opts, qp, nu = TdunesOpts(stage_solver="clipping", tol=1e-8, max_iter=100), m.qp, 1
    x, lam = m.x0, None
    for k in range(nsim):
        qk = qp.set_x0(x)
        if lam is None:
            lam = ipm_solve(qk, IpmOpts(tol=1e-8, max_iter=30)).lam
        out = tdunes_solve(qk, lam, opts)
        assert out.info["status"] == 0 and max_kkt_residual(qk, out) <= KKT_TOL, k
        assert abs(out.info["iter"] - int(log.iters[k])) <= 1, k
        x, lam = m.simulate(x, out.u[0, :nu].numpy()), out.lam
        assert np.max(np.abs(x - log.x[k + 1])) <= X_TOL, k
    assert abs(x[0] - 0.2) < 0.05


@pytest.fixture(scope="module")
def sm_dir(tmp_path_factory):
    return chip_smoke.write_spring_mass_data(str(tmp_path_factory.mktemp("spring_mass_utils")))


@pytest.mark.parametrize("kw", [dict(), dict(xmax1=None), dict(x0_from_file=False)],
                         ids=["default", "xmax1_none", "x0_zero"])
def test_spring_mass_qp_matches_jax(sm_dir, kw):
    """spring_mass_qp on the written reference-format files, bit for bit
    JAX's on the same files, x0 included."""
    qj, x0j = jmodels.spring_mass_qp(data_dir=sm_dir, **kw)
    qp, x0 = models.spring_mass_qp(data_dir=sm_dir, **kw, device="cpu")
    assert_same_qp(qp, qj, 0.0, kw)
    np.testing.assert_array_equal(x0, np.asarray(x0j))


def test_written_spring_mass_data_is_the_chain(sm_dir):
    """The written instance read back with data.c's own xmax (xmax1=None) is
    spring_mass_chain(2, 3, 2, 10) bit for bit: the writer puts that chain's
    realizations behind the nominal one and its weights, bounds and x0
    in the reference's layout; the default tightens xmax[1] to 0.2."""
    qp, x0 = models.spring_mass_qp(sm_dir, xmax1=None, device="cpu")
    qc, xc = models.spring_mass_chain(2, 3, 2, 10, device="cpu")
    assert qp.topo == qc.topo
    for f in QP_FIELDS:
        assert torch.equal(getattr(qp, f), getattr(qc, f)), f
    np.testing.assert_array_equal(x0, xc)
    tight = models.spring_mass_qp(sm_dir, device="cpu")[0]
    assert float(tight.xmax[1, 1]) == 0.2 and float(tight.xmax[1, 0]) == 1.2


def test_spring_mass_qp_missing_files_raise(tmp_path, sm_dir):
    """No fallback to a generated instance: a missing directory, data.c or
    x0.txt raises FileNotFoundError naming the path."""
    with pytest.raises(FileNotFoundError, match="nowhere/data.c"):
        models.spring_mass_qp(str(tmp_path / "nowhere"), device="cpu")
    (tmp_path / "data.c").write_text(open(f"{sm_dir}/data.c").read())
    with pytest.raises(FileNotFoundError, match="x0.txt"):
        models.spring_mass_qp(str(tmp_path), device="cpu")
    qp, x0 = models.spring_mass_qp(str(tmp_path), x0_from_file=False, device="cpu")
    assert not x0.any()


def test_c_arrays_round_trip(tmp_path):
    """write_c_arrays writes a data.c that both packages' parsers read back
    exactly."""
    rng = np.random.default_rng(3)
    arrays = dict(A=rng.standard_normal(12), tiny=np.array([1e-300, -0.0, 1e12, 1 / 3]))
    chip_smoke.write_c_arrays(str(tmp_path / "d.c"), dict(NX=4, md=3), arrays)
    for parse in (ref_data.parse_c_arrays, jref.parse_c_arrays):
        d = parse(str(tmp_path / "d.c"))
        assert d["NX"] == 4 and d["md"] == 3
        for k, v in arrays.items():
            np.testing.assert_array_equal(d[k], v)

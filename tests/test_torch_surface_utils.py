"""PyTorch port, the host utilities: ``utils/printing`` (byte for byte the
JAX package's text and txt files), ``utils/ref_data`` (equal dicts),
``utils/native`` (equal arrays to the JAX package's native library and to
the Python loop; ``TreeStructure.from_nkids`` with and without it),
``utils/timing`` (the min over NREP and the determinism assert) and
``utils/profiling`` (the JAX package's keys, the phase iteration counts
within one), on the CPU on instances from the JAX side's
``benchmarks.models``."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks import models as jmodels
from treeqp_tpu.core.qp_data import TreeQPOut as JaxOut
from treeqp_tpu.solvers.tdunes import TdunesOpts as JaxOpts
from treeqp_tpu.solvers.tdunes_multistage import split_multistage as jax_split
from treeqp_tpu.utils import native as jnative
from treeqp_tpu.utils import printing as jprint
from treeqp_tpu.utils import profiling as jprof
from treeqp_tpu.utils import ref_data as jref

from treeqp_tpu_torch import convert
from treeqp_tpu_torch.core.qp_data import TreeQPOut
from treeqp_tpu_torch.solvers.tdunes import TdunesOpts
from treeqp_tpu_torch.solvers.tdunes_multistage import split_multistage
from treeqp_tpu_torch.utils import native, printing, profiling, ref_data
from treeqp_tpu_torch.utils.timing import SolveInfo, cuda_devices, min_time_over
from treeqp_tpu_torch.utils.tree import TreeStructure, number_of_nodes_multistage

torch.set_num_threads(1)


def _pair(rows=False):
    qp, _ = jmodels.spring_mass_chain(nm=1, md=2, Nr=1, Nh=4)
    if rows:
        qp = jmodels.with_general_rows(qp, cmax=0.5)
    return qp, convert.qp_from_numpy(convert.qp_arrays(qp), convert.topo_from(qp.topo),
                                     device="cpu")


@pytest.mark.parametrize("rows", [False, True])
def test_printing_matches_jax(rows, tmp_path):
    """``tree_qp_in_print`` / ``tree_qp_out_print`` print the same bytes and
    ``tree_qp_out_write_txt`` writes the same files, for the same data and
    a seeded solution (JAX's 0-dim integer info values, the port's Python
    ints)."""
    jq, tq = _pair(rows)
    for nodes in (None, [0, 2]):
        a, b = io.StringIO(), io.StringIO()
        jprint.tree_qp_in_print(jq, nodes=nodes, file=a)
        printing.tree_qp_in_print(tq, nodes=nodes, file=b)
        assert b.getvalue() == a.getvalue() and "--- node 0" in a.getvalue()
    rng = np.random.default_rng(1)
    arrs = {f: rng.standard_normal(np.shape(getattr(jq, g))) for f, g in
            (("x", "q"), ("u", "r"), ("lam", "q"), ("mu_x", "q"), ("mu_u", "r"),
             ("mu_d", "dmin"))}
    jout = JaxOut(**{f: jnp.asarray(v) for f, v in arrs.items()},
                  info=dict(iter=jnp.asarray(7, jnp.int32), status=jnp.asarray(0, jnp.int32)))
    tout = TreeQPOut(**{f: torch.tensor(v) for f, v in arrs.items()},
                     info=dict(iter=7, status=0))
    a, b = io.StringIO(), io.StringIO()
    jprint.tree_qp_out_print(jq.topo, jout, file=a)
    printing.tree_qp_out_print(tq.topo, tout, file=b)
    assert b.getvalue() == a.getvalue() and "solution: iter=" in a.getvalue()
    jprint.tree_qp_out_write_txt(jq.topo, jout, str(tmp_path / "jax"))
    printing.tree_qp_out_write_txt(tq.topo, tout, str(tmp_path / "port"))
    for k in ("x", "u", "lam"):
        assert (tmp_path / f"port_{k}.txt").read_bytes() == (tmp_path / f"jax_{k}.txt").read_bytes()
        np.testing.assert_array_equal(printing.read_vector_txt(str(tmp_path / f"port_{k}.txt")),
                                      jprint.read_vector_txt(str(tmp_path / f"jax_{k}.txt")))


def test_ref_data_matches_jax(tmp_path):
    """``parse_c_arrays`` and ``read_txt_vector`` give equal results on a
    code-generated C data file and a txt vector."""
    src = tmp_path / "data.c"
    src.write_text("""
// generated problem data
int nx = 4;
int Nn = 13;
double dt = 0.05;
double A[] = {1.0, 0.1, -2.5e-3,
              0.0, 1.0, 3.0E2};
int nk[13] = {2, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0};
double x0[4] = {0.5, -0.25, 0, 1e-12};
""")
    got, ref = ref_data.parse_c_arrays(str(src)), jref.parse_c_arrays(str(src))
    assert sorted(got) == sorted(ref) == ["A", "Nn", "dt", "nk", "nx", "x0"]
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert got[k] == ref[k] and type(got[k]) is type(ref[k])
    txt = tmp_path / "v.txt"
    txt.write_text("1.5\n-2.0\n3e-4\n")
    np.testing.assert_array_equal(ref_data.read_txt_vector(str(txt)),
                                  jref.read_txt_vector(str(txt)))


def _python_topology(nk):
    t = TreeStructure.from_parent(_python_parent(nk), [1] * len(nk), [1] * len(nk))
    return np.asarray(t.parent), t.stage, t.sib_index, t.nkids


def _python_parent(nk):
    parent, nxt = [-1] * len(nk), 1
    for i, k in enumerate(nk):
        for _ in range(k):
            parent[nxt] = i
            nxt += 1
    return parent


NKS = ([2, 2, 1, 0, 0, 0], [3, 1, 1, 1, 0, 0, 0], [1, 0])


@pytest.mark.parametrize("nk", NKS)
def test_native_topology(nk):
    """The port's host library builds the JAX library's and the Python
    loop's topology; inconsistent children counts raise."""
    assert native.available() and jnative.available()
    got, ref = native.build_topology(nk), jnative.build_topology(nk)
    py = _python_topology(nk)
    for g, r, p in zip(got, ref, py):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0][1:], py[0][1:])
    for g, p in zip(got[1:], py[1:]):
        np.testing.assert_array_equal(g, p)
    with pytest.raises(ValueError):
        native.build_topology(nk[:-1] + [nk[-1] + 1])


@pytest.mark.parametrize("md,Nr,Nh", [(3, 2, 6), (4, 4, 20), (1, 0, 3)])
def test_native_multistage(md, Nr, Nh, monkeypatch):
    """``multistage_nk`` equals JAX's, and ``from_nkids`` gives the same
    topology with and without the library."""
    nn = number_of_nodes_multistage(md, Nr, Nh)
    nk = native.multistage_nk(md, Nr, Nh, nn)
    np.testing.assert_array_equal(nk, jnative.multistage_nk(md, Nr, Nh, nn))
    with_lib = TreeStructure.from_nkids(nk.tolist(), [2] * nn, [1] * nn)
    monkeypatch.setattr(native, "build_topology", lambda nk: None)
    without = TreeStructure.from_nkids(nk.tolist(), [2] * nn, [1] * nn)
    assert with_lib == without and with_lib.parent == tuple(_python_parent(nk))
    assert with_lib.nkids.tolist() == nk.tolist()


def test_native_pack_colmajor():
    """``pack_colmajor`` equals JAX's and the column-major definition."""
    rng = np.random.default_rng(0)
    rows, cols = [2, 3, 1, 0], [2, 1, 4, 3]
    blocks = [rng.standard_normal(r * c) for r, c in zip(rows, cols)]
    got = native.pack_colmajor(blocks, rows, cols, rmax=3, cmax=4)
    np.testing.assert_array_equal(got, jnative.pack_colmajor(blocks, rows, cols, 3, 4))
    for n, (r, c) in enumerate(zip(rows, cols)):
        np.testing.assert_array_equal(got[n, :r, :c], blocks[n].reshape(c, r).T)
        assert np.all(got[n, r:, :] == 0) and np.all(got[n, :, c:] == 0)
    with pytest.raises(ValueError):
        native.pack_colmajor(blocks, rows, cols, rmax=2, cmax=4)


def test_timing_min_and_determinism():
    """``min_time_over`` returns the smallest time and the last output, and
    asserts an unchanged check value across repeats."""
    calls = []

    def fn():
        calls.append(len(calls))
        return dict(x=torch.ones(3), it=len(calls))

    t, out = min_time_over(fn, nrep=4, check_deterministic=lambda o: o["x"].numel())
    assert len(calls) == 4 and out["it"] == 4 and 0 < t < 1
    with pytest.raises(AssertionError, match="non-deterministic"):
        min_time_over(fn, nrep=2, check_deterministic=lambda o: o["it"])
    assert cuda_devices(dict(a=[torch.ones(1)], b=(SolveInfo(), 2))) == set()
    assert SolveInfo(iter=3).solver_time == 0.0


def test_profiling_matches_jax():
    """``profile_ms_phases`` (test_harness's tree and options) and
    ``profile_tdunes_ops`` give the JAX package's keys, positive times and
    the phases' iteration counts within one of JAX's."""
    jq, tq = _pair()
    o = dict(stage_solver="clipping", factor_dtype="float32", f32_phase_tol=1e-3,
             refine_steps=1)
    ref = jprof.profile_ms_phases(jax_split(jq), JaxOpts(**o), nrep=2)
    got = profiling.profile_ms_phases(split_multistage(tq), TdunesOpts(**o), nrep=2)
    assert sorted(got) == sorted(ref)
    for k in ("f32_phase", "f64_phase", "factorization", "line_search_eval"):
        assert got[k] > 0, k
    for k in ("f32_phase_iters", "f64_phase_iters"):
        assert abs(got[k] - ref[k]) <= 1, (k, got[k], ref[k])
    ref = jprof.profile_tdunes_ops(jq, JaxOpts(**o), nrep=2)
    got = profiling.profile_tdunes_ops(tq, TdunesOpts(**o), nrep=2)
    assert sorted(got) == sorted(ref) and all(v > 0 for v in got.values())

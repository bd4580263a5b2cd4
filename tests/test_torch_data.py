"""PyTorch port, data layer: topology, problem data, KKT oracle and the
crown/chain split agree with the JAX package on identical inputs (CPU)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core import kkt as jkkt
from treeqp_tpu.core.qp_data import TreeQPIn as JTreeQPIn, TreeQPOut as JTreeQPOut
from treeqp_tpu.solvers import tdunes_multistage as jtm
from treeqp_tpu.utils.tree import TreeStructure as JTree

from treeqp_tpu_torch import convert, models
from treeqp_tpu_torch.core import kkt
from treeqp_tpu_torch.core.qp_data import TreeQPIn, TreeQPOut, QP_FIELDS, OUT_FIELDS
from treeqp_tpu_torch.solvers import tdunes_multistage as tm
from treeqp_tpu_torch.utils.tree import TreeStructure, number_of_nodes_multistage

torch.set_num_threads(1)

_TREE_ATTRS = (
    "parent", "nx", "nu", "nc", "Nn", "nxm", "num", "ncm", "nzm", "stage",
    "Nh", "nkids", "kids", "sib_index", "Kmax", "group_nodes", "num_groups",
    "group_of_parent", "group_of_node", "kids_padded", "kids_valid",
    "group_stage", "groups_by_stage", "group_dad", "group_slot", "x_mask",
    "u_mask", "c_mask", "nonroot_x_mask", "realization",
    "multistage_params", "stage_start")


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("make", [
    lambda T: T.multistage(4, 4, 20, 6, 4),
    lambda T: T.multistage(3, 2, 5, 2, 1, nc=1),
    lambda T: T.from_parent([-1, 0, 0, 1, 1, 2], [2, 3, 3, 1, 2, 2],
                            [1, 2, 0, 0, 0, 0]),
], ids=["quadcopter_256", "small_multistage", "irregular"])
def test_tree_structure_matches_jax(make):
    tj, tt = make(JTree), make(TreeStructure)
    for attr in _TREE_ATTRS:
        assert _same(getattr(tt, attr), getattr(tj, attr)), attr
    assert convert.topo_from(tj) == tt
    if tt.multistage_params is not None:
        assert number_of_nodes_multistage(*tt.multistage_params) == tt.Nn


def test_quadcopter_model_matches_jax():
    """Linearization (torch.autograd vs jax.jacobian), discretization
    (torch.linalg.matrix_exp vs jax.scipy expm) and the LTI tree fill give
    the same QP data to 1e-12."""
    jm = jmodels.quadcopter(2, 2, 6)
    tm_ = models.quadcopter(2, 2, 6, device="cpu")
    assert tm_.qp.topo == convert.topo_from(jm.qp.topo)
    ja, ta = convert.qp_arrays(jm.qp), convert.qp_arrays(tm_.qp)
    for f in QP_FIELDS:
        np.testing.assert_allclose(ta[f], ja[f], rtol=0, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(tm_.x0, jm.x0)
    par = jmodels._quadcopter_params(9.0)
    w = 40.0 * np.ones(4)
    xl = np.array([0.01, -0.02, 0.03, 0.1, -0.2, 0.3])
    Aj, Bj = jmodels.linearize(jmodels._quadcopter_rhs(par), xl, w)
    At, Bt = models.linearize(models._quadcopter_rhs(par), xl, w)
    np.testing.assert_allclose(At, Aj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Bt, Bj, rtol=0, atol=1e-12)
    Adj, Bdj = jmodels.discretize(Aj, Bj, 0.05)
    Adt, Bdt = models.discretize(At, Bt, 0.05)
    np.testing.assert_allclose(Adt, Adj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Bdt, Bdj, rtol=0, atol=1e-12)


def test_kkt_oracle_matches_jax():
    """Every residual family on random data with general constraints."""
    rng = np.random.default_rng(0)
    topo_j = JTree.multistage(2, 2, 4, 3, 2, nc=2)
    topo = convert.topo_from(topo_j)
    zero = JTreeQPIn.zeros(topo_j)
    zero_t = convert.qp_arrays(TreeQPIn.zeros(topo))
    for f in QP_FIELDS:
        np.testing.assert_array_equal(zero_t[f], np.asarray(getattr(zero, f)), err_msg=f)
    arrays = {f: rng.standard_normal(zero_t[f].shape) for f in QP_FIELDS}
    for lo, hi in (("xmin", "xmax"), ("umin", "umax"), ("dmin", "dmax")):
        arrays[lo], arrays[hi] = -np.abs(arrays[lo]), np.abs(arrays[hi])
    out = {f: rng.standard_normal(s) for f, s in zip(
        OUT_FIELDS, [(topo.Nn, topo.nxm), (topo.Nn, topo.num),
                     (topo.Nn, topo.nxm), (topo.Nn, topo.nxm),
                     (topo.Nn, topo.num), (topo.Nn, topo.ncm)])}
    qp_j = JTreeQPIn(**{f: jnp.asarray(v) for f, v in arrays.items()}, topo=topo_j)
    out_j = JTreeQPOut(**{f: jnp.asarray(v) for f, v in out.items()}, info={})
    qp_t = convert.qp_from_numpy(arrays, topo, device="cpu")
    out_t = TreeQPOut(**{f: torch.as_tensor(v) for f, v in out.items()}, info={})
    ref = jkkt.kkt_residuals(qp_j, out_j)
    got = kkt.kkt_residuals(qp_t, out_t)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-12, err_msg=k)
    assert abs(kkt.max_kkt_residual(qp_t, out_t)
               - float(jkkt.max_kkt_residual(qp_j, out_j))) <= 1e-12


@pytest.mark.parametrize("make", [
    lambda: jmodels.quadcopter(2, 2, 6).qp,
    lambda: jmodels.spring_mass_chain(nm=2, md=3, Nr=2, Nh=8)[0],
], ids=["quadcopter", "spring_mass_chain"])
def test_split_multistage_matches_jax(make):
    qp_j = make()
    ms_j = jtm.split_multistage(qp_j)
    qp_t = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                                 device="cpu")
    ms_t = tm.split_multistage(qp_t)
    a_j, a_t = convert.ms_arrays(ms_j), convert.ms_arrays(ms_t)
    assert set(a_j) == set(a_t)
    for f in tm.CHAIN_FIELDS:
        np.testing.assert_array_equal(a_t[f], a_j[f], err_msg=f)
    for f in QP_FIELDS:
        np.testing.assert_array_equal(a_t["crown"][f], a_j["crown"][f], err_msg=f)
    mj, mt = ms_j.meta, ms_t.meta
    assert (mt.md, mt.Nr, mt.Nh, mt.S, mt.L, mt.nx, mt.nu, mt.root_ids) == \
        (mj.md, mj.Nr, mj.Nh, mj.S, mj.L, mj.nx, mj.nu, mj.root_ids)
    assert mt.crown_topo == convert.topo_from(mj.crown_topo)
    np.testing.assert_array_equal(tm.chain_node_ids(mt), jtm.chain_node_ids(mj))
    # the round trip through numpy rebuilds the same split
    ms_r = convert.ms_from_numpy(a_t, qp_t.topo, device="cpu")
    for f in tm.CHAIN_FIELDS:
        assert torch.equal(getattr(ms_r, f), getattr(ms_t, f)), f
    assert ms_r.meta == ms_t.meta


def test_split_multistage_rejects_general_rows():
    """A tree with general C/D rows splits with the rows carried in stacked
    chain tensors, as the JAX split does (the multistage IPM reads them);
    the multistage dual Newton rejects the split."""
    from treeqp_tpu_torch.solvers import tdunes as td
    topo = TreeStructure.multistage(2, 1, 3, 2, 1, nc=1)
    qp = TreeQPIn.zeros(topo)
    ms = tm.split_multistage(qp)
    ms_j = jtm.split_multistage(JTreeQPIn.zeros(JTree.multistage(2, 1, 3, 2, 1, nc=1)))
    assert ms.C.shape == (ms.meta.S, ms.meta.L, topo.ncm, topo.nxm)
    for f in tm.GENERAL_FIELDS:
        np.testing.assert_array_equal(getattr(ms, f).numpy(), np.asarray(getattr(ms_j, f)))
    with pytest.raises(ValueError, match="ipm_ms_solve"):
        tm.tdunes_ms_solve(ms, None, None, td.TdunesOpts(
            factor_dtype="float32", chain_backend="pallas", reg_type="always"))


def test_port_imports_no_jax():
    code = ("import sys; import treeqp_tpu_torch, treeqp_tpu_torch.convert, "
            "treeqp_tpu_torch.models, treeqp_tpu_torch.ops.chain_kernels, "
            "treeqp_tpu_torch.ops.crown_kernels, "
            "treeqp_tpu_torch.ops.system_kernels, treeqp_tpu_torch.ops.riccati_kernels, "
            "treeqp_tpu_torch.ops.crown_riccati, treeqp_tpu_torch.solvers.ipm_multistage, "
            "treeqp_tpu_torch.core.soft; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'treeqp_tpu' not in sys.modules; "
            "import torch; assert not torch.backends.cuda.matmul.allow_tf32; "
            "assert not torch.backends.cudnn.allow_tf32; "
            "assert torch.get_float32_matmul_precision() == 'highest'")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

"""PyTorch port, the ADMM active-set identification of the general stage
QPs: the plain twin of the CUDA kernel (``admm_identify_ref``, what the
wrapper runs on CPU tensors) against the JAX Pallas kernel
``treeqp_tpu.ops.qpgen_lanes.admm_identify`` (interpret mode) on the same
operands, handed to the Pallas kernel in its lane layout (nodes on the
last axis); the wrapper's shape checks. Also the general C/D instances of
test_torch_qpgen_stage.py and test_torch_general_solve.py.

The operands are those of the cold start of ``_qpgen_batch``: the JAX
package's stage data (qpgen_factor_dtype="float32": the ADMM factor and
the loop in f32) at a dual point, on
``with_general_rows(spring_mass_chain(2, 2, 2, 5))`` (a row on every node;
N = 19 stage QPs) and on general_cd_bench's mixed instance at the same
dims (a row on every third node; its 6 general nodes, the subset the mixed
stage solve hands to the kernel)."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks import general_cd_bench as gcb
from benchmarks import models as jmodels
from treeqp_tpu.core.qp_data import TREEQP_INF
from treeqp_tpu.ops import qpgen_lanes as jql
from treeqp_tpu.solvers import tdunes as jtd

from treeqp_tpu_torch import models
from treeqp_tpu_torch.ops import qpgen_lanes as ql

torch.set_num_threads(1)

DIMS = (2, 2, 2, 5)  # nm, md, Nr, Nh
ITERS = 100          # qpgen_iters of the headline options
# f32 on both sides in the same order of operations: the twin agrees with
# the interpret-mode kernel to a few f32 ulps of the largest multiplier
RTOL = 1e-6
# the cold start's activity threshold at f32 identification (_qpgen_batch)
TOL_ACT = 1e-5


@functools.lru_cache(maxsize=None)
def jax_cd(mode, dims=DIMS, cmax=0.3):
    """The JAX package's general C/D instance: ``mode="qpgen"`` a row on
    every node (benchmarks.models.with_general_rows, +-cmax), ``"mixed"``
    general_cd_bench's mixed instance (a row on every third non-root node,
    +-0.6) at these dims."""
    nm, md, Nr, Nh = dims
    if mode == "qpgen":
        qp0 = jmodels.spring_mass_chain(nm=nm, md=md, Nr=Nr, Nh=Nh)[0]
        return jmodels.with_general_rows(qp0, cmax=cmax)
    with mock.patch.multiple(gcb, NM=nm, MD=md, NR=Nr, NH=Nh):
        return gcb.build("tdunes_mixed")


def port_cd(mode, dims=DIMS, cmax=0.3):
    """The port's builders of the same instance, on the CPU."""
    qp0 = models.spring_mass_chain(*dims, device="cpu")[0]
    return models.with_general_rows(qp0, cmax) if mode == "qpgen" else \
        models.with_sparse_rows(qp0)


def jax_opts(mode, **over):
    o = jtd.TdunesOpts(stage_solver=mode, qpgen_factor_dtype="float32", **over)
    if mode == "mixed":
        o = jtd.dataclasses.replace(o, node_solver=jtd.clipping_applicable_nodes(jax_cd(mode)))
    return o


def dual_point(qp_j, point):
    """lambda = 0 (the first iterate) or a seeded random dual point."""
    shape = (qp_j.topo.Nn, qp_j.topo.nxm)
    if point == "first":
        return np.zeros(shape)
    return np.random.default_rng(0).standard_normal(shape)


@functools.lru_cache(maxsize=None)
def admm_operands(mode, point):
    """The kernel's f32 operands at the cold start of the general nodes'
    stage QPs (numpy, node-major), and what derives the working sets from
    its output (rho, m_lo, m_hi, m_eq in f64)."""
    qp_j = jax_cd(mode)
    o = jax_opts(mode)
    prep = jtd._get_prep(qp_j.topo)
    data = jtd._stage_data(qp_j, o)
    qmod, rmod = jtd._modified_gradient(qp_j, jnp.asarray(dual_point(qp_j, point)), prep)
    hmod = np.concatenate([np.asarray(qmod), np.asarray(rmod)], axis=1)
    d = {k: np.asarray(data[k]) for k in ("Hinv", "G", "lo", "hi", "m_lo", "m_hi",
                                          "rho_row", "L_admm")}
    idx = np.arange(qp_j.topo.Nn) if mode == "qpgen" else \
        np.nonzero(np.asarray(o.node_solver) == 0)[0]
    d = {k: v[idx] for k, v in d.items()}
    hmod = hmod[idx]
    lo_c = np.where(d["m_lo"] > 0, d["lo"], -TREEQP_INF)
    hi_c = np.where(d["m_hi"] > 0, d["hi"], TREEQP_INF)
    f32 = lambda v: np.ascontiguousarray(v, dtype=np.float32)
    ops = dict(G=f32(d["G"]), L=f32(d["L_admm"]), rho=f32(d["rho_row"]), lo=f32(lo_c),
               hi=f32(hi_c), h=f32(hmod), z0=f32(np.einsum("nij,nj->ni", d["Hinv"], hmod)))
    m_eq = ((hi_c - lo_c <= 1e-14) & (d["m_lo"] > 0) & (d["m_hi"] > 0)).astype(float)
    return ops, dict(rho=d["rho_row"], m_lo=d["m_lo"], m_hi=d["m_hi"], m_eq=m_eq)


def pallas_lm(ops):
    """The Pallas kernel (interpret mode) on the operands in its lane
    layout [.., N]; lm back node-major."""
    lane = lambda v: jnp.asarray(np.moveaxis(v, 0, -1))
    lm = jql.admm_identify(*(lane(ops[k]) for k in ("G", "L", "rho", "lo", "hi", "h", "z0")),
                           ITERS)
    return np.asarray(lm).T


def working_sets(lm, aux):
    """_qpgen_batch's cold-start masks (m_up, m_dn) from the ADMM output."""
    mu = aux["rho"] * lm.astype(np.float64)
    tol = TOL_ACT * np.maximum(np.abs(mu).max(axis=1, keepdims=True), 1.0)
    up = ((mu > tol) & (aux["m_hi"] > 0)) * (1.0 - aux["m_eq"])
    dn = ((mu < -tol) & (aux["m_lo"] > 0)) * (1.0 - aux["m_eq"])
    return up, dn


@pytest.mark.parametrize("point", ["first", "random"])
@pytest.mark.parametrize("mode", ["qpgen", "mixed"], ids=["every_node", "every_third_node"])
def test_admm_twin_matches_pallas(mode, point):
    ops, aux = admm_operands(mode, point)
    ref = pallas_lm(ops)
    got = ql.admm_identify_ref(*(torch.from_numpy(ops[k]) for k in
                                 ("G", "L", "rho", "lo", "hi", "h", "z0")), ITERS).numpy()
    assert got.shape == ref.shape == ops["rho"].shape
    assert np.isfinite(got).all()
    bound = RTOL * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= bound
    # the masks derived from both agree exactly; at the random point the
    # identification finds active general rows (at the cold start of the
    # mixed instance's general nodes none is active yet)
    up_g, dn_g = working_sets(got, aux)
    up_r, dn_r = working_sets(ref, aux)
    assert (up_r + dn_r)[:, -1].sum() > 0 or point == "first"
    np.testing.assert_array_equal(up_g, up_r)
    np.testing.assert_array_equal(dn_g, dn_r)


def test_wrapper_runs_the_twin_on_the_cpu():
    """On CPU tensors the wrapper runs the twin (bit for bit) and counts no
    launch; f64 operands (qpgen_factor_dtype="same") take the same path."""
    ops, _ = admm_operands("qpgen", "random")
    args = [torch.from_numpy(ops[k]) for k in ("G", "L", "rho", "lo", "hi", "h", "z0")]
    n0 = ql.admm_identify.launches
    assert torch.equal(ql.admm_identify(*args, 7), ql.admm_identify_ref(*args, 7))
    args64 = [a.double() for a in args]
    assert torch.equal(ql.admm_identify(*args64, 7), ql.admm_identify_ref(*args64, 7))
    assert ql.admm_identify.launches == n0


@pytest.mark.parametrize("bad", ["nz", "ng", "ng_below_nz", "dtype", "shape", "iters"])
def test_wrapper_rejects_bad_operands(bad):
    """The kernel's bounds (nz <= 16, nz <= ng <= 32) and the operands'
    shapes and types are checked on every device, before any launch."""
    N, ng, nz = 3, 10, 9
    if bad == "nz":
        ng, nz = ql.MAX_NZ + 2, ql.MAX_NZ + 1
    elif bad == "ng":
        ng = ql.MAX_NG + 1
    elif bad == "ng_below_nz":
        ng = nz - 1
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    args = [z(N, ng, nz), z(N, nz, nz), z(N, ng), z(N, ng), z(N, ng), z(N, nz), z(N, nz)]
    iters = -1 if bad == "iters" else 5
    if bad == "dtype":
        args = [a.half() for a in args]
    elif bad == "shape":
        args[1] = z(N, nz, nz + 1)
    with pytest.raises(ValueError, match="admm_identify"):
        ql.admm_identify(*args, iters)


# The CUDA kernel's edges (csrc/admm_identify.cu: one instantiation per nz,
# 16 lanes a node for ng <= 16, 32 beyond), the shapes and seeded operands
# the smoke holds the kernel to its twin at: one column, sixteen, ng = nz,
# the 32-lane form and the widest
EDGES = {f"N{N}_ng{ng}_nz{nz}": (k, (N, ng, nz))
         for k, (N, ng, nz) in enumerate(chip_smoke.ADMM_EDGES)}
KEYS = ("G", "L", "rho", "lo", "hi", "h", "z0")


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_admm_twin_matches_pallas_at_kernel_edges(edge):
    """The f32 twin against the interpret-mode Pallas kernel at the CUDA
    kernel's edge shapes, on ``chip_smoke.admm_operands``."""
    k, shape = EDGES[edge]
    args = chip_smoke.admm_operands(torch, *shape, torch.float32, k, torch.device("cpu"))
    ref = pallas_lm(dict(zip(KEYS, (a.numpy() for a in args))))
    got = ql.admm_identify_ref(*args, ITERS).numpy()
    assert got.shape == ref.shape == tuple(args[2].shape)
    assert np.isfinite(got).all() and (np.abs(ref) > 0).any()
    assert float(np.abs(got - ref).max()) <= RTOL * max(1.0, float(np.abs(ref).max()))


def test_admm_twin_f64_matches_jax_node_major_loop():
    """The f64 twin (qpgen_factor_dtype="same" on f64 data) against the
    JAX package's node-major ADMM loop of ``_qpgen_batch``'s cold start in
    f64 (batched triangular solves and einsums: another order of
    summation), at the widest edge (the 32-lane form)."""
    k = len(chip_smoke.ADMM_EDGES) - 1
    args = chip_smoke.admm_operands(torch, *chip_smoke.ADMM_EDGES[k], torch.float64, k,
                                    torch.device("cpu"))
    G, L, rho, lo, hi, h, z0 = (jnp.asarray(a.numpy()) for a in args)

    def z_update(v):
        return jax.lax.linalg.triangular_solve(
            L, jax.lax.linalg.triangular_solve(L, v[..., None], left_side=True, lower=True),
            left_side=True, lower=True, transpose_a=True)[..., 0]

    def admm_step(_, carry):
        z, y, lm = carry
        z = z_update(h + jnp.einsum("ngz,ng->nz", G, rho * (y - lm)))
        t = jnp.einsum("ngz,nz->ng", G, z) + lm
        y = jnp.clip(t, lo, hi)
        return (z, y, t - y)

    y0 = jnp.clip(jnp.einsum("ngz,nz->ng", G, z0), lo, hi)
    _, _, lm = jax.lax.fori_loop(0, ITERS, admm_step, (z0, y0, jnp.zeros_like(y0)))
    ref = np.asarray(lm)
    assert ref.dtype == np.float64
    got = ql.admm_identify_ref(*args, ITERS).numpy()
    assert got.dtype == np.float64 and np.isfinite(got).all()
    assert float(np.abs(got - ref).max()) <= RTOL * max(1.0, float(np.abs(ref).max()))

"""PyTorch port, the IPM past nz = 16: ``ipm_ms_solve`` and ``ipm_solve``
on the reference's largest linear chain (treeqp_performance_plot's nm = 8,
nu = 7: nx = 16, nz = 23), cut to linear_chain(nm=8, nu_count=7, md=2,
Nr=2, Nh=10) (39 nodes, 4 chains of 8), against the JAX package.

Mode "f32" runs the port at ``models.IPM_OPTS["box"]`` (f32 factors,
chain_backend "pallas"): on the CPU the twins of the chain and crown
Riccati kernels, whose CUDA kernels take nz <= 32 on the card. JAX runs
the same options at chain_backend "xla", its plain Riccati, which is what
it takes past nz = 16 itself. Mode "f64" runs both packages' plain
Riccati with f64 factors.

Tolerances (ROADMAP): x and u within 1e-7, lam within 1e-6, each output
certified by both packages' KKT oracles below 1e-8. Iterations: equal in
f64. In f32 the f32 phase's length is decided by the Riccati's summation
order at this width, not by the port: JAX's own two chain backends take 17
(xla) and 23 (pallas, interpret mode) iterations on this ipm_ms instance,
the port's twins (the Pallas kernels' order) 23; on ipm_solve JAX takes 20,
the port 22 (twins) or 17 (plain). So f32 counts are not held."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.core.qp_data import TreeQPOut as JTreeQPOut
from treeqp_tpu.solvers import ipm as jipm
from treeqp_tpu.solvers import ipm_multistage as jims
from treeqp_tpu.solvers import tdunes_multistage as jtm

from treeqp_tpu_torch import IpmOpts, convert, ipm_ms_solve, ipm_solve, merge_output, models
from treeqp_tpu_torch import split_multistage
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.core.qp_data import TreeQPOut
from treeqp_tpu_torch.ops import crown_riccati as crk
from treeqp_tpu_torch.ops import riccati_kernels as rk

torch.set_num_threads(1)

SHAPE = dict(nm=8, nu_count=7, md=2, Nr=2, Nh=10)
OPTS = {"f32": models.IPM_OPTS["box"],
        "f64": {**models.IPM_OPTS["box"], "factor_dtype": None, "chain_backend": "xla"}}
TOL = dict(x=1e-7, u=1e-7, lam=1e-6)
KKT = 1e-8
FIELDS = ("x", "u", "lam", "mu_x", "mu_u", "mu_d")
TWINS = ((rk, "ric_chain_factor_ref"), (crk, "crown_ric_factor_ref"))


@functools.lru_cache(maxsize=None)
def instance():
    """(JAX qp, port qp) of the same generator arguments."""
    return jmodels.linear_chain(**SHAPE).qp, models.linear_chain(**SHAPE, device="cpu").qp


@functools.lru_cache(maxsize=None)
def solve_both(solver, mode):
    """(JAX output, port output, the port's calls of the Riccati factor
    twins) of ``solver`` ("ipm_ms" or "ipm") in ``mode``."""
    qp_j, qp = instance()
    opts = {k: v for k, v in OPTS[mode].items() if v is not None}
    opts_j = jipm.IpmOpts(**{**opts, "chain_backend": "xla"})
    calls = {name: 0 for _, name in TWINS}
    orig = {name: getattr(mod, name) for mod, name in TWINS}

    def counted(name):
        def w(*a, **k):
            calls[name] += 1
            return orig[name](*a, **k)
        return w
    try:
        for mod, name in TWINS:
            setattr(mod, name, counted(name))
        if solver == "ipm_ms":
            ms_j = jtm.split_multistage(qp_j)
            out_j = jtm.merge_output(ms_j, *jims.ipm_ms_solve(ms_j, opts_j))
            ms = split_multistage(qp)
            out = merge_output(ms, *ipm_ms_solve(ms, IpmOpts(**opts)))
        else:
            out_j = jipm.ipm_solve(qp_j, opts_j)
            out = ipm_solve(qp, IpmOpts(**opts))
    finally:
        for mod, name in TWINS:
            setattr(mod, name, orig[name])
    return out_j, out, calls


def test_instance_is_past_the_old_bound():
    """nx = 16, nu = 7 on every node: nz = 23, past the 16-row
    instantiations and within the kernels' 32."""
    _, qp = instance()
    nz = qp.topo.nxm + qp.topo.num
    assert (qp.topo.Nn, qp.topo.nxm, qp.topo.num, nz) == (39, 16, 7, 23)
    assert 16 < nz <= rk._MAX_NZ


@pytest.mark.parametrize("mode", sorted(OPTS))
@pytest.mark.parametrize("solver", ["ipm_ms", "ipm"])
def test_ipm_nz23_matches_jax(solver, mode):
    """Status 0 on both sides; in f32 the port through the Riccati twins
    (the chain twins on ipm_ms, the crown twin on both), in f64 through
    neither and at JAX's iteration count; x and u within 1e-7, lam within
    1e-6, and both outputs below 1e-8 by both KKT oracles."""
    qp_j, qp = instance()
    out_j, out, calls = solve_both(solver, mode)
    info_j, info = out_j.info, out.info
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert (info["iter_f32"] > 0) == (mode == "f32")
    if mode == "f64":
        assert int(info_j["iter"]) == info["iter"]
    assert (calls["crown_ric_factor_ref"] > 0) == (mode == "f32")
    assert (calls["ric_chain_factor_ref"] > 0) == (mode == "f32" and solver == "ipm_ms")
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    for f in ("x", "u", "lam"):
        assert np.abs(a[f] - b[f]).max() <= TOL[f], f
    for arrs in (a, b):
        as_j = JTreeQPOut(**{f: jnp.asarray(arrs[f]) for f in FIELDS}, info={})
        as_t = TreeQPOut(**{f: torch.as_tensor(arrs[f]) for f in FIELDS}, info={})
        assert float(jax_kkt(qp_j, as_j)) < KKT and max_kkt_residual(qp, as_t) < KKT

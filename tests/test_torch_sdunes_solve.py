"""PyTorch port, sdunes whole solves against the JAX package on
spring_mass_chain(2, 2, 3, 8) (8 scenarios, nx = 4, nu = 1, state bounds
active), at sdunes_bench's options on the card (``models.SDUNES_OPTS``:
f32 factors, two refinement steps, a coarse f32 phase to 1e-4, the
kernels' twins).

* The cold two-phase solve against JAX's ``chain_backend="pallas"`` (the
  Pallas kernels in interpret mode; ~60 s on the CPU, most of it compile):
  iterations (both phases) within one, x and u within 1e-7 and lam within
  1e-6 after ``scenario_output``, KKT below 1e-8 from both oracles.
* The sdunes_f32 mode (f32 data, cold, tol 1e-3, no coarse phase) against
  JAX's ``chain_backend="xla"`` (~3 s): iterations within one, x and u
  within 1e-5. The XLA path adds the shift to the equilibrated banded
  blocks a second time, where the Pallas path and the port add none, so
  the two f32 trajectories are not the same; at tol 1e-3 in f32 the
  iterates carry ~1e-6 of f32 rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.solvers import sdunes as jsd

from treeqp_tpu_torch import convert, models
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.solvers import sdunes as sd

torch.set_num_threads(1)

KKT = 1e-8
GAP = dict(x=1e-7, u=1e-7, lam=1e-6)
F32_GAP = 1e-5


@functools.lru_cache(maxsize=None)
def instance():
    qp_j, _ = jmodels.spring_mass_chain(nm=2, md=2, Nr=3, Nh=8)
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    return qp_j, qp, jsd.scenario_data(qp_j), sd.scenario_data(qp)


@functools.lru_cache(maxsize=None)
def cold_two_phase():
    """Both packages' cold two-phase solve; JAX through its Pallas kernels."""
    qp_j, qp, sqp_j, sqp = instance()
    sol_j, lam_j, mu_j, info_j = jsd.sdunes_solve(sqp_j, None, None,
                                                  jsd.SdunesOpts(**models.SDUNES_OPTS))
    info_j = {k: float(v) for k, v in info_j.items()}
    out_j = jsd.scenario_output(sqp_j, sol_j, lam_j, mu_j, info_j)
    sol, lam, mu, info = sd.sdunes_solve(sqp, None, None, sd.SdunesOpts(**models.SDUNES_OPTS))
    return out_j, info_j, sd.scenario_output(sqp, sol, lam, mu, info), info


def test_cold_two_phase_matches_pallas_path():
    qp_j, qp, _, _ = instance()
    out_j, info_j, out, info = cold_two_phase()
    assert info["status"] == 0 and info_j["status"] == 0
    assert info["error"] < KKT and info_j["error"] < KKT
    assert abs(info["iter"] - info_j["iter"]) <= 1, (info, info_j)
    assert 0 < info["iter_f32"] < info["iter"]
    for f, tol in GAP.items():
        gap = np.abs(getattr(out, f).numpy() - np.asarray(getattr(out_j, f))).max()
        assert gap <= tol, (f, gap)
    out_np = convert.out_to_numpy(out)
    out_as_j = out_j.__class__(**{f: jnp.asarray(v) for f, v in out_np.items()}, info={})
    assert max_kkt_residual(qp, out) < KKT
    assert float(jax_kkt(qp_j, out_as_j)) < KKT  # the JAX oracle on the port's output
    assert float(jax_kkt(qp_j, out_j)) < KKT


def test_f32_mode_matches_xla_path():
    """sdunes_bench's sdunes_f32 mode: f32 data, cold, tol 1e-3, max_iter
    80, no coarse phase."""
    _, _, sqp_j, sqp = instance()
    opts = {**models.SDUNES_OPTS, "tol": 1e-3, "max_iter": 80, "f32_phase_tol": 0.0}
    sqp32_j = jax.tree_util.tree_map(
        lambda v: v.astype(jnp.float32) if hasattr(v, "dtype")
        and jnp.issubdtype(v.dtype, jnp.floating) else v, sqp_j)
    sol_j, _, _, info_j = jsd.sdunes_solve(
        sqp32_j, None, None, jsd.SdunesOpts(**{**opts, "chain_backend": "xla"}))
    sol, lam, mu, info = sd.sdunes_solve(sqp.to(dtype=torch.float32), None, None,
                                         sd.SdunesOpts(**opts))
    assert lam.dtype == mu.dtype == sol["x"].dtype == torch.float32
    assert info["status"] == 0 and int(info_j["status"]) == 0 and info["iter_f32"] == 0
    assert info["error"] < 1e-3
    assert abs(info["iter"] - int(info_j["iter"])) <= 1, (info, info_j)
    for k in ("x", "u"):
        assert torch.isfinite(sol[k]).all()
        gap = np.abs(sol[k].double().numpy() - np.asarray(sol_j[k])).max()
        assert gap <= F32_GAP, (k, gap)

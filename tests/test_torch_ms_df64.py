"""PyTorch port, the high-precision phase in the whole solve: the port's
``tdunes_ms_solve`` with bench.py's options (``bench_opts(on_tpu=True)``:
the coarse f32 phase, then ``df64_phase``) against the JAX package's with
the same options on the same data, on the quadcopter tree; and the phase
alone (``f32_phase_tol=0``, no handover) on the spring-mass chain. The
spring-mass bench-option solve and the handover's factorization counts are
in tests/test_torch_ms_df64_spring.py (each JAX solve takes ~35-60 s on the
CPU, so the cases are split over two files)."""

import numpy as np
import torch

from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt

from test_torch_tdunes_ms import LAM_TOL, U_TOL, X_TOL, solve_both
from treeqp_tpu_torch import convert
from treeqp_tpu_torch.core.kkt import max_kkt_residual

torch.set_num_threads(1)

# bench_opts(on_tpu=True) over test_torch_tdunes_ms.SLICE
BENCH = dict(f32_phase_tol=1e-4, f32_patience=3, df64_phase=True)


def check_against_jax(name, **overrides):
    """Solve ``name`` with both packages; both OPTIMAL, the same coarse
    iterations and the total within one, both oracles' KKT < 1e-8 and
    agreeing to 1e-12 on the JAX solution, the solutions within the slice
    tolerances. Returns the port's info."""
    qp_j, out_j, info_j, qp, out, info = solve_both(name, **{**BENCH, **overrides})
    assert int(info_j["status"]) == 0 and info["status"] == 0
    assert abs(int(info_j["iter"]) - info["iter"]) <= 1
    assert int(info_j["iter_f32"]) == info["iter_f32"]
    kkt_j = float(jax_kkt(qp_j, out_j))
    kkt = max_kkt_residual(qp, out)
    assert kkt_j < 1e-8 and kkt < 1e-8
    out_jt = out.replace(**{f: torch.tensor(v) for f, v in
                            convert.out_to_numpy(out_j).items()})
    assert abs(max_kkt_residual(qp, out_jt) - kkt_j) <= 1e-12
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    assert np.max(np.abs(a["x"] - b["x"])) <= X_TOL
    assert np.max(np.abs(a["u"] - b["u"])) <= U_TOL
    assert np.max(np.abs(a["lam"] - b["lam"])) <= LAM_TOL
    return info


def test_bench_path_matches_jax_quadcopter():
    info = check_against_jax("quadcopter")
    assert info["iter_f32"] >= 1 and info["iter"] > info["iter_f32"]


def test_df64_phase_alone_matches_jax():
    """No coarse phase, so no handover: the phase factorizes at its start."""
    info = check_against_jax("spring_mass_chain", f32_phase_tol=0.0)
    assert info["iter_f32"] == 0

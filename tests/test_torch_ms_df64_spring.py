"""PyTorch port, the high-precision phase: bench.py's options on the
spring-mass chain against the JAX package (see tests/test_torch_ms_df64.py
for the quadcopter), and the handover of the coarse phase's last
factorization, counted."""

import dataclasses

import pytest
import torch

from test_torch_ms_df64 import BENCH, check_against_jax
from test_torch_tdunes_ms import SLICE, port_ms
from treeqp_tpu_torch.solvers import ms_df64 as md
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)


def test_bench_path_matches_jax_spring_mass_chain():
    info = check_against_jax("spring_mass_chain")
    assert info["iter_f32"] >= 1 and info["iter"] > info["iter_f32"]


@pytest.fixture
def count_factorizations(monkeypatch):
    """The number of ``_ms_factorize`` calls so far (the list's length)."""
    calls = []
    real = tm._ms_factorize

    def counted(*args, **kwargs):
        calls.append(kwargs.get("lanes"))
        return real(*args, **kwargs)
    monkeypatch.setattr(tm, "_ms_factorize", counted)
    return calls


@pytest.mark.parametrize("name", ["quadcopter", "spring_mass_chain"])
def test_handover_skips_the_first_factorization(name, count_factorizations):
    """The phase reuses the coarse phase's last factorization when its first
    active-set pattern equals the coarse phase's last, and factorizes at
    its start when the pattern differs (one bit of the handed-over chain
    set flipped)."""
    ms = port_ms(name)
    opts = td.TdunesOpts(**{**SLICE, **BENCH})
    f32 = torch.float32
    opts32 = dataclasses.replace(opts, refine_steps=0, tol=opts.f32_phase_tol, ls_batch=4)
    meta = ms.meta
    lam_cr, lam_ch, it0, handover = tm._ms_newton_loop_mega(
        ms.to(dtype=f32), torch.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm), dtype=f32),
        torch.zeros_like(ms.q, dtype=f32), opts32, 0, patience=opts.f32_patience)
    assert it0 >= 1
    count_factorizations.clear()
    # the phase's start only: evaluate, factorize or not, take no step
    start = dataclasses.replace(opts, max_iter=it0)
    args = (ms, lam_cr.double(), lam_ch.double(), start, it0)
    md.ms_newton_loop_df(*args, handover=handover)
    assert count_factorizations == []
    fact, sets = handover
    qt = sets[2].clone()
    qt.view(-1)[0] = 1.0 if qt.view(-1)[0] == 0 else 0.0
    md.ms_newton_loop_df(*args, handover=(fact, (sets[0], sets[1], qt, sets[3])))
    assert count_factorizations == [True]
    count_factorizations.clear()
    md.ms_newton_loop_df(*args)
    assert count_factorizations == [True]


def test_bench_solve_factorizes_once_less_with_the_handover(count_factorizations,
                                                            monkeypatch):
    """The whole bench-option solve: the high-precision phase from the coarse
    duals with the handover factorizes once less than without it, and takes
    the same steps."""
    ms = port_ms("quadcopter")
    opts = td.TdunesOpts(**{**SLICE, **BENCH})
    _, cho, info = tm.tdunes_ms_solve(ms, None, None, opts)
    with_handover = len(count_factorizations)
    count_factorizations.clear()
    orig = md.ms_newton_loop_df
    monkeypatch.setattr(md, "ms_newton_loop_df",
                        lambda *args, handover=None: orig(*args))
    _, cho2, info2 = tm.tdunes_ms_solve(ms, None, None, opts)
    assert len(count_factorizations) == with_handover + 1
    assert info2["iter"] == info["iter"] and info["status"] == info2["status"] == 0
    assert torch.allclose(cho2["lam"], cho["lam"], rtol=0, atol=1e-6)

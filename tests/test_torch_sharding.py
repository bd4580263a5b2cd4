"""The port's scenario sharding (``treeqp_tpu_torch.parallel.sharding``)
and rank launcher (``parallel.launcher``), on CPU gloo ranks: the split of
the chains and scenarios, the shard context's collectives and their byte
counts, the launcher's failure handling, the routing under ``axis_name``
(the JAX package's route; the three sharded solvers raise without a
registered group, the generic solvers do not read it).

The rank functions live in this module, which imports no JAX, so that a
spawned rank imports it cheaply."""

import dataclasses
import time

import pytest
import torch
import torch.distributed as dist

from treeqp_tpu_torch import (IpmOpts, SdunesOpts, ipm_ms_solve, ipm_solve, merge_output,
                              scenario_data, sdunes_solve, split_multistage,
                              tdunes_ms_solve, tdunes_solve)
from treeqp_tpu_torch.models import spring_mass_chain
from treeqp_tpu_torch.parallel import sharding
from treeqp_tpu_torch.parallel.launcher import run_ranks
from treeqp_tpu_torch.parallel.shard_solver import gather_chain_outputs, tdunes_ms_solve_shmap
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

TREE = (4, 2, 3, 8)  # 8 scenarios, chains of 5
OPTS = dict(stage_solver="clipping", tol=1e-8, max_iter=30)
BENCH = dict(OPTS, max_iter=120, factor_dtype="float32", refine_steps=2,
             refine_safeguard=False, chain_backend="pallas", reg_type="always",
             reg_value=1e-6, f32_phase_tol=1e-4, f32_patience=3, df64_phase=True)


def tree():
    qp, _ = spring_mass_chain(*TREE, device="cpu")
    return qp, split_multistage(qp)


# ---------------------------------------------------------------------------
# rank functions (run in spawned ranks)


def _collectives(mesh):
    """Every collective of the shard context on rank-dependent values, with
    the byte count after each."""
    r, w = mesh.rank, mesh.world
    sh = sharding.Shard(mesh, 3)
    out = {}
    out["psum"] = sh.psum(torch.tensor(float(r + 1), dtype=torch.float64))
    out["pmax"] = sh.pmax(torch.tensor([r, -r], dtype=torch.float64))
    out["pmin"] = sh.pmin(torch.tensor([r, -r], dtype=torch.float32))
    out["gather"] = sh.gather_s(torch.arange(3 * 2, dtype=torch.float32).reshape(3, 2) + 10 * r)
    out["all_true"] = sh.all_true(True)
    out["some_false"] = sh.all_true(r != w - 1)
    out["slice"] = sh.slice_s(torch.arange(3 * w))
    out["counts"] = (sh.bytes, sh.calls, sh.max_call)
    out["tensor_flag"] = sh.all_true(torch.tensor(r != w - 1))
    out["threads"] = torch.get_num_threads()
    out["backend"], out["device"] = mesh.backend, str(mesh.device)
    return out


def _deadlock(mesh):
    """Rank 0 waits in an all-reduce that no other rank joins."""
    if mesh.rank == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(30)
    return mesh.rank


def _raise_on_last(mesh):
    if mesh.rank == mesh.world - 1:
        raise ValueError("rank failure on purpose")
    return mesh.rank


def _gathered_solve(mesh, ms, opts):
    """tdunes_ms_solve_shmap on the rank's chains, the chain outputs
    gathered back on every rank."""
    local = sharding.shard_multistage(ms, mesh.rank, mesh.world)
    cro, cho, info = tdunes_ms_solve_shmap(local, None, None, opts, mesh)
    return cro, gather_chain_outputs(cho, mesh), info


# ---------------------------------------------------------------------------
# sharding


def test_shard_multistage_splits_the_chains():
    """Each rank gets S / world consecutive chains, the crown and the
    global meta whole; the parts concatenate back to the whole. S that
    does not split raises."""
    _, ms = tree()
    for world in (1, 2, 4, 8):
        parts = [sharding.shard_multistage(ms, r, world) for r in range(world)]
        for p in parts:
            assert p.q.shape[0] == ms.meta.S // world and p.meta is ms.meta
            assert p.crown is ms.crown
        for f in tm.CHAIN_FIELDS:
            assert torch.equal(torch.cat([getattr(p, f) for p in parts]), getattr(ms, f)), f
    with pytest.raises(ValueError, match="do not split"):
        sharding.shard_multistage(ms, 0, 3)


def test_shard_scenarios_splits_the_scenarios():
    qp, _ = tree()
    sqp = scenario_data(qp)
    parts = [sharding.shard_scenarios(sqp, r, 4) for r in range(4)]
    for f in ("Qd", "q", "A", "b", "umax"):
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]), getattr(sqp, f)), f
    assert all(p.meta is sqp.meta and p.b.shape[0] == 2 for p in parts)
    with pytest.raises(ValueError, match="do not split"):
        sharding.shard_scenarios(sqp, 0, 3)


def test_rank_device():
    """The CPU only when asked for; without a card CUDA raises."""
    assert sharding.rank_device(3, 4, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.rank_device(0, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_ranks(2, _raise_on_last)


def test_model_bytes_per_iter():
    """The communication model's figure (benchmarks/scaling_analysis.py):
    S (nx + nu) 4 + S nx^2 4 + 48 bytes, 47,152 at the headline."""
    assert sharding.model_bytes_per_iter(256, 6, 4) == 256 * 10 * 4 + 256 * 36 * 4 + 48 == 47152


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_over_gloo_ranks(world):
    """psum / pmax / pmin / gather_s / all_true / slice_s over CPU ranks,
    each rank on one thread; every collective counted (an all-reduce its
    operand's bytes, an all-gather the gathered tensor's)."""
    outs = run_ranks(world, _collectives, device="cpu", timeout=120)
    gathered = torch.cat([torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
                          for r in range(world)])
    for r, o in enumerate(outs):
        assert o["psum"].item() == world * (world + 1) / 2
        assert o["pmax"].tolist() == [world - 1, 0] and o["pmin"].tolist() == [0, 1 - world]
        assert torch.equal(o["gather"], gathered)
        assert o["all_true"] is True and o["some_false"] is False
        assert isinstance(o["tensor_flag"], torch.Tensor) and not o["tensor_flag"]
        assert o["slice"].tolist() == list(range(3 * r, 3 * r + 3))
        # psum 8 + pmax 16 + pmin 8 + gather world*24 + two all_true 4 each
        assert o["counts"] == (8 + 16 + 8 + world * 24 + 8, 6, max(16, world * 24))
        assert o["threads"] == 1 and o["backend"] == "gloo" and o["device"] == "cpu"


def test_one_device_context_is_the_identity():
    """Without axis_name the solvers run the same code with ONE_DEVICE:
    every collective returns its operand itself, all_true its flag, and
    nothing is counted."""
    sh = sharding.shard_for(None, 8)
    assert sh is sharding.ONE_DEVICE and sh.start == 0
    v = torch.arange(6.0).reshape(3, 2)
    for op in (sh.psum, sh.pmax, sh.pmin, sh.gather_s, sh.slice_s):
        assert op(v) is v
    flag = torch.tensor(False)
    assert sh.all_true(True) is True and sh.all_true(flag) is flag
    assert sh.summary(4) == dict(bytes=0, calls=0, max_call=0, bytes_per_iter=0.0)


def test_deadlocked_collective_fails_the_run():
    """A collective that no other rank joins ends the run with an error
    after the collective timeout instead of hanging."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed|exited with code"):
        run_ranks(2, _deadlock, device="cpu", timeout=120, collective_timeout=5)
    assert time.monotonic() - t0 < 60


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*on purpose"):
        run_ranks(2, _raise_on_last, device="cpu", timeout=120, collective_timeout=30)


def test_gather_chain_outputs_merges_to_the_one_device_solve():
    """Every rank gathers the chain outputs back: merge_output of the
    sharded solve equals the one-device solve within 1e-9, on every rank."""
    qp, ms = tree()
    opts = td.TdunesOpts(**OPTS)
    ref = merge_output(ms, *tdunes_ms_solve(ms, None, None, opts))
    for cro, cho, info in run_ranks(2, _gathered_solve, ms, opts, device="cpu", timeout=120):
        out = merge_output(ms, cro, cho, info)
        assert info["iter"] == ref.info["iter"] and info["status"] == 0
        assert float((out.x - ref.x).abs().max()) <= 1e-9
        assert info["comm"]["calls"] > 0 and info["comm"]["bytes"] > 0


# ---------------------------------------------------------------------------
# routing under axis_name


def test_sharded_solvers_raise_without_a_group():
    """axis_name names a process group; with none registered under it the
    three sharded solvers raise."""
    qp, ms = tree()
    with pytest.raises(LookupError, match="no process group"):
        tdunes_ms_solve(ms, None, None, td.TdunesOpts(**OPTS, axis_name="scen"))
    with pytest.raises(LookupError, match="no process group"):
        ipm_ms_solve(ms, IpmOpts(axis_name="scen"))
    with pytest.raises(LookupError, match="no process group"):
        sdunes_solve(scenario_data(qp), None, None, SdunesOpts(axis_name="scen"))


def test_generic_solvers_do_not_read_axis_name():
    """As in the JAX package, tdunes_solve and ipm_solve do not read
    axis_name: the solve with it is the solve without it, bit for bit."""
    qp, _ = tree()
    a = tdunes_solve(qp, None, td.TdunesOpts(**OPTS, axis_name="scen"))
    b = tdunes_solve(qp, None, td.TdunesOpts(**OPTS))
    assert a.info["iter"] == b.info["iter"] and torch.equal(a.x, b.x)
    a = ipm_solve(qp, IpmOpts(axis_name="scen"))
    b = ipm_solve(qp, IpmOpts())
    assert a.info["iter"] == b.info["iter"] and torch.equal(a.x, b.x)


def test_axis_takes_the_jax_route():
    """Under an axis the multistage solver takes the JAX package's route:
    no fused iteration (_mega_applicable), no fused system solve
    (_solve_backends) and no df64 phase; the crown kernels still apply."""
    _, ms = tree()
    prep = td._get_prep(ms.meta.crown_topo)
    one = td.TdunesOpts(**dict(BENCH, refine_steps=0))
    axis = dataclasses.replace(one, axis_name="scen")
    assert tm._mega_applicable(prep, ms.meta, one)
    assert not tm._mega_applicable(prep, ms.meta, axis)
    assert tm._solve_backends(prep, ms.meta, one) == (True, True)
    assert tm._solve_backends(prep, ms.meta, axis) == (True, False)


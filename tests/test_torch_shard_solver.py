"""The multi-device solve of the PyTorch port (``treeqp_tpu_torch.parallel``)
against the port's one-device solve and the JAX package's explicit-SPMD
solve (``treeqp_tpu.parallel.shard_solver``, ``shard_map`` on the virtual
CPU mesh of tests/conftest.py).

One module-scoped group of 1, 2 or 4 gloo ranks on the CPU (spawned by
``parallel.launcher.run_ranks``) solves every case, and the tests compare
its results. The trees are the JAX package's tests/test_shard_solver.py
ones: spring_mass_chain(nm=4, md=2, Nr=3, Nh=8) (8 scenarios) for
tdunes_ms and ipm_ms, nm=2 for the two-phase speed options, nm=2, Nh=6
with a general row on every node for the IPM, nm=3 for sdunes
bootstrapped from IPM duals, and nm=2, Nh=6 for the cold sdunes solve, a
tree on which the stall escalation of a cold start changes the count (10
cold iterations, 11 from zero duals, in both packages).

Tolerances: against the port's one-device solve the same iterations and
|dx| <= 1e-9; against JAX's sharded solve the same iterations, |dx|, |du|
<= 1e-7 and |dlam| <= 1e-6; both KKT oracles below 1e-8 (1e-7 with
general rows).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from benchmarks import models as jmodels
from treeqp_tpu.core.kkt import max_kkt_residual as jax_kkt
from treeqp_tpu.parallel import shard_solver as jss
from treeqp_tpu.parallel.sharding import scenario_mesh as jax_mesh
from treeqp_tpu.solvers import ipm as jipm
from treeqp_tpu.solvers import ipm_multistage as jims
from treeqp_tpu.solvers import sdunes as jsd
from treeqp_tpu.solvers import tdunes as jtd
from treeqp_tpu.solvers import tdunes_multistage as jtm

from treeqp_tpu_torch import convert, merge_output
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.parallel.shard_solver import ShardCase, solve_sharded
from treeqp_tpu_torch.parallel.sharding import model_bytes_per_iter
from treeqp_tpu_torch.solvers import ipm, ipm_multistage as ims
from treeqp_tpu_torch.solvers import sdunes as sd
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
ONE = dict(stage_solver="clipping", tol=1e-8, max_iter=30)
SPEED = dict(stage_solver="clipping", tol=1e-8, max_iter=60, factor_dtype="float32",
             refine_steps=1, refine_safeguard=False, chain_backend="xla",
             reg_type="always", reg_value=1e-6, f32_phase_tol=1e-4)
# bench.py's options on the kernel route (the kernels' twins on the CPU)
BENCH = dict(SPEED, max_iter=120, refine_steps=2, chain_backend="pallas", f32_patience=3,
             df64_phase=True)
IPM_BOX = dict(tol=1e-10, max_iter=40)
IPM_ROWS = dict(tol=1e-9, max_iter=50)
SD_COLD = dict(tol=1e-8, max_iter=60)
SD_BOOT = dict(tol=1e-8, max_iter=30)
TREES = {"ms": (4, 2, 3, 8), "speed": (2, 2, 3, 8), "rows": (2, 2, 3, 6),
         "boot": (3, 2, 3, 8), "cold": (2, 2, 3, 6)}


@functools.lru_cache(maxsize=None)
def instance(name):
    """(qp_j, qp) of a tree: the JAX package's and the port's (CPU) copy."""
    qp_j, _ = jmodels.spring_mass_chain(*TREES[name])
    if name == "rows":
        qp_j = jmodels.with_general_rows(qp_j, cmax=0.6)
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    return qp_j, qp


@functools.lru_cache(maxsize=None)
def boot_duals():
    """sdunes' warm start from the IPM's tree solution, as the JAX package's
    test makes it: (lam0, mu0) of both packages."""
    qp_j, qp = instance("boot")
    ms_j, ms = jtm.split_multistage(qp_j), tm.split_multistage(qp)
    out_j = jtm.merge_output(ms_j, *jims.ipm_ms_solve(ms_j, jipm.IpmOpts(**IPM_BOX)))
    out = merge_output(ms, *ims.ipm_ms_solve(ms, ipm.IpmOpts(**IPM_BOX)))
    return (jsd.scenario_duals_from_tree(jsd.scenario_data(qp_j), out_j.lam, out_j),
            sd.scenario_duals_from_tree(sd.scenario_data(qp), out.lam, out))


def cases():
    """{name: ShardCase} of the solves every group runs."""
    ms = lambda n: tm.split_multistage(instance(n)[1])
    sqp = lambda n: sd.scenario_data(instance(n)[1])
    return {
        "one_phase": ShardCase("tdunes_ms", ms("ms"), td.TdunesOpts(**ONE)),
        "speed": ShardCase("tdunes_ms", ms("speed"), td.TdunesOpts(**SPEED)),
        "bench": ShardCase("tdunes_ms", ms("ms"), td.TdunesOpts(**BENCH)),
        "ipm_box": ShardCase("ipm_ms", ms("ms"), ipm.IpmOpts(**IPM_BOX)),
        "ipm_rows": ShardCase("ipm_ms", ms("rows"), ipm.IpmOpts(**IPM_ROWS)),
        "sd_cold": ShardCase("sdunes", sqp("cold"), sd.SdunesOpts(**SD_COLD)),
        "sd_boot": ShardCase("sdunes", sqp("boot"), sd.SdunesOpts(**SD_BOOT),
                             start=boot_duals()[1]),
    }


@functools.lru_cache(maxsize=None)
def group(world):
    """{case name: solve_sharded's result}: every case solved by one group
    of ``world`` gloo ranks."""
    cs = cases()
    return dict(zip(cs, solve_sharded(world, list(cs.values()), device="cpu", timeout=600)))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def sharded(request):
    """(world, group(world))."""
    return request.param, group(request.param)


TREE_OF = {"one_phase": "ms", "speed": "speed", "bench": "ms", "ipm_box": "ms",
           "ipm_rows": "rows", "sd_cold": "cold", "sd_boot": "boot"}


def port_out(name, r):
    """The whole tree's TreeQPOut of a sharded result."""
    qp = instance(TREE_OF[name])[1]
    if "sol" in r:
        return sd.scenario_output(sd.scenario_data(qp), r["sol"], r["lam"], r["mu"], r["info"])
    return merge_output(tm.split_multistage(qp), r["crown"], r["chain"], r["info"])


@functools.lru_cache(maxsize=None)
def one_device(name):
    """The port's one-device solve of a case: its TreeQPOut."""
    c = cases()[name]
    qp = instance(TREE_OF[name])[1]
    if c.solver == "tdunes_ms":
        return merge_output(c.data, *tm.tdunes_ms_solve(c.data, None, None, c.opts))
    if c.solver == "ipm_ms":
        return merge_output(c.data, *ims.ipm_ms_solve(c.data, c.opts))
    lam0, mu0 = c.start or (None, None)
    sol, lam, mu, info = sd.sdunes_solve(c.data, lam0, mu0, c.opts)
    return sd.scenario_output(sd.scenario_data(qp), sol, lam, mu, info)


@functools.lru_cache(maxsize=None)
def jax_sharded(name, world):
    """The JAX package's sharded solve of a case on jax.devices()[:world]:
    its TreeQPOut (numpy fields) and info."""
    qp_j = instance(TREE_OF[name])[0]
    mesh = jax_mesh(jax.devices()[:world])
    if name in ("one_phase", "speed"):
        opts = jtd.TdunesOpts(**(ONE if name == "one_phase" else SPEED))
        ms_j = jtm.split_multistage(qp_j)
        cro, cho, info = jax.jit(lambda m: jss.tdunes_ms_solve_shmap(m, None, None, opts, mesh))(
            ms_j)
        out = jtm.merge_output(ms_j, cro, cho, info)
    elif name.startswith("ipm"):
        opts = jipm.IpmOpts(**(IPM_BOX if name == "ipm_box" else IPM_ROWS))
        ms_j = jtm.split_multistage(qp_j)
        cro, cho, info = jax.jit(lambda m: jss.ipm_ms_solve_shmap(m, opts, mesh))(ms_j)
        out = jtm.merge_output(ms_j, cro, cho, info)
    else:
        sqp_j = jsd.scenario_data(qp_j)
        opts = jsd.SdunesOpts(**(SD_COLD if name == "sd_cold" else SD_BOOT))
        lam0, mu0 = boot_duals()[0] if name == "sd_boot" else (None, None)
        sol, lam, mu, info = jax.jit(
            lambda a, b, c: jss.sdunes_solve_shmap(a, b, c, opts, mesh))(sqp_j, lam0, mu0)
        out = jsd.scenario_output(sqp_j, sol, lam, mu, info)
    return qp_j, out


def gaps(out, out_j) -> dict:
    a, b = convert.out_to_numpy(out), convert.out_to_numpy(out_j)
    return {f: float(np.abs(a[f] - b[f]).max()) for f in ("x", "u", "lam")}


def check_one_device(sharded, name):
    _, res = sharded
    out, ref = port_out(name, res[name]), one_device(name)
    assert res[name]["info"]["status"] == 0 == ref.info["status"]
    assert res[name]["info"]["iter"] == ref.info["iter"]
    assert gaps(out, ref)["x"] <= 1e-9


def check_jax(sharded, name, kkt_bar=1e-8):
    world, res = sharded
    out = port_out(name, res[name])
    qp_j, out_j = jax_sharded(name, world)
    assert int(out_j.info["status"]) == 0 and res[name]["info"]["iter"] == int(out_j.info["iter"])
    g = gaps(out, out_j)
    assert g["x"] <= 1e-7 and g["u"] <= 1e-7 and g["lam"] <= 1e-6, g
    qp = instance(TREE_OF[name])[1]
    assert max_kkt_residual(qp, out) < kkt_bar and float(jax_kkt(qp_j, out_j)) < kkt_bar


def test_tdunes_ms_matches_one_device(sharded):
    """tdunes_ms_solve_shmap takes the one-device solve's iterations, x
    within 1e-9."""
    check_one_device(sharded, "one_phase")


def test_tdunes_ms_matches_jax_shmap(sharded):
    check_jax(sharded, "one_phase")


def test_tdunes_ms_two_phase_speed_opts(sharded):
    """The f32 -> f64 two-phase schedule (JAX's test_shmap_two_phase_speed_opts):
    the one-device solve's iterations and coarse iterations, and JAX's."""
    check_one_device(sharded, "speed")
    check_jax(sharded, "speed")
    assert sharded[1]["speed"]["info"]["iter_f32"] == one_device("speed").info["iter_f32"] > 0


def test_tdunes_ms_kernel_route(sharded):
    """bench.py's options under an axis take the JAX package's route (no
    fused iteration, df64 phase or fused system solve: the chain kernels'
    and crown kernels' twins between collectives): certified, and each
    group takes the 1-rank group's iterations, x within 1e-9 (the
    one-device solve takes another route)."""
    world, res = sharded
    r = res["bench"]
    out = port_out("bench", r)
    assert r["info"]["status"] == 0 and r["info"]["iter_f32"] > 0
    assert max_kkt_residual(instance("ms")[1], out) < 1e-8
    ref = group(1)["bench"]
    assert r["info"]["iter"] == ref["info"]["iter"]
    assert gaps(out, port_out("bench", ref))["x"] <= 1e-9


def test_ipm_ms_matches_one_device(sharded):
    check_one_device(sharded, "ipm_box")


def test_ipm_ms_matches_jax_shmap(sharded):
    check_jax(sharded, "ipm_box")


def test_ipm_ms_general_rows(sharded):
    """The sharded IPM with a general C/D row on every node: the one-device
    solve's iterations and JAX's, both oracles below 1e-7."""
    check_one_device(sharded, "ipm_rows")
    check_jax(sharded, "ipm_rows", kkt_bar=1e-7)
    assert "mu_d" in sharded[1]["ipm_rows"]["chain"]


def test_sdunes_cold_keeps_the_stall_escalation(sharded):
    """A cold sharded sdunes solve (no duals) keeps the stall escalation:
    it engages at the one-device solve's iterations and takes the
    one-device cold count (10), and so does JAX's one-device cold solve;
    JAX's sharded wrapper fills zero duals, which turns the escalation
    off, and takes 11."""
    check_one_device(sharded, "sd_cold")
    world, res = sharded
    boosts = res["sd_cold"]["info"]["stall_boosts"]
    assert boosts == one_device("sd_cold").info["stall_boosts"] > 0
    qp_j = instance("cold")[0]
    opts = jsd.SdunesOpts(**SD_COLD)
    info_j = jsd.sdunes_solve(jsd.scenario_data(qp_j), None, None, opts)[3]
    assert res["sd_cold"]["info"]["iter"] == int(info_j["iter"]) == 10
    assert int(jax_sharded("sd_cold", world)[1].info["iter"]) == 11
    assert max_kkt_residual(instance("cold")[1], port_out("sd_cold", res["sd_cold"])) < 1e-8


def test_sdunes_bootstrapped(sharded):
    """sdunes warm-started from the IPM's duals (JAX's
    test_sdunes_shmap_matches_single_device): the one-device solve's
    iterations, and JAX's sharded solve's; mu within 1e-8 of the one-device
    solve's."""
    check_one_device(sharded, "sd_boot")
    check_jax(sharded, "sd_boot")
    assert sharded[1]["sd_boot"]["info"]["stall_boosts"] == 0  # a warm start
    c = cases()["sd_boot"]
    mu0 = sd.sdunes_solve(c.data, *c.start, c.opts)[2]
    assert float((sharded[1]["sd_boot"]["mu"] - mu0).abs().max()) <= 1e-8


def test_one_rank_is_the_one_device_solve_bit_for_bit():
    """On one rank every collective is the identity and the route is the
    one-device solve's (all but the bench case, whose one-device solve takes
    the fused iteration and the df64 phase): the same iterations and bits."""
    for name, r in group(1).items():
        if name == "bench":
            continue
        out, ref = port_out(name, r), one_device(name)
        assert r["info"]["iter"] == ref.info["iter"], name
        for f in ("x", "u", "lam", "mu_x", "mu_u", "mu_d"):
            assert torch.equal(getattr(out, f), getattr(ref, f)), (name, f)


def test_collective_bytes(sharded):
    """Each rank counts the same collectives, and no single one moves more
    than the design's largest boundary tensor: the chain roots' [S, nx+nu]
    contributions or Schur complements [S, nx, nx] in f64 (tdunes_ms), the Riccati terms W0 [S, nz, nz] in f64 (ipm_ms), the Jay
    Gram blocks [Ns, nl, nl] in f64 (sdunes). On the HLO audit's trees
    (tests/test_hlo_audit.py: L = 5 chains, Nh = 6, 8) none moves half a
    chain-shaped tensor either: S L nx^2 4 / 2 bytes for tdunes_ms, S L
    nx^2 8 / 2 for ipm_ms, Ns Nh nx^2 8 / 2 for sdunes (the rows tree's
    L = 3 chains are shorter than a W0 is wide). The coarse phase's bytes
    per f32 iteration stay within twice the communication model's figure
    (the chain roots' contributions and Schur complements in f32, six
    scalars)."""
    world, res = sharded
    for name, r in res.items():
        comm = r["comm"]
        assert all(c == comm[0] for c in comm), name
        c = cases()[name]
        meta = c.data.meta
        if c.solver == "sdunes":
            nl = meta.Nr * meta.nu
            design, chain = meta.Ns * nl * nl * 8, meta.Ns * meta.Nh * meta.nx ** 2 * 8
        elif c.solver == "ipm_ms":
            nz = meta.nx + meta.nu
            design, chain = meta.S * nz * nz * 8, meta.S * meta.L * meta.nx ** 2 * 8
        else:
            design = max(meta.S * (meta.nx + meta.nu) * 8, meta.S * meta.nx ** 2 * 8)
            chain = meta.S * meta.L * meta.nx ** 2 * 4
        assert 0 < comm[0]["max_call"] <= design, name
        assert name == "ipm_rows" or comm[0]["max_call"] < chain / 2, name
    meta = cases()["speed"].data.meta
    per_iter = res["speed"]["comm"][0]["bytes_per_iter_f32"]
    assert 0 < per_iter <= 2 * model_bytes_per_iter(meta.S, meta.nx, meta.nu)

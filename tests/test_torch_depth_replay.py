"""PyTorch port: why the general C/D iteration counts part from JAX's at
depth (``test_torch_general_solve.py::test_general_cd_depth_parity``).

On general_cd("qpgen", 2, 3, 3, 12) (283 nodes) at general_cd_bench's
options, JAX (``chain_backend="xla"``) and the port run the same coarse
phase (5 iterations) and the same first final-phase iterations; both
take 20 backtracks in the fourth, and they part after it. JAX's solve is
run once with every final-phase line search's inputs recorded (the duals,
the Newton direction and the working sets its trials hotstart from). The
fourth and fifth line searches are replayed from them through both
packages' ``_line_search``, and through each package's trial evaluation
at every step tau = 0.6^k: both repeat the count the solve recorded, and
at every trial take the same Armijo decision, with the same stage
solutions and working sets.

What parts them is the direction. At the fourth iteration the
f32-factored, once-refined Newton direction is so sensitive to rounding
that the accepted step (tau = 0.6^19) lands on one of two points, with
dual residual errors 0.58797 and 0.59477. JAX's own XLA step, recomputed
from that iterate in a separate jit, lands on the port's point, and 1-ulp
perturbations of its f32 Hessian blocks send it to either. So the port
takes no decision that JAX would not take from the same iterate; the
counts part by the rounding of the iterate each package reaches.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import general_cd_bench as gcb
from treeqp_tpu.solvers import tdunes as jtd

from treeqp_tpu_torch import models
from treeqp_tpu_torch.solvers import tdunes as td

torch.set_num_threads(1)

DIMS = (2, 3, 3, 12)  # nm, md, Nr, Nh: 27 scenarios, 283 nodes
COARSE_ITERS = 5  # the coarse phase's iterations, in both packages
FINAL_ITERS = 5  # the final-phase iterations the replays read
# the port's trial dual values within this (relative to max(1, |f|)) of
# JAX's, the stage solutions within X_TOL
F_RTOL, X_TOL = 1e-10, 1e-9
BASE = {**models.GENERAL_CD_OPTS, "stage_solver": "qpgen", "h_diag": True}
T = lambda a: torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def instances():
    with mock.patch.multiple(gcb, NM=DIMS[0], MD=DIMS[1], NR=DIMS[2], NH=DIMS[3]):
        qp_j = gcb.build("tdunes_qpgen")
    qp = models.general_cd("qpgen", *DIMS, device="cpu")
    jo = jtd.TdunesOpts(**{**BASE, "chain_backend": "xla"})
    po = td.TdunesOpts(**BASE)
    prep = td._get_prep(qp.topo)
    return (qp_j, jo, jtd._get_prep(qp_j.topo), jtd._stage_data(qp_j, jo),
            qp, po, prep, td._stage_data(qp, po, prep))


@functools.lru_cache(maxsize=None)
def jax_solve():
    """JAX's two-phase solve, stopped after the fifth final-phase
    iteration (the last one the replays read; max_iter counts both
    phases), with the inputs of each final-phase line search recorded: a
    list of dicts (lam, dn, dg, rg, ws, n_ls) of numpy arrays, and the
    solve's err_hist."""
    qp_j = instances()[0]
    rec, real = [], jtd._line_search

    def store(lam, dn, dg, rg, up, dw, n_ls):
        rec.append(dict(lam=np.asarray(lam), dn=np.asarray(dn), dg=np.asarray(dg),
                        rg=np.asarray(rg), ws=(np.asarray(up), np.asarray(dw)),
                        n_ls=int(n_ls)))

    def recording(qp, lam, dlam_nodes, sol0, dlam_g, rg, data, opts, prep, restart,
                  inner_ws=None):
        out = real(qp, lam, dlam_nodes, sol0, dlam_g, rg, data, opts, prep, restart,
                   inner_ws=inner_ws)
        if lam.dtype == jnp.float64:
            jax.debug.callback(store, lam, dlam_nodes, dlam_g, rg, *inner_ws, out[1],
                               ordered=True)
        return out
    with mock.patch.object(jtd, "_line_search", recording):
        out = jtd.tdunes_solve(qp_j, None, jtd.TdunesOpts(**{
            **models.GENERAL_CD_OPTS, "stage_solver": "qpgen", "chain_backend": "xla",
            "max_iter": COARSE_ITERS + FINAL_ITERS, "record_history": True}))
    err, ls = np.asarray(out.info["err_hist"]), np.asarray(out.info["ls_hist"])
    assert int(np.argmax(np.isfinite(err))) == COARSE_ITERS
    assert len(rec) == FINAL_ITERS
    assert [r["n_ls"] for r in rec] == list(ls[COARSE_ITERS:COARSE_ITERS + len(rec)])
    return rec, err


@functools.lru_cache(maxsize=None)
def jax_fns():
    """JAX's pieces, jitted once: the stage solve, the dual value, the line
    search and a trial evaluation."""
    qp_j, jo, jprep, jdata = instances()[:4]

    @jax.jit
    def stage(lam, ws):
        return jtd._stage_solve(qp_j, lam, jdata, jo, jprep, inner_ws=ws)

    @jax.jit
    def value(lam, sol):
        return jtd._dual_value(qp_j, lam, sol, jdata, jo)

    @jax.jit
    def line_search(lam, dn, sol, dg, rg, ws):
        return jtd._line_search(qp_j, lam, dn, sol, dg, rg, jdata, jo, jprep,
                                jnp.zeros((), jnp.int32), inner_ws=ws)[1]

    @jax.jit
    def trial(lam, dn, ws, tau):
        lt = lam + tau * dn
        s = jtd._stage_solve(qp_j, lt, jdata, jo, jprep, inner_ws=ws)
        return jtd._dual_value(qp_j, lt, s, jdata, jo), s["x"], s["u"], s["qpgen_ws"]
    return stage, value, line_search, trial


@pytest.mark.parametrize("k", [3, 4], ids=["fourth", "fifth"])
def test_line_search_replay_takes_jax_decisions(k):
    """The (k+1)-th final-phase line search of JAX's solve, from its
    recorded inputs, through both packages: the count the solve recorded,
    and at every trial the same Armijo decision, dual values within
    F_RTOL, stage solutions within X_TOL and the same working sets."""
    qp_j, jo, jprep, jdata, qp, po, pprep, pdata = instances()
    r = jax_solve()[0][k]
    stage, value, line_search, trial = jax_fns()
    lam, dn, dg, rg = (jnp.asarray(r[f]) for f in ("lam", "dn", "dg", "rg"))
    ws = tuple(jnp.asarray(w) for w in r["ws"])
    sol = stage(lam, ws)
    assert all(np.array_equal(a, b) for a, b in zip(sol["qpgen_ws"], r["ws"]))
    assert int(line_search(lam, dn, sol, dg, rg, ws)) == r["n_ls"]

    plam, pdn, pws = T(lam), T(dn), tuple(T(w) for w in ws)
    psol = td._stage_solve(qp, plam, pdata, po, pprep, inner_ws=pws)
    assert all(torch.equal(a, b) for a, b in zip(psol["qpgen_ws"], pws))
    assert float((psol["x"] - T(sol["x"])).abs().max()) <= X_TOL
    lam_new, n_port, descent_ok, _ = td._line_search(
        qp, plam, pdn, psol, T(dg), T(rg), pdata, po, pprep, 0, inner_ws=pws)
    assert descent_ok and n_port == r["n_ls"]

    f0 = float(value(lam, sol))
    assert abs(float(td._dual_value(qp, plam, psol, pdata, po)) - f0) <= \
        F_RTOL * max(1.0, abs(f0))
    dot = float(-jnp.sum(rg * dg))
    eta = 2.0 ** -45 * abs(f0)
    tau, margin, worst = 1.0, float("inf"), 0.0
    for n in range(r["n_ls"]):
        fj, xj, uj, wsj = trial(lam, dn, ws, jnp.asarray(tau))
        fj = float(fj)
        lt = plam + tau * pdn
        s = td._stage_solve(qp, lt, pdata, po, pprep, inner_ws=pws)
        fp = float(td._dual_value(qp, lt, s, pdata, po))
        thr = f0 + po.ls_gamma * tau * dot + eta
        gap = abs(fp - fj)
        assert gap <= F_RTOL * max(1.0, abs(fj)), (n, gap)
        # the same decision, and no rounding of the size of gap could flip it
        assert (fp <= thr) == (fj <= thr) == (n == r["n_ls"] - 1), n
        assert abs(fj - thr) > gap
        margin, worst = min(margin, abs(fj - thr)), max(worst, gap)
        assert float((s["x"] - T(xj)).abs().max()) <= X_TOL
        assert float((s["u"] - T(uj)).abs().max()) <= X_TOL
        assert all(torch.equal(a, T(b)) for a, b in zip(s["qpgen_ws"], wsj))
        tau *= po.ls_beta
    assert float((lam_new - T(lam + (tau / po.ls_beta) * dn)).abs().max()) <= 1e-12
    print(f"final line search {k + 1}: {r['n_ls']} trials in both packages, the smallest "
          f"Armijo margin {margin:.3e}, the largest |f_port - f_jax| {worst:.3e}")


def test_fourth_step_lands_by_rounding():
    """From JAX's iterate before its fourth final-phase step, JAX's own
    XLA step (direction, line search, the error at the new point),
    recomputed in a separate jit, lands where the port's step lands and
    not where JAX's solve went; with 1-ulp perturbations of its f32
    Hessian blocks it lands on either point."""
    qp_j, jo, jprep, jdata, qp, po, pprep, pdata = instances()
    rec, err_hist = jax_solve()
    r = rec[3]
    lam = jnp.asarray(r["lam"])
    ws = tuple(jnp.asarray(w) for w in r["ws"])
    sol = jax_fns()[0](lam, ws)
    nrxm = jtd._masks(qp_j)[2]
    W, Ut = jax.jit(lambda s: jtd._build_dual_hessian(qp_j, s, jdata, jo, jprep,
                                                      dtype=jnp.float32))(sol)
    rg = jnp.asarray(r["rg"])

    @jax.jit
    def step_err(Wx):
        dg = jtd._newton_direction(Wx, Ut, rg, jo, jprep, qp=qp_j, sol=sol, data=jdata)
        dn = jtd._group_to_nodes_mm(dg, jprep, lam.dtype) * nrxm
        lam_new = jtd._line_search(qp_j, lam, dn, sol, dg, rg, jdata, jo, jprep,
                                   jnp.zeros((), jnp.int32), inner_ws=ws)[0]
        s = jtd._stage_solve(qp_j, lam_new, jdata, jo, jprep, inner_ws=ws)
        return jtd._residual_error(jtd._dual_residual(qp_j, s, jprep), jo)

    # where JAX's solve went, and where the port's step goes with the
    # port's own direction from the same iterate
    err_solve = float(err_hist[COARSE_ITERS + 4])
    plam, pws = T(lam), tuple(T(w) for w in ws)
    psol = td._stage_solve(qp, plam, pdata, po, pprep, inner_ws=pws)
    prg = td._nodes_to_group_mm(td._dual_residual(qp, psol, pprep), pprep)
    pdg = td._newton_direction(*td._build_dual_hessian(qp, psol, pdata, po, pprep), prg,
                               po, pprep, qp, psol, pdata)
    pdn = td._group_to_nodes_mm(pdg, pprep, qp.dtype) * td._masks(qp, pprep)[2]
    lam_p = td._line_search(qp, plam, pdn, psol, pdg, prg, pdata, po, pprep, 0,
                            inner_ws=pws)[0]
    s_p = td._stage_solve(qp, lam_p, pdata, po, pprep, inner_ws=pws)
    err_port = float(td._residual_error(td._dual_residual(qp, s_p, pprep), po))
    assert abs(err_port - err_solve) > 1e-3  # two different points

    on_port = lambda e: abs(e - err_port) <= 1e-9
    on_solve = lambda e: abs(e - err_solve) <= 1e-5 * err_solve
    assert on_port(float(step_err(W)))
    rng = np.random.default_rng(1)
    landed = []
    for _ in range(4):
        e = (rng.random(W.shape) - 0.5) * 2.0 ** -23
        Wp = np.asarray(W, np.float64) * (1.0 + 0.5 * (e + e.transpose(0, 2, 1)))
        landed.append(float(step_err(jnp.asarray(Wp.astype(np.float32)))))
    print(f"the fourth step lands at error {err_port:.6f} (the port) or {err_solve:.6f} "
          f"(JAX's solve); JAX's step in a separate jit at {float(step_err(W)):.6f}, with "
          f"1-ulp perturbed blocks at {', '.join(f'{e:.6f}' for e in landed)}")
    assert any(map(on_port, landed)) and any(map(on_solve, landed)), landed

"""PyTorch port: the working-set hotstart of the general stage QPs, replayed
through both packages' ``_qpgen_batch``.

The port's two-phase qpgen solve of general_cd_bench's tree at
spring_mass_chain(2, 2, 2, 8) (31 nodes, a row on every node) is run with
its f64 stage solves recorded: the modified gradients and the working sets
each hotstart starts from. Of its 44 hotstarted f64 stage solves, 39 pass
the KKT guard (max residual < 1e-9) and 5 fall back to the ADMM
identification. The same 44 inputs through the JAX package's
``_qpgen_batch`` (node-major, on the CPU; its guard read from its
``lax.cond``) pass and fail in the same solves: where the hotstart fails,
the PDAS sweeps from the previous working set end above the guard in both
(e.g. 0.45 on both sides in the first), so the fallbacks are the
algorithm's, not the port's."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import torch

from benchmarks import general_cd_bench as gcb
from treeqp_tpu.solvers import tdunes as jtd

from treeqp_tpu_torch import models
from treeqp_tpu_torch.ops import qpgen_lanes as ql
from treeqp_tpu_torch.solvers import tdunes as td

torch.set_num_threads(1)

DIMS = (2, 2, 2, 8)  # nm, md, Nr, Nh
N_HOTSTART, N_PASS = 44, 39


@functools.lru_cache(maxsize=None)
def recorded():
    """(hmod, working sets, passed) of each hotstarted f64 stage solve of
    the port's cold solve."""
    qp = models.general_cd("qpgen", *DIMS, device="cpu")
    rec, admm = [], [0]
    real_q, real_a = td._qpgen_batch, ql.admm_identify

    def count_admm(*a, **k):
        admm[0] += 1
        return real_a(*a, **k)

    def record(hmod, *a, ws=None, **k):
        n0 = admm[0]
        out = real_q(hmod, *a, ws=ws, **k)
        if ws is not None and hmod.dtype == torch.float64:
            rec.append((hmod, ws, admm[0] == n0))
        return out
    with mock.patch.object(td, "_qpgen_batch", record), \
            mock.patch.object(ql, "admm_identify", count_admm):
        out = td.tdunes_solve(qp, None, td.TdunesOpts(**models.GENERAL_CD_OPTS))
    assert out.info["status"] == 0
    return tuple(rec)


@functools.lru_cache(maxsize=None)
def jax_stage_data():
    with mock.patch.multiple(gcb, NM=DIMS[0], MD=DIMS[1], NR=DIMS[2], NH=DIMS[3]):
        qp_j = gcb.build("tdunes_qpgen")
    opts = jtd.TdunesOpts(**{**models.GENERAL_CD_OPTS, "chain_backend": "xla",
                             "h_diag": True})
    return opts, jtd._stage_data(qp_j, opts)


def jax_guard_passes(hmod, ws):
    """Whether the JAX package's hotstart guard passes on these inputs."""
    opts, data = jax_stage_data()
    preds, real_cond = [], jax.lax.cond

    def cond(pred, *a, **k):
        preds.append(bool(pred))
        return real_cond(pred, *a, **k)
    with mock.patch.object(jax.lax, "cond", cond):
        jtd._qpgen_batch(jnp.asarray(hmod.numpy()),
                         *(data[k] for k in td._QPGEN_KEYS), opts,
                         ws=tuple(jnp.asarray(w.numpy()) for w in ws),
                         GH=data["GH"], GHG=data["GHG"])
    return preds[0]  # the first cond is the hotstart guard


def test_port_hotstart_pass_count():
    rec = recorded()
    assert len(rec) == N_HOTSTART
    assert sum(ok for *_, ok in rec) == N_PASS


def test_jax_hotstart_guard_agrees_per_solve():
    """Every failing hotstart and three passing ones, through JAX."""
    rec = recorded()
    fails = [r for r in rec if not r[2]]
    passes = [r for r in rec if r[2]][::13]
    assert len(fails) == N_HOTSTART - N_PASS
    for hmod, ws, ok in fails + passes:
        assert jax_guard_passes(hmod, ws) == ok

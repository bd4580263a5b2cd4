"""PyTorch port, the fused coarse-phase iteration: the plain twin of the
newton_iter CUDA kernel (newton_iter_ref, what the wrapper runs on CPU
tensors) in both modes against the JAX Pallas kernel (interpret mode), on
the same f32 data, factors, duals and residuals at points on the two-phase
solver's path; and its index lists against the JAX kernel's one-hot
layout matrices."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import chain_kernels as jck
from treeqp_tpu.ops import crown_kernels as jckr
from treeqp_tpu.ops import iter_kernel as jik

from benchmarks import models as jmodels
from test_torch_chain_kernels import CASES, POINTS, assert_close, jax_ref
from test_torch_eval_kernels import (EVAL_RTOL, TWO_PHASE, assert_margin, eval_case,
                                     lanes_to_chains, path_case, split_case)
from test_torch_system_kernels import jax_layout
from treeqp_tpu_torch.ops import iter_kernel as ik
from treeqp_tpu_torch.solvers import tdunes_multistage as tm

torch.set_num_threads(1)

# the Newton direction and everything at the trial point it reaches: f32
# solves on both sides with another summation order
# (tests/test_torch_system_kernels.py)
SOLVE_RTOL = 1e-4
# the CUDA kernel's edges (chip_smoke.ITER_EDGES, within the TPU kernel's
# caps), at the coarse phase's first iteration (duals 0): more chains than
# one of its blocks' 512 threads at L = 1 (1024 chains, a 1365-node crown),
# and nx = 16 (its 16-lane sweeps, crown groups of 32 rows) on a small tree
EDGES = {"scen1024_L1": lambda: jmodels.quadcopter(4, 5, 6).qp,
         "nx16": lambda: jmodels.spring_mass_chain(nm=8, md=2, Nr=1, Nh=3)[0]}
CASE_POINTS = ([(p, n) for p in sorted(POINTS) for n in sorted(CASES)]
               + [("zero", n) for n in sorted(EDGES)])


def case_at(name, point):
    """path_case's operands of a case at a path point, or of an edge tree at
    duals 0."""
    if name in CASES:
        return path_case(name, point)
    qp_j = EDGES[name]()
    ms = split_case(qp_j)
    return eval_case(qp_j, ms, torch.zeros((ms.meta.crown_topo.Nn, ms.meta.crown_topo.nxm),
                                           dtype=torch.float64),
                     torch.zeros_like(ms.q))


def lanes(v, width):
    """[N, ...] -> the JAX lane layout [..., width] (zeros beyond N)."""
    v = np.moveaxis(v.numpy(), 0, -1)
    out = np.zeros(v.shape[:-1] + (width,), np.float32)
    out[..., : v.shape[-1]] = v
    return jnp.asarray(out)


@functools.lru_cache(maxsize=None)
def iter_case(name, point):
    """Both sides' operands of one fused iteration at a path point: the
    residuals and active set there (from the eval mode of the twin), and
    the factors of that active set."""
    c = case_at(name, point)
    ms, prep = c["ms"], c["prep"]
    root_ids = ms.meta.root_ids
    state = dict(lam_cr=c["lam_cr"], lam_ch=c["lam_ch"])
    ev = ik.newton_iter_ref(c["data_ch"], c["data_cr"], None, state, prep,
                            root_ids, mode="eval")
    state.update(res_cr=ev["res2_cr"], res_ch=ev["res2_ch"])
    fact = tm._ms_factorize(ms, ev["qtilde"], ev["rtilde"], ev["qt"], ev["rt"],
                            TWO_PHASE, prep, tm._solve_ctx(ms, prep), lanes=True)
    S, NPc = ms.meta.S, c["jdata_cr"]["ABt"].shape[-1]
    SP = c["jdata_ch"]["ABt"].shape[-1]
    Lt, CUt, CholW, CholUt = jax_layout(fact["Ls"], fact["CUs"], fact["CholW"],
                                        fact["CholUt"], c["jprep"])
    jfact = dict(Lt=jnp.asarray(Lt), CUt=jnp.asarray(CUt), CholW=jnp.asarray(CholW),
                 CholUt=jnp.asarray(CholUt), s_node_l=lanes(fact["s_node"], NPc),
                 sc_l=lanes(fact["sc"], SP))
    jstate = dict(lam_cr=lanes(state["lam_cr"], NPc), lam_ch=lanes(state["lam_ch"], SP),
                  res_cr=lanes(state["res_cr"], NPc), res_ch=lanes(state["res_ch"], SP))
    assert S <= SP
    return c, fact, state, jfact, jstate


@pytest.mark.parametrize("mode", ["iter", "eval"])
@pytest.mark.parametrize("point,name", CASE_POINTS)
def test_newton_iter_matches_pallas(mode, name, point):
    c, fact, state, jfact, jstate = iter_case(name, point)
    ms, Nn = c["ms"], c["data_cr"]["ABt"].shape[0]
    out = ik.newton_iter_ref(c["data_ch"], c["data_cr"], fact, state, c["prep"],
                             ms.meta.root_ids, mode=mode)
    jout = jax_ref(jik.newton_iter, c["jdata_ch"], c["jdata_cr"], jfact, jstate,
                   prep=c["jprep"], root_ids=ms.meta.root_ids, meta=c["ms_j"].meta, mode=mode)
    S = ms.meta.S
    chains = lambda v: lanes_to_chains(v, S)
    nodes = lambda v: np.asarray(v)[:, :Nn].T
    # the trial point and the active sets there, by both sides' standalone
    # evaluations (which the eval-kernel tests hold equal)
    jch = jax_ref(jck.chain_eval, c["jdata_ch"], jnp.asarray(chains(jout["lam2_ch"])))
    d = c["data_ch"]
    ones = torch.ones_like
    assert_margin(out["xUnc"], chains(jch["xUnc"]), d["xmin"], d["xmax"], ones(d["xmin"]), "x")
    assert_margin(out["uUnc"], chains(jch["uUnc"]), d["umin"], d["umax"], ones(d["umin"]), "u")
    extra = torch.zeros_like(c["data_cr"]["ABt"][:, 0])
    extra[torch.as_tensor(ms.meta.root_ids)] = torch.as_tensor(np.array(jch["cqr"]))
    jcr = jax_ref(jckr.crown_eval, c["jdata_cr"], jout["lam2_cr"],
                  lanes(extra, jout["lam2_cr"].shape[-1]))
    d = c["data_cr"]
    assert_margin(out["cxUnc"], nodes(jcr["xUnc"]), d["xmin"], d["xmax"], d["xm"], "crown x")
    assert_margin(out["cuUnc"], nodes(jcr["uUnc"]), d["umin"], d["umax"], d["um"], "crown u")

    rtol = SOLVE_RTOL if mode == "iter" else EVAL_RTOL
    for k in ("dch", "lam2_ch", "res2_ch", "x", "u"):
        assert_close(out[k], chains(jout[k]), rtol, k)
    for k in ("dcr", "lam2_cr", "res2_cr", "cx", "cu"):
        assert_close(out[k], nodes(jout[k]), rtol, k)
    for k in ("qt", "rt"):
        np.testing.assert_array_equal(out[k].numpy(), chains(jout[k]), k)
    for k in ("qtilde", "rtilde"):
        np.testing.assert_array_equal(out[k].numpy(), nodes(jout[k]), k)
    total = lambda p: np.asarray([float(p[0].sum()) + float(p[1].sum())])
    peak = lambda p: np.asarray([max(float(p[0].max()), float(p[1].max()))])
    assert_close(total(out["f1p"]), total(jout["f1p"]), rtol, "f1")
    assert_close(total(out["dotp"]), total(jout["dotp"]), SOLVE_RTOL, "dot")
    assert_close(peak(out["errp"]), peak(jout["errp"]), rtol, "err")
    if mode == "eval":
        assert not out["dcr"].any() and not out["dch"].any()
        assert not out["dotp"][0].any() and not out["dotp"][1].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_iter_sched_matches_pallas(name):
    """rid against the injection matrix R, and each crown node's (group,
    slot) against the node -> group matrices N2G."""
    c = path_case(name, "zero")
    ms, prep = c["ms"], c["prep"]
    t = ik.iter_sched(prep, ms.meta.root_ids, "cpu")
    N2G, R = jik.iter_sched(c["jprep"], ms.meta.root_ids, ms.meta.S)
    rid = t["rid"].numpy()
    assert all(R[s, rid[s]] == 1.0 for s in range(ms.meta.S))
    assert int(R.sum()) == ms.meta.S
    gon, son = t["group_of_node"].numpy(), t["slot_of_node"].numpy()
    Nn = len(gon)
    assert all(N2G[son[n], n, gon[n]] == 1.0 for n in range(1, Nn))
    assert int(N2G.sum()) == Nn - 1
    assert ik.iter_supported(prep, ms.meta, TWO_PHASE)


def test_newton_iter_cpu_wrapper_runs_plain_twin():
    c, fact, state, _, _ = iter_case("quadcopter", "half")
    root_ids = c["ms"].meta.root_ids
    for mode in ("iter", "eval"):
        got = ik.newton_iter(c["data_ch"], c["data_cr"], fact, state, c["prep"],
                             root_ids, mode=mode)
        ref = ik.newton_iter_ref(c["data_ch"], c["data_cr"], fact, state, c["prep"],
                                 root_ids, mode=mode)
        for k, v in ref.items():
            pair = zip(got[k], v) if isinstance(v, tuple) else [(got[k], v)]
            assert all(torch.equal(a, b) for a, b in pair), k
    assert ik.newton_iter.launches == 0
    on_meta = lambda d: {k: v.to("meta") for k, v in d.items()}
    with pytest.raises(ValueError, match="expected"):
        ik.newton_iter(on_meta(c["data_ch"]), on_meta(c["data_cr"]), on_meta(fact),
                       on_meta(state), c["prep"], root_ids)

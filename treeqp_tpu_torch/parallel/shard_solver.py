"""The sharded solvers: tdunes_ms, ipm_ms and sdunes over torch.distributed
ranks, the chains (scenarios) split, the crown replicated.

Port of ``treeqp_tpu/parallel/shard_solver.py``'s explicit-SPMD route (the
JAX package's ``shard_map`` wrappers, under their names): each rank calls
the wrapper with its own part of the problem (``sharding.shard_multistage``
/ ``shard_scenarios``) and the mesh it joined (``sharding.scenario_mesh``),
and the solver runs with ``axis_name`` set to the mesh's axis, so that its
only cross-rank traffic is the collectives it makes itself: the chain
roots' contributions, Schur complements and right-hand sides (tdunes_ms),
the chain roots' Riccati terms (ipm_ms), the Jay system's boundary blocks
(sdunes), and scalar reductions; ``info["comm"]`` counts them.
``model_bytes_per_iter`` (``sharding``) is the communication model's
figure to hold them against.

``solve_sharded(world, cases)`` runs a list of ``ShardCase`` solves over
``world`` spawned ranks in one group (``launcher.run_ranks``) and returns
each case's outputs gathered back to the whole tree (``merge_output`` /
``scenario_output`` take them as they take a one-device solve's); a
caller that measures the solves passes its own rank function to
``run_ranks`` (``rank_call`` builds each rank's solve) and joins the
outputs with ``merge_ranks``.
"""

from __future__ import annotations

import dataclasses

import torch

from treeqp_tpu_torch.parallel import sharding
from treeqp_tpu_torch.solvers.ipm_multistage import ipm_ms_solve
from treeqp_tpu_torch.solvers.sdunes import sdunes_solve
from treeqp_tpu_torch.solvers.tdunes_multistage import tdunes_ms_solve

__all__ = ["tdunes_ms_solve_shmap", "ipm_ms_solve_shmap", "sdunes_solve_shmap",
           "gather_chain_outputs", "ShardCase", "cpu_outputs", "rank_call", "solve_cases",
           "merge_ranks", "solve_sharded"]


def tdunes_ms_solve_shmap(ms, lam0_crown, lam0_chain, opts, mesh):
    """``tdunes_ms_solve`` on this rank of ``mesh``: ``ms`` and
    ``lam0_chain`` the rank's chains, ``lam0_crown`` the whole crown's
    duals (None: zeros). Returns (crown outputs, the rank's chain outputs,
    info), the crown outputs and info the same on every rank. The route is
    the JAX package's under an axis (no fused iteration, df64 phase, fused
    system solve or fused chain evaluation)."""
    opts = dataclasses.replace(opts, axis_name=mesh.axis)
    return tdunes_ms_solve(ms, lam0_crown, lam0_chain, opts)


def ipm_ms_solve_shmap(ms, opts, mesh, ws=None):
    """``ipm_ms_solve`` on this rank of ``mesh``: ``ms`` the rank's chains,
    ``ws`` None or (the crown's outputs, the rank's chain outputs). General
    C/D rows included. Returns (crown outputs, the rank's chain outputs,
    info)."""
    opts = dataclasses.replace(opts, axis_name=mesh.axis)
    return ipm_ms_solve(ms, opts, ws=ws)


def sdunes_solve_shmap(sqp, lam0, mu0, opts, mesh):
    """``sdunes_solve`` on this rank of ``mesh``: ``sqp`` and ``mu0`` the
    rank's scenarios, ``lam0`` all couplings. None duals pass through as
    None, so a cold sharded solve keeps the stall escalation of a cold
    one-device solve (the JAX wrapper fills zeros, which a solve takes as
    a warm start). Returns (the rank's sol, lam, the rank's mu, info)."""
    opts = dataclasses.replace(opts, axis_name=mesh.axis)
    return sdunes_solve(sqp, lam0, mu0, opts)


def gather_chain_outputs(chain_out: dict, mesh) -> dict:
    """Every rank's chain outputs (or sdunes trajectories), gathered along
    the scenario dim in scenario order, on every rank."""
    some = next(iter(chain_out.values()))
    shard = sharding.Shard(mesh, some.shape[0])
    return {k: shard.gather_s(v) for k, v in chain_out.items()}


@dataclasses.dataclass
class ShardCase:
    """One sharded solve: ``solver`` "tdunes_ms" (``data`` a MultistageQP,
    ``start`` None or (lam0_crown, lam0_chain)), "ipm_ms" (a MultistageQP;
    None or ws = (crown_ws, chain_ws)) or "sdunes" (a ScenarioQP; None or
    (lam0, mu0)); the data and starts whole, on the CPU."""

    solver: str
    data: object
    opts: object
    start: tuple = None


def cpu_outputs(obj):
    """Tensors of a nested dict / tuple moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: cpu_outputs(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(cpu_outputs(v) for v in obj)
    return obj


def _to(obj, dev, rows=None):
    """Tensors of a nested dict / tuple moved to ``dev``; with ``rows``,
    those of a chain / scenario part sliced to the rank's rows first."""
    if isinstance(obj, torch.Tensor):
        return (obj if rows is None else obj[rows]).to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev, rows) for k, v in obj.items()}
    return obj


def rank_call(case: ShardCase, mesh):
    """The rank's solve of ``case`` on ``mesh`` as a closure (the data and
    starts sliced to the rank's part and moved to its device)."""
    dev, r, w = mesh.device, mesh.rank, mesh.world
    if case.solver == "sdunes":
        sqp = sharding.shard_scenarios(case.data, r, w).to(device=dev)
        rows = slice(sqp.b.shape[0] * r, sqp.b.shape[0] * (r + 1))
        lam0, mu0 = case.start or (None, None)
        lam0 = None if lam0 is None else lam0.to(dev)
        mu0 = None if mu0 is None else mu0[rows].to(dev)
        return lambda: sdunes_solve_shmap(sqp, lam0, mu0, case.opts, mesh)
    ms = sharding.shard_multistage(case.data, r, w).to(device=dev)
    rows = slice(ms.q.shape[0] * r, ms.q.shape[0] * (r + 1))
    if case.solver == "tdunes_ms":
        lam_cr, lam_ch = case.start or (None, None)
        lam_cr = None if lam_cr is None else lam_cr.to(dev)
        lam_ch = None if lam_ch is None else lam_ch[rows].to(dev)
        return lambda: tdunes_ms_solve_shmap(ms, lam_cr, lam_ch, case.opts, mesh)
    if case.solver == "ipm_ms":
        ws = None if case.start is None else (_to(case.start[0], dev),
                                              _to(case.start[1], dev, rows))
        return lambda: ipm_ms_solve_shmap(ms, case.opts, mesh, ws=ws)
    raise ValueError(f"ShardCase.solver={case.solver!r}")


def solve_cases(mesh, cases) -> list:
    """The rank's side of ``solve_sharded``: each case's outputs on the CPU."""
    return [cpu_outputs(rank_call(case, mesh)()) for case in cases]


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def merge_ranks(cases, per_rank) -> list:
    """Join the ranks' outputs (``per_rank[r][i]``: rank r's outputs of
    case i, on the CPU) per case. Raises when the replicated outputs (the
    crown's, lam, info) differ between ranks. Returns per case
    dict(crown, chain, info) for tdunes_ms / ipm_ms or dict(sol, lam, mu,
    info) for sdunes, the sharded parts concatenated in scenario order
    (info the rank 0's), and ``comm`` (each rank's info["comm"])."""
    merged = []
    for i, case in enumerate(cases):
        outs = [pr[i] for pr in per_rank]
        sd = case.solver == "sdunes"
        repl = [(o[1], {k: v for k, v in o[3].items() if k != "comm"}) if sd
                else (o[0], {k: v for k, v in o[2].items() if k != "comm"}) for o in outs]
        for r in range(1, len(outs)):
            if not _same(repl[0], repl[r]):
                raise RuntimeError(f"case {i} ({case.solver}): the replicated outputs of "
                                   f"rank {r} differ from rank 0's")
        cat = lambda j: {k: torch.cat([o[j][k] for o in outs]) for k in outs[0][j]}
        if sd:
            m = dict(sol=cat(0), lam=outs[0][1], mu=torch.cat([o[2] for o in outs]),
                     info=outs[0][3])
        else:
            m = dict(crown=outs[0][0], chain=cat(1), info=outs[0][2])
        m["comm"] = [o[3 if sd else 2]["comm"] for o in outs]
        merged.append(m)
    return merged


def solve_sharded(world: int, cases, device="cuda", **launch_kw) -> list:
    """Solve every ``ShardCase`` over ``world`` ranks of one group
    (``launcher.run_ranks``; ``device`` "cuda" or "cpu") and join each
    case's outputs (``merge_ranks``)."""
    from treeqp_tpu_torch.parallel.launcher import run_ranks
    return merge_ranks(cases, run_ranks(world, solve_cases, list(cases), device=device,
                                        **launch_kw))

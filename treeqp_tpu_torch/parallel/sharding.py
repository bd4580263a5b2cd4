"""Scenario sharding over torch.distributed ranks.

Port of ``treeqp_tpu/parallel/sharding.py``. The scaling design: the
scenarios (the chains of a multistage tree, the scenario copies of sdunes)
are split over the ranks of one process group, the crown (the
non-anticipativity coupling) and the small coupling systems stay
replicated on every rank.

The JAX package has two routes. Its GSPMD route (jit over arrays placed
with ``NamedSharding``, the collectives placed by XLA) has no PyTorch
counterpart: no PyTorch compiler partitions a program over devices. The
port has the explicit route of ``treeqp_tpu/parallel/shard_solver.py``
only: every rank runs the solver on its own chains with
``axis_name`` set, and every byte that crosses ranks goes through the
``Shard`` the solver makes for itself (``psum``, ``pmax``, ``pmin``,
``gather_s``, ``all_true``, ``slice_s``). It gives the same answer as the
GSPMD route. Without ``axis_name`` the solvers run the same code with
``ONE_DEVICE``, whose collectives are the identity (``shard_for`` picks
the context). On one rank every collective is the identity, so a 1-rank
solve computes what the one-device solve of the same route computes
(bit for bit on the CPU); on more, the psums add the ranks' partial
sums, whose rounding follows the split.

``axis_name`` keeps its JAX meaning, the name of the scenario axis:
``scenario_mesh`` sets up the process group on one rank and registers it
under that name, and a solver with ``axis_name`` set looks it up
(``get_mesh``; ``LookupError`` when none is registered).

Devices: each rank runs on ``cuda:rank`` when the machine has a card for
every rank (backend NCCL), and ranks share the cards otherwise
(``cuda:rank % cards``, backend gloo: NCCL refuses two ranks on one card);
``device="cpu"`` runs every rank on the CPU (gloo). With gloo, CUDA
tensors are staged through host memory explicitly for every collective,
so the route does not depend on which CUDA collectives the installed gloo
implements.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ["AXIS", "ScenarioMesh", "OneDevice", "ONE_DEVICE", "Shard", "shard_for",
           "scenario_mesh", "release_mesh", "get_mesh", "rank_device", "shard_multistage",
           "shard_scenarios", "model_bytes_per_iter"]

AXIS = "scen"

# axis name -> the ScenarioMesh this process registered under it
_MESHES: dict = {}


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """One rank's view of the scenario axis: its rank in the group of
    ``world`` ranks, its device and the group's backend."""

    axis: str
    rank: int
    world: int
    device: torch.device
    backend: str
    group: object


def rank_device(rank: int, world: int, device="cuda") -> torch.device:
    """The device of ``rank`` among ``world`` ranks: ``cuda:rank`` when the
    machine has ``world`` cards, the cards shared round-robin otherwise
    (``cuda:0`` for every rank on a one-card machine); the CPU only when
    the caller asks for it. Raises when CUDA is asked for and absent."""
    if str(device) == "cpu":
        return torch.device("cpu")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError("no CUDA device for the sharded solve "
                           "(pass device='cpu' to run the ranks on the CPU)")
    return torch.device("cuda", rank % cards)


def scenario_mesh(rank: int, world: int, init_method: str, device="cuda",
                  axis: str = AXIS, timeout: float = 300.0) -> ScenarioMesh:
    """Join the process group of ``world`` ranks at ``init_method`` (a
    ``file://`` path or ``tcp://host:port``) as ``rank`` and register it
    under ``axis``. NCCL when every rank has a card of its own, gloo
    otherwise; ``timeout`` seconds bound every collective, so a deadlocked
    collective raises instead of hanging."""
    dev = rank_device(rank, world, device)
    own_card = dev.type == "cuda" and torch.cuda.device_count() >= world
    backend = "nccl" if own_card else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout))
    mesh = ScenarioMesh(axis, rank, world, dev, backend, dist.group.WORLD)
    _MESHES[axis] = mesh
    return mesh


def release_mesh(axis: str = AXIS) -> None:
    """Unregister ``axis`` and leave its process group."""
    if _MESHES.pop(axis, None) is not None and dist.is_initialized():
        dist.destroy_process_group()


def get_mesh(axis: str) -> ScenarioMesh:
    """The mesh registered under ``axis`` in this process."""
    try:
        return _MESHES[axis]
    except KeyError:
        raise LookupError(
            f"axis_name={axis!r}: no process group is registered under this name "
            "(call treeqp_tpu_torch.parallel.sharding.scenario_mesh on every rank "
            "first)") from None


class OneDevice:
    """The shard context of a solve on one device, the one every solver
    runs without ``axis_name``: all scenarios are this process's, so every
    collective is the identity and nothing crosses a rank (``start`` 0,
    nothing counted). ``Shard`` is the same interface over a process
    group."""

    start = 0
    bytes = calls = max_call = 0

    def psum(self, v):
        return v

    pmax = pmin = gather_s = slice_s = psum

    def all_true(self, flag):
        """``flag`` (a bool or a 0-dim bool tensor) as every rank holds it."""
        return flag

    def summary(self, iters: int) -> dict:
        """The counts as ``info["comm"]`` reports them."""
        return dict(bytes=self.bytes, calls=self.calls, max_call=self.max_call,
                    bytes_per_iter=self.bytes / max(iters, 1))


ONE_DEVICE = OneDevice()


class Shard(OneDevice):
    """The collectives of one sharded solve over the scenario axis, each
    counted: ``bytes`` (the sum over calls of what each moves: an
    all-gather its gathered tensor, an all-reduce its operand), ``calls``
    and ``max_call`` (the largest single collective). ``start`` is the
    first global scenario of this rank's ``S_local`` ones."""

    def __init__(self, mesh: ScenarioMesh, S_local: int):
        self.mesh = mesh
        self.S_local = S_local
        self.start = mesh.rank * S_local
        self.bytes = 0
        self.calls = 0
        self.max_call = 0

    def _count(self, n: int) -> None:
        self.bytes += n
        self.calls += 1
        self.max_call = max(self.max_call, n)

    def _reduce(self, v: torch.Tensor, op) -> torch.Tensor:
        staged = self.mesh.backend == "gloo" and v.device.type == "cuda"
        buf = (v.detach().to("cpu") if staged else v.detach().clone()).reshape(-1)
        self._count(buf.numel() * buf.element_size())
        dist.all_reduce(buf, op=op, group=self.mesh.group)
        return buf.reshape(v.shape).to(v.device)

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        return self._reduce(v, dist.ReduceOp.SUM)

    def pmax(self, v: torch.Tensor) -> torch.Tensor:
        return self._reduce(v, dist.ReduceOp.MAX)

    def pmin(self, v: torch.Tensor) -> torch.Tensor:
        return self._reduce(v, dist.ReduceOp.MIN)

    def gather_s(self, v: torch.Tensor) -> torch.Tensor:
        """All-gather a per-scenario tensor along dim 0, in rank order (the
        global scenario order): the compact boundary form."""
        staged = self.mesh.backend == "gloo" and v.device.type == "cuda"
        buf = (v.detach().to("cpu") if staged else v.detach()).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.mesh.world)]
        self._count(self.mesh.world * buf.numel() * buf.element_size())
        dist.all_gather(parts, buf, group=self.mesh.group)
        return torch.cat(parts).to(v.device)

    def all_true(self, flag):
        """True iff ``flag`` is true on every rank, in ``flag``'s kind (a
        bool or a 0-dim bool tensor): a host decision that guards a
        collective must not diverge."""
        t = torch.as_tensor(flag, device=self.mesh.device)
        ok = self.psum((~t).to(torch.int32)) == 0
        return ok if isinstance(flag, torch.Tensor) else bool(ok)

    def slice_s(self, v):
        """This rank's rows of a global [S, ...] tensor."""
        return v[self.start:self.start + self.S_local]


def shard_for(axis_name, S_local: int) -> OneDevice:
    """The shard context of a solve: ``ONE_DEVICE`` without an axis, else
    this rank's ``Shard`` (``S_local`` scenarios) over the group registered
    under ``axis_name``."""
    if axis_name is None:
        return ONE_DEVICE
    return Shard(get_mesh(axis_name), S_local)


def _rows(S: int, rank: int, world: int) -> slice:
    if S % world:
        raise ValueError(f"S={S} scenarios do not split over {world} ranks")
    n = S // world
    return slice(rank * n, (rank + 1) * n)


def shard_multistage(ms, rank: int, world: int):
    """``rank``'s chains of the MultistageQP ``ms`` (S / world consecutive
    scenarios), the crown and the global ``meta`` kept whole. S must divide
    by world."""
    from treeqp_tpu_torch.solvers.tdunes_multistage import CHAIN_FIELDS, GENERAL_FIELDS
    rows = _rows(ms.meta.S, rank, world)
    return dataclasses.replace(ms, **{f: getattr(ms, f)[rows] for f in CHAIN_FIELDS + GENERAL_FIELDS
                                      if getattr(ms, f) is not None})


def shard_scenarios(sqp, rank: int, world: int):
    """``rank``'s scenarios of the ScenarioQP ``sqp`` (Ns / world
    consecutive ones), the global ``meta`` kept whole."""
    from treeqp_tpu_torch.solvers.sdunes import SQP_FIELDS
    rows = _rows(sqp.meta.Ns, rank, world)
    return sqp.replace(**{f: getattr(sqp, f)[rows] for f in SQP_FIELDS})


def model_bytes_per_iter(S: int, nx: int, nu: int) -> int:
    """The communication model's collective bytes per f32 Newton iteration
    of the sharded multistage dual Newton (``benchmarks/scaling_analysis.py``):
    the chain roots' contributions [S, nx + nu] and Schur complements
    [S, nx, nx] gathered in f32, and six f64 scalars."""
    return S * (nx + nu) * 4 + S * nx * nx * 4 + 6 * 8

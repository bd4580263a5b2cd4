"""Crown tree-Riccati kernels of the IPM: the whole level recursion of a
generic tree (the crown of a multistage tree, or a whole box-only tree) in
one launch each.

Port of ``crown_ric_factor`` and ``crown_ric_solve`` in
``treeqp_tpu/ops/crown_riccati.py``. Each wrapper launches its CUDA kernel
(``csrc/crown_ric.cu``: one cluster or one block, a group of lanes per
single-kid run of the tree, a barrier between phases of runs) on CUDA
tensors and runs its plain PyTorch twin (``*_ref``) on CPU tensors. Both
are f32, like the Pallas kernels, and take diagonal stage Hessians only
(box constraints: the barrier keeps them diagonal).

The recursion is the chain kernels' stage (``riccati_kernels.stage_*``)
level by level, deepest stage first, over a node's kids instead of one
successor: each node's term W = AB' P AB (rhs sweep: w = AB'(P rb + p))
is summed over its parent's kids in kid order and then added to the
parent's accumulator, seeded with ``Wsum0`` / ``wsum0`` (the chains'
terms at the chain roots). The TPU kernel moved these sums with a 0/1
[NPc, NPc] lane matmul per level and computed every level on all lanes;
here they are index lists in a fixed order (no atomics: repeated runs give
the same bits), so the crown has no node or depth cap (the TPU kernel's
``Nn <= 512``, ``<= 8`` stages). The root solves P0 dx0 = -p0 with the
same clamped Cholesky, then the forward sweep runs nearest level first.
Factors are node-major: P [Nc, nx, nx], Luu [Nc, nu, nu], K [Nc, nu, nx],
Mxu [Nc, nx, nu].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.ops import _build, _dense
from treeqp_tpu_torch.ops.riccati_kernels import (
    _MAX_NZ, stage_bwd, stage_factor, stage_fwd)

__all__ = ["crown_ric_factor", "crown_ric_factor_ref", "crown_ric_solve",
           "crown_ric_solve_ref"]


@dataclasses.dataclass(frozen=True)
class _CrownRicSched:
    """Level schedule of the crown recursion (deepest stage first; the
    last level is the root), and its runs for the kernels: a run starts at
    the root, a leaf or a node with two or more kids and climbs through
    every node that is its parent's only kid (the root excepted), deepest
    first; a run's phase is one past the latest phase of its first node's
    kids' runs (0 at a leaf), and the last phase holds the root's run
    alone."""

    n_lev: int
    lev_ptr: np.ndarray    # [n_lev + 1] offsets into lev_node
    lev_node: np.ndarray   # the nodes of each level
    acc_ptr: np.ndarray    # [n_lev + 1] offsets into acc_node
    acc_node: np.ndarray   # the parents that each level's nodes add into
    kid_ptr: np.ndarray    # [Nc + 1] offsets into kid_idx
    kid_idx: np.ndarray    # each node's kids, ascending
    par: np.ndarray        # [Nc] parent (0 at the root)
    width: int             # most nodes or parents on one level
    n_ph: int              # phases of runs
    ph_ptr: np.ndarray     # [n_ph + 1] offsets into the runs
    run_ptr: np.ndarray    # [runs + 1] offsets into run_node
    run_node: np.ndarray   # each run's nodes, deepest first
    run_width: int         # most runs in one phase
    _tensors: dict = dataclasses.field(default_factory=dict, compare=False)

    def on(self, device) -> dict:
        """The int32 schedule arrays on ``device`` (cached)."""
        device = torch.device(device)
        hit = self._tensors.get(device)
        if hit is None:
            hit = {k: torch.as_tensor(getattr(self, k), dtype=torch.int32, device=device)
                   for k in ("lev_ptr", "lev_node", "acc_ptr", "acc_node", "kid_ptr",
                             "kid_idx", "par", "ph_ptr", "run_ptr", "run_node")}
            self._tensors[device] = hit
        return hit

    def levels(self, device) -> list:
        """Per level: (nodes, parents [P], kids [P, Kmax] padded with -1) as
        long tensors on ``device`` (cached), for the twins."""
        device = torch.device(device)
        key = ("levels", device)
        hit = self._tensors.get(key)
        if hit is None:
            lng = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
            hit = []
            for r in range(self.n_lev):
                nodes = self.lev_node[self.lev_ptr[r]:self.lev_ptr[r + 1]]
                pars = self.acc_node[self.acc_ptr[r]:self.acc_ptr[r + 1]]
                kids = [self.kid_idx[self.kid_ptr[p]:self.kid_ptr[p + 1]] for p in pars]
                km = max([len(k) for k in kids] + [1])
                kk = np.full((len(pars), km), -1, np.int64)
                for i, k in enumerate(kids):
                    kk[i, :len(k)] = k
                hit.append((lng(nodes), lng(pars), lng(kk)))
            self._tensors[key] = hit
        return hit


def _get_sched(prep) -> _CrownRicSched:
    """The schedule of an IPM prep (``solvers.ipm._IpmPrep``: ``topo`` and
    its ``levels``, each stage's nodes, deepest first), cached on it."""
    sched = prep.__dict__.get("_crown_ric_sched")
    if sched is not None:
        return sched
    topo = prep.topo
    Nn = topo.Nn
    levels = [np.asarray(lv, np.int64) for lv in prep.levels]
    par = topo.parent_np.astype(np.int64).copy()
    par[0] = 0
    kids = [[] for _ in range(Nn)]
    for n in range(1, Nn):
        kids[par[n]].append(n)
    accs = [np.unique(par[lv[lv != 0]]) for lv in levels]
    # runs, their first nodes deepest first, each climbing while the node
    # is its parent's only kid; a run's phase after its first node's kids'
    phase = np.zeros(Nn, np.int64)  # of each node's run
    runs = []
    for start in np.concatenate(levels):
        if len(kids[start]) == 1 and start != 0:
            continue  # on its kid's run
        ph = 1 + max((phase[c] for c in kids[start]), default=-1)
        run = [int(start)]
        while run[-1] != 0 and len(kids[par[run[-1]]]) == 1 and par[run[-1]] != 0:
            run.append(int(par[run[-1]]))
        phase[run] = ph
        runs.append((ph, run))
    runs.sort(key=lambda pr: pr[0])  # stable: within a phase, deepest start first
    n_ph = runs[-1][0] + 1
    per_ph = np.bincount([ph for ph, _ in runs], minlength=n_ph)
    i32 = lambda v: np.asarray(v, np.int32)
    sched = _CrownRicSched(
        n_lev=len(levels),
        lev_ptr=i32(np.cumsum([0] + [len(lv) for lv in levels])),
        lev_node=i32(np.concatenate(levels)),
        acc_ptr=i32(np.cumsum([0] + [len(a) for a in accs])),
        acc_node=i32(np.concatenate(accs)),
        kid_ptr=i32(np.cumsum([0] + [len(k) for k in kids])),
        kid_idx=i32([c for k in kids for c in k]),
        par=i32(par),
        width=max([len(v) for v in levels + accs] + [1]),
        n_ph=n_ph,
        ph_ptr=i32(np.cumsum([0] + list(per_ph))),
        run_ptr=i32(np.cumsum([0] + [len(r) for _, r in runs])),
        run_node=i32([n for _, r in runs for n in r]),
        run_width=int(per_ph.max()))
    prep._crown_ric_sched = sched
    return sched


def _kid_sum(v, pars, kk):
    """Per parent, its kids' rows of v summed in kid order."""
    acc = torch.zeros((len(pars),) + v.shape[1:], dtype=v.dtype, device=v.device)
    for s in range(kk.shape[1]):
        valid = (kk[:, s] >= 0).view(-1, *([1] * (v.dim() - 1)))
        acc = acc + torch.where(valid, v[kk[:, s].clamp(min=0)], 0.0)
    return acc


def crown_ric_factor_ref(hbar, AB, Wsum0, prep, nx, reg=0.0):
    """Plain PyTorch twin of the kernel (see ``crown_ric_factor``)."""
    Nc, nz = hbar.shape
    nu = nz - nx
    kw = dict(dtype=hbar.dtype, device=hbar.device)
    Wsum = Wsum0.clone()
    Wc = torch.zeros((Nc, nz, nz), **kw)
    P, Lu = torch.zeros((Nc, nx, nx), **kw), torch.zeros((Nc, nu, nu), **kw)
    K, Mxu = torch.zeros((Nc, nu, nx), **kw), torch.zeros((Nc, nx, nu), **kw)
    for nodes, pars, kk in _get_sched(prep).levels(hbar.device):
        M = Wsum[nodes] + torch.diag_embed(hbar[nodes])
        P[nodes], Lu[nodes], K[nodes], Mxu[nodes], Wc[nodes] = stage_factor(
            M, AB[nodes], nx, reg)
        if len(pars):
            Wsum[pars] = Wsum[pars] + _kid_sum(Wc, pars, kk)
    return dict(P=P, Luu=Lu, K=K, Mxu=Mxu, AB=AB)


def _check(name, sched, Nc, nx, nz):
    if not (Nc == len(sched.par) and 0 < nx < nz <= _MAX_NZ):
        raise ValueError(f"{name}: unsupported shape Nc={Nc} nx={nx} nz={nz} (the kernel "
                         f"takes the schedule's {len(sched.par)} nodes and 0 < nx < nz <= "
                         f"{_MAX_NZ})")


# the kernels' launch (csrc/crown_ric.cu): a group of 8 (nz <= 8), 16 (nz
# <= 16) or 32 lanes a run, blocks of at most _ric_warps(nz) warps (16: 128
# registers a thread; 8 for the 32-lane instantiation, 255 a thread) whose
# groups' shared memory fits _BLOCK_SMEM, on one cluster of _RIC_CLUSTER
# blocks (Hopper's largest, not portable) or in one block
_RIC_CLUSTER = 16
_BLOCK_SMEM = 227 * 1024
_RIC_ONE_BLOCK = 32  # the widest phase one block takes


def _ric_floats(nz) -> int:
    """Shared-memory floats a group of either kernel needs at nz, with nx =
    nz - 1 (the most): the factor's 3-stage ring of [AB | hbar | Wsum0] and
    its five nz x nz work areas, the solve's 4-stage ring of its backward
    [P | Lu | Mxu | AB | rg | rb | wsum0] or forward [P | K | AB | rb | p |
    k] stage, each stage rounded up to 4 floats."""
    nx, nu = nz - 1, 1
    up4 = lambda f: -(-f // 4) * 4
    factor = 3 * up4(nx * nz + nz + nz * nz) + 5 * nz * nz
    bwd = up4(nx * nx + nu * nu + nx * nu + nx * nz + 2 * nz + nx)
    fwd = up4(nx * nx + nu * nx + nx * nz + 2 * nx + nu)
    return max(factor, 4 * max(bwd, fwd))


def _ric_lanes(nz) -> int:
    """Lanes a group of either kernel at nz (csrc/tq_riccati.cuh's
    ric_lanes)."""
    return 8 if nz <= 8 else 16 if nz <= 16 else 32


def _ric_warps(nz) -> int:
    """The most warps a block of either kernel at nz (crown_ric.cu's
    max_threads / 32)."""
    return 16 if nz <= 16 else 8


def _ric_launch(sched, nz) -> tuple[int, int]:
    """(blocks, warps a block) of both kernels: a group a run of the widest
    phase in one round where the blocks' threads and shared memory allow;
    one block where that phase has at most _RIC_ONE_BLOCK runs (its
    barrier costs less than the cluster's), else one cluster whose groups
    the phases' runs take interleaved over its blocks (16 blocks rather
    than 8 spread a 256-run phase's stages over twice the SMs)."""
    per_warp = 32 // _ric_lanes(nz)
    cap = min(_ric_warps(nz), _BLOCK_SMEM // (4 * _ric_floats(nz) * per_warp))
    width = sched.run_width
    if width <= min(_RIC_ONE_BLOCK, cap * per_warp):
        return 1, -(-width // per_warp)
    return _RIC_CLUSTER, min(cap, -(-width // (per_warp * _RIC_CLUSTER)))


def crown_ric_factor(hbar, AB, Wsum0, prep, nx, reg=0.0):
    """Tree Riccati factorization of the whole crown, deepest stage first:
    per node M = Wsum + diag(hbar), Lu = chol(Muu + reg I) (pivot floor
    1e-8, clamped diagonal), K = -Muu^-1 Mux, P = sym(Mxx + Mxu K); the
    node's W = AB' P AB goes to its parent's Wsum.

    hbar [Nc, nz], AB [Nc, nx, nz] (edge into each node), Wsum0 [Nc, nz,
    nz] (the chains' terms at the chain roots, else zero); f32. ``prep``
    is the IPM prep of the crown topology. Returns the factors dict(P,
    Luu, K, Mxu, AB) for ``crown_ric_solve``."""
    if hbar.device.type == "cpu":
        return crown_ric_factor_ref(hbar, AB, Wsum0, prep, nx, reg)
    name = "crown_ric_factor"
    sched = _get_sched(prep)
    Nc, nz = hbar.shape
    nu = nz - nx
    dev = hbar.device
    _check(name, sched, Nc, nx, nz)
    for arg, t, shape in (("hbar", hbar, (Nc, nz)), ("AB", AB, (Nc, nx, nz)),
                          ("Wsum0", Wsum0, (Nc, nz, nz))):
        _build.require(name, arg, t, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    P, Lu = torch.empty((Nc, nx, nx), **f32), torch.empty((Nc, nu, nu), **f32)
    K, Mxu = torch.empty((Nc, nu, nx), **f32), torch.empty((Nc, nx, nu), **f32)
    Wc = torch.empty((Nc, nz, nz), **f32)  # the run tops' W
    t = sched.on(dev)
    ptrs = _build.ptr_array(
        [hbar, AB, Wsum0] + [t[k] for k in ("lev_ptr", "lev_node", "acc_ptr", "acc_node",
                                            "kid_ptr", "kid_idx")]
        + [P, Lu, K, Mxu, None, Wc] + [t[k] for k in ("ph_ptr", "run_ptr", "run_node")])
    err = _build.lib().tq_crown_ric_factor(ptrs, Nc, nx, nz, sched.n_ph, float(reg),
                                           *_ric_launch(sched, nz), _build.stream(dev))
    _build.check(err, name)
    crown_ric_factor.launches += 1
    return dict(P=P, Luu=Lu, K=K, Mxu=Mxu, AB=AB)


crown_ric_factor.launches = 0


def crown_ric_solve_ref(fact, rg, rb, wsum0, prep):
    """Plain PyTorch twin of the kernel (see ``crown_ric_solve``)."""
    P, Lu, K, Mxu, AB = (fact[k] for k in ("P", "Luu", "K", "Mxu", "AB"))
    Nc, nx, nz = AB.shape
    kw = dict(dtype=P.dtype, device=P.device)
    levels = _get_sched(prep).levels(P.device)
    wsum = wsum0.clone()
    p, k = torch.zeros((Nc, nx), **kw), torch.zeros((Nc, nz - nx), **kw)
    wv = torch.zeros((Nc, nz), **kw)
    for nodes, pars, kk in levels:
        p[nodes], k[nodes], wv[nodes] = stage_bwd(
            rg[nodes] + wsum[nodes], P[nodes], Lu[nodes], Mxu[nodes], AB[nodes],
            rb[nodes], nx)
        if len(pars):
            wsum[pars] = wsum[pars] + _kid_sum(wv, pars, kk)
    # root: P0 dx0 = -p0
    Lp = _dense.chol(P[:1], clamp_diag=True)
    dx0 = -_dense.uttrsv(Lp, _dense.ltrsv(Lp, p[:1]))
    dz, dl = torch.zeros((Nc, nz), **kw), torch.zeros((Nc, nx), **kw)
    dz[:1] = torch.cat([dx0, _dense.mv(K[:1], dx0) + k[:1]], dim=1)
    dl[:1] = _dense.mv(P[:1], dx0) + p[:1]
    par = torch.as_tensor(_get_sched(prep).par, dtype=torch.long, device=P.device)
    for nodes, _, _ in levels[-2::-1]:
        dz[nodes], dl[nodes] = stage_fwd(dz[par[nodes]], P[nodes], K[nodes], AB[nodes],
                                         rb[nodes], p[nodes], k[nodes])
    return dz, dl


def crown_ric_solve(fact, rg, rb, wsum0, prep):
    """Solve with ``crown_ric_factor``'s factors: the backward rhs sweep
    (k = -Muu^-1 m_u, p = m_x + Mxu k, the node's w = AB'(P rb + p) to its
    parent's wsum, seeded with ``wsum0``), the root step P0 dx0 = -p0, and
    the forward sweep dx = AB dz_parent + rb, du = K dx + k, dlam = P dx + p.

    rg [Nc, nz], rb [Nc, nx], wsum0 [Nc, nz] (cast to f32). Returns
    (dz [Nc, nz], dlam [Nc, nx])."""
    P = fact["P"]
    rg, rb, wsum0 = (v.to(P.dtype).contiguous() for v in (rg, rb, wsum0))
    if P.device.type == "cpu":
        return crown_ric_solve_ref(fact, rg, rb, wsum0, prep)
    name = "crown_ric_solve"
    sched = _get_sched(prep)
    Nc, nx, nz = fact["AB"].shape
    nu = nz - nx
    dev = P.device
    _check(name, sched, Nc, nx, nz)
    for arg, t, shape in (("P", P, (Nc, nx, nx)), ("Luu", fact["Luu"], (Nc, nu, nu)),
                          ("K", fact["K"], (Nc, nu, nx)), ("Mxu", fact["Mxu"], (Nc, nx, nu)),
                          ("AB", fact["AB"], (Nc, nx, nz)), ("rg", rg, (Nc, nz)),
                          ("rb", rb, (Nc, nx)), ("wsum0", wsum0, (Nc, nz))):
        _build.require(name, arg, t, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    p, k = torch.empty((Nc, nx), **f32), torch.empty((Nc, nu), **f32)
    wv = torch.empty((Nc, nz), **f32)  # the run tops' w
    dz, dl = torch.empty((Nc, nz), **f32), torch.empty((Nc, nx), **f32)
    t = sched.on(dev)
    ptrs = _build.ptr_array(
        [P, fact["Luu"], fact["K"], fact["Mxu"], fact["AB"], rg, rb, wsum0]
        + [t[k_] for k_ in ("lev_ptr", "lev_node", "acc_ptr", "acc_node", "kid_ptr",
                            "kid_idx", "par")]
        + [p, k, None, wv, dz, dl] + [t[k_] for k_ in ("ph_ptr", "run_ptr", "run_node")])
    err = _build.lib().tq_crown_ric_solve(ptrs, Nc, nx, nz, sched.n_ph,
                                          *_ric_launch(sched, nz), _build.stream(dev))
    _build.check(err, name)
    crown_ric_solve.launches += 1
    return dz, dl


crown_ric_solve.launches = 0

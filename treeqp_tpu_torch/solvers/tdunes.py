"""tdunes — dual Newton on the tree formulation.

Port of ``treeqp_tpu/solvers/tdunes.py`` with the clipping stage solver:
the options, the status codes, the static topology prep with its level
schedules, the clipping stage solve, the dual residual and dual value, the
node <-> lambda-group layout converters (the pieces ``tdunes_multistage``
calls), and the generic-tree solver ``tdunes_solve``. The other stage
solvers (dense, boxqp, qpgen, mixed) are not ported yet.

Algorithm (reference ``treeqp/src/dual_Newton_tree.{h,c}``): dualize all
parent->child dynamics constraints with multipliers lambda_c (one per
non-root node); each node becomes an independent small QP parametric in
lambda, solved in closed form by clipping for diagonal Q/R
(dual_Newton_tree_clipping.c); a non-smooth Newton method runs on the
concave dual, whose block-sparse Hessian is factorized by a
tree-structured block Cholesky.

In ``tdunes_solve`` the Hessian blocks, the Jacobi equilibration, the
refinement's Hessian action and the line search are eager PyTorch, as the
JAX package leaves them to XLA; the tree Cholesky and its solves are the
CUDA kernels of ``ops/crown_kernels.py`` (``crown_factor``,
``crown_solve``) and, on multistage-shaped trees, ``ops/chain_kernels.py``
(``chain_factor``, ``chain_solve_bwd``, ``chain_forward``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TreeQPIn, TreeQPOut
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["TdunesOpts", "tdunes_solve", "clipping_applicable", "TDUNES_OPTIMAL",
           "TDUNES_MAX_ITER", "TDUNES_NOT_DESCENT"]

# status codes (cf. reference utils/types.h return_t)
TDUNES_OPTIMAL = 0
TDUNES_MAX_ITER = 1
TDUNES_NOT_DESCENT = 2


@dataclasses.dataclass(frozen=True)
class TdunesOpts:
    """Solver options: the same fields and defaults as
    ``treeqp_tpu.solvers.tdunes.TdunesOpts`` (reference
    treeqp_tdunes_opts_t, dual_Newton_tree.h:67-87), so that one dict builds
    both. The JAX docstrings describe each field; the port implements the
    subsets ``tdunes_solve`` and ``tdunes_multistage.tdunes_ms_solve``
    document and raises ``NotImplementedError`` on the rest."""

    max_iter: int = 100
    termination: str = "infnorm"  # infnorm | twonorm | sumsquared
    tol: float = 1e-8
    ls_max_iter: int = 50
    ls_gamma: float = 0.1
    ls_beta: float = 0.6
    ls_batch: int = 0
    ls_restart_trigger: int = -1  # consecutive maxed-out line searches -> full step
    reg_type: str = "on_the_fly"  # none | always | on_the_fly
    reg_tol: float = 1e-6
    reg_value: float = 1e-6
    stage_solver: str = "clipping"  # clipping | dense | boxqp | qpgen | mixed
    boxqp_iters: int = 8
    qpgen_iters: int = 100
    qpgen_factor_dtype: str = "same"  # same | float32
    node_solver: tuple = None
    factor_dtype: str = "same"  # same | float32
    refine_steps: int = 0
    refine_safeguard: bool = True
    f32_phase_tol: float = 0.0
    f32_patience: int = 3
    df64_phase: bool = False
    reuse_factorization: bool = True
    axis_name: str | None = None
    chain_backend: str = "xla"  # xla | pallas
    record_history: bool = False
    h_diag: bool = False


# ---------------------------------------------------------------------------
# static (numpy) prep derived from the topology


class _Prep:
    """Precomputed static index arrays for one topology (numpy), plus their
    torch copies per device (``on``) and the node masks per dtype and
    device (``masks``), made once and reused by every solve."""

    def __init__(self, topo: TreeStructure):
        self.topo = topo
        self.nxm = topo.nxm
        self.K = max(topo.Kmax, 1)
        self.G = self.K * topo.nxm
        self.NpG = topo.num_groups
        self.par = topo.parent_np.copy()
        self.par[0] = 0  # safe gather for root row (masked)
        self.gnodes = topo.group_nodes
        self.kidsP = topo.kids_padded  # [NpG, K]
        self.kvalid = topo.kids_valid  # [NpG, K]
        self.gdad = topo.group_dad
        self.gslot = topo.group_slot
        # per-node -> position of its lambda inside its group vector
        self.slot_of_node = topo.sib_index
        self.group_of_node = topo.group_of_node

        # backward level schedule of the tree Cholesky: stages Nh-1 .. 1
        # that hold groups (the root group, stage 0, is handled apart)
        self.stages = topo.groups_by_stage
        self.levels = [np.asarray(self.stages[s], np.int32)
                       for s in range(len(self.stages) - 1, 0, -1)
                       if len(self.stages[s]) > 0]
        self._tensors = {}
        self._masks = {}

    def on(self, device) -> dict:
        """The index arrays as long tensors on ``device`` (cached)."""
        device = torch.device(device)
        hit = self._tensors.get(device)
        if hit is None:
            lng = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                            device=device)
            nxm = self.nxm
            hit = dict(
                par=lng(self.par),
                gnodes=lng(self.gnodes),
                kidsP=lng(self.kidsP),
                kvalid=torch.as_tensor(self.kvalid > 0, device=device),
                group_of_node=lng(self.group_of_node),
                # column of each node's lambda inside its group row
                node_cols=lng(self.slot_of_node[:, None] * nxm
                              + np.arange(nxm)[None, :]),
                gdad_safe=lng(np.maximum(self.gdad, 0)),
                gslot_cols=lng(self.gslot[:, None] * nxm
                               + np.arange(nxm)[None, :]),
            )
            self._tensors[device] = hit
        return hit

    def masks(self, dtype, device):
        """(x_mask, u_mask, nonroot_x_mask) tensors (cached)."""
        key = (dtype, torch.device(device))
        hit = self._masks.get(key)
        if hit is None:
            t = self.topo
            hit = tuple(torch.as_tensor(m, dtype=dtype, device=device)
                        for m in (t.x_mask, t.u_mask, t.nonroot_x_mask))
            self._masks[key] = hit
        return hit


_PREP_CACHE: dict = {}


def _get_prep(topo: TreeStructure) -> _Prep:
    if topo not in _PREP_CACHE:
        _PREP_CACHE[topo] = _Prep(topo)
    return _PREP_CACHE[topo]


def _sliced_sched(prep: _Prep):
    """Per-level static-slice schedule of the tree Cholesky, as the JAX
    package builds it: applicable when every occupied stage's group ids
    form a contiguous range (BFS-ordered topologies: multistage trees and
    their prunings). Returns a deepest-first list of per-level tuples
    (c0, w, p0, wp, U[K, wp, w]) — the level's groups c0..c0+w, their
    parent stage's groups p0..p0+wp and the one-hot slot matrix
    U[slot, dad - p0, child - c0] — or None. Cached on the prep."""
    cached = getattr(prep, "_sliced_sched_cache", "miss")
    if cached != "miss":
        return cached
    K = prep.K
    stages = prep.stages
    occupied = [s for s in range(len(stages) - 1, 0, -1) if len(stages[s]) > 0]
    sched = []
    ok = True
    for s in occupied:
        g = np.asarray(stages[s])
        gp = np.asarray(stages[s - 1]) if len(stages[s - 1]) else None
        if gp is None or np.any(np.diff(g) != 1) or np.any(np.diff(gp) != 1):
            ok = False
            break
        c0, w = int(g[0]), len(g)
        p0, wp = int(gp[0]), len(gp)
        dads = prep.gdad[g]
        if np.any((dads < p0) | (dads >= p0 + wp)):
            ok = False
            break
        U = np.zeros((K, wp, w), np.float32)
        U[prep.gslot[g], dads - p0, np.arange(w)] = 1.0
        sched.append((c0, w, p0, wp, U))
    if not ok or (len(stages[0]) != 1 or stages[0][0] != 0):
        sched = None
    prep._sliced_sched_cache = sched
    return sched


def _split_sched(prep: _Prep):
    """Multistage split of the sliced level schedule, as the JAX package
    builds it: the deep levels of a scenario tree are chains (every group
    has exactly one kid, at slot 0, constant width S, identity scenario
    alignment from level to level), factorized by the banded chain kernels;
    the rest is the crown. Returns (chain_levels, crown_levels), both in
    ``_sliced_sched``'s format, the chain levels deepest first and ending
    with the boundary level whose parents are crown groups; or None when
    the tree is not multistage-shaped. Cached on the prep."""
    cached = getattr(prep, "_split_sched_cache", "miss")
    if cached != "miss":
        return cached
    sched = _sliced_sched(prep)
    out = None
    if sched is not None and len(sched) >= 4:
        kvalid = np.asarray(prep.kvalid).astype(bool)
        S = sched[0][1]
        eyeS = np.eye(S, dtype=np.float32)
        chain = []
        i = 0
        while i < len(sched):
            c0, w, p0, wp, U = sched[i]
            kv = kvalid[c0:c0 + w]
            if w != S or not ((kv.sum(1) == 1).all() and kv[:, 0].all()):
                break
            if wp == S:
                if not (np.array_equal(U[0], eyeS) and not U[1:].any()):
                    break
                chain.append(sched[i])
                i += 1
            else:
                chain.append(sched[i])  # boundary level: dads in the crown
                i += 1
                break
        if len(chain) >= 3 and chain[-1][3] < S and i < len(sched):
            out = (chain, sched[i:])
    prep._split_sched_cache = out
    return out


# ---------------------------------------------------------------------------
# solver pieces


def _masks(qp: TreeQPIn, prep: _Prep):
    return prep.masks(qp.dtype, qp.device)


def _stage_data(qp: TreeQPIn, opts: TdunesOpts, prep: _Prep):
    """Per-node clipping data: diag weights + inverses
    (dual_Newton_tree_clipping.c:149-184)."""
    if opts.stage_solver != "clipping":
        raise NotImplementedError(
            f"stage_solver={opts.stage_solver!r}: only the clipping stage "
            "solver is ported (ROADMAP.md, port queue)")
    xm, um, _ = _masks(qp, prep)
    Qd = torch.diagonal(qp.Q, dim1=1, dim2=2) * xm + (1.0 - xm)
    Rd = torch.diagonal(qp.R, dim1=1, dim2=2) * um + (1.0 - um)
    return dict(Qd=Qd, Rd=Rd, Qinv=1.0 / Qd, Rinv=1.0 / Rd)


def _kid_sum(v, prep: _Prep):
    """out[p] = sum over the kids c of node p of v[c]  ([Nn, m] -> [Nn, m]).

    The kids are added one slot at a time in slot order — the order of a
    sequential segment sum — as gathers, so the sum is deterministic on
    the GPU (an ``index_add_`` there adds with atomics in no fixed order)."""
    t = prep.on(v.device)
    kids, kv = t["kidsP"], t["kvalid"]
    acc = torch.where(kv[:, 0, None], v[kids[:, 0]], 0.0)
    for k in range(1, kids.shape[1]):
        acc = acc + torch.where(kv[:, k, None], v[kids[:, k]], 0.0)
    out = torch.zeros_like(v)
    out[t["gnodes"]] = acc
    return out


def _modified_gradient(qp: TreeQPIn, lam, prep: _Prep, extra_q=None,
                       extra_r=None):
    """qmod/rmod with the minus sign built in (solve_stage_problems,
    dual_Newton_tree.c:264-292): qmod = -q + lam_self - sum_kids A_c' lam_c.

    ``extra_q/extra_r`` add externally-computed -A'lam contributions (used by
    the multistage solver to inject chain-edge terms into crown nodes)."""
    xm, um, _ = _masks(qp, prep)
    nx = qp.A.shape[-1]
    AB = torch.cat([qp.A, qp.B], dim=2)
    sum_AB = _kid_sum(torch.einsum("nji,nj->ni", AB, lam), prep)
    sum_A, sum_B = sum_AB[..., :nx], sum_AB[..., nx:]
    if extra_q is not None:
        sum_A = sum_A + extra_q
    if extra_r is not None:
        sum_B = sum_B + extra_r
    qmod = (-qp.q + lam - sum_A) * xm
    rmod = (-qp.r - sum_B) * um
    return qmod, rmod


def _stage_solve(qp: TreeQPIn, lam, data, opts: TdunesOpts, prep: _Prep,
                 extra_q=None, extra_r=None):
    """Batched clipping stage-QP solve over all nodes
    (dual_Newton_tree_clipping.c:188-227): closed-form x = clip(Qinv qmod),
    with active-set-masked inverses qtilde/rtilde. ``data`` comes from
    ``_stage_data``, which rejects the other stage solvers."""
    xm, um, _ = _masks(qp, prep)
    qmod, rmod = _modified_gradient(qp, lam, prep, extra_q, extra_r)
    xUnc = data["Qinv"] * qmod
    uUnc = data["Rinv"] * rmod
    x = torch.clamp(xUnc, qp.xmin, qp.xmax) * xm
    u = torch.clamp(uUnc, qp.umin, qp.umax) * um
    x_active = (xUnc > qp.xmax) | (xUnc < qp.xmin)
    u_active = (uUnc > qp.umax) | (uUnc < qp.umin)
    return dict(qmod=qmod, rmod=rmod, x=x, u=u, xUnc=xUnc, uUnc=uUnc,
                qtilde=torch.where(x_active, 0.0, data["Qinv"]),
                rtilde=torch.where(u_active, 0.0, data["Rinv"]))


def _dual_residual(qp: TreeQPIn, sol, prep: _Prep):
    """Dual gradient res_c = A_c x_p + B_c u_p + b_c - x_c (non-root)
    (build_dual_problem, dual_Newton_tree.c:519-539)."""
    _, _, nrxm = _masks(qp, prep)
    par = prep.on(qp.device)["par"]
    AB = torch.cat([qp.A, qp.B], dim=2)
    zp = torch.cat([sol["x"][par], sol["u"][par]], dim=1)
    return (torch.einsum("nij,nj->ni", AB, zp) + qp.b - sol["x"]) * nrxm


def _dual_value(qp: TreeQPIn, lam, sol, data, opts: TdunesOpts):
    """f(lambda) = -g(lambda), the quantity the reference minimizes
    (stage_qp_clipping_eval_dual_term, dual_Newton_tree_clipping.c:359-382):
    per node -1/2 x'Qx + qmod'x - 1/2 u'Ru + rmod'u, minus sum_c b_c'lam_c."""
    x, u = sol["x"], sol["u"]
    tx = x * (sol["qmod"] - 0.5 * data["Qd"] * x) - qp.b * lam
    tu = u * (sol["rmod"] - 0.5 * data["Rd"] * u)
    return torch.sum(tx) + torch.sum(tu)


# layout converters between per-node rows [Nn, nxm] and the lambda-group
# layout [NpG, G] (G = K slots of nxm). The JAX package writes them as
# one-hot matmuls (gathers serialize on the TPU); each output element has
# exactly one source, so these indexed forms give the same values.


def _group_to_nodes_mm(v_g, prep: _Prep, dt):
    """[NpG, G] grouped vector -> per-node rows [Nn, nxm] (row 0 zero)."""
    t = prep.on(v_g.device)
    out = v_g[t["group_of_node"][:, None], t["node_cols"]].to(dt)
    out[0] = 0.0
    return out


def _nodes_to_group_mm(v_n, prep: _Prep):
    """Per-node rows [Nn, nxm] -> grouped kid stacks [NpG, G] (0 on empty
    slots)."""
    t = prep.on(v_n.device)
    g = torch.where(t["kvalid"][:, :, None], v_n[t["kidsP"]], 0.0)
    return g.reshape(prep.NpG, prep.G)


def diag_weights_applicable(qp: TreeQPIn, atol: float = 0.0) -> bool:
    """Diagonal Q/R, zero S — the layout requirement of the crown+chains
    solvers. Host-side check on concrete data."""
    def off_diag(M):
        return (M - torch.diag_embed(torch.diagonal(M, dim1=1, dim2=2))).abs().max()
    return bool(off_diag(qp.Q) <= atol and off_diag(qp.R) <= atol
                and qp.S.abs().max() <= atol)


def clipping_applicable(qp: TreeQPIn, atol: float = 0.0) -> bool:
    """Clipping requires diagonal Q/R, zero S, no general constraints
    (stage_qp_clipping_is_applicable, dual_Newton_tree_clipping.c:45-77).
    Host-side check on concrete data."""
    return diag_weights_applicable(qp, atol) and max(qp.topo.nc) == 0


# ---------------------------------------------------------------------------
# the generic-tree solver


def _armijo(f_at, f0, dot, f1, rest1, opts, slack=2.0 ** -45, tau_dtype=None):
    """Armijo backtracking on f = -g from the tau = 1 trial (f1, rest1)
    (reference dual_Newton_tree.c:958-992), shared by the Newton loops of
    ``tdunes_solve`` and ``tdunes_multistage``.

    ``f_at(tau)`` evaluates the trial point lam + tau d and returns (f,
    rest). The scalars are 0-dim tensors of the data dtype, so an f32
    phase takes its decisions in f32, as the JAX package does. With
    ``opts.ls_batch`` = T > 0 a rejected full step tries the candidates
    tau = beta^k, k = 1..T (powers in the data dtype), and takes the first
    accepted one: the JAX package evaluates them as one vmapped batch; here
    they are evaluated in order up to the first accepted, which gives the
    same step. Beyond them, and when T = 0, the search backtracks
    sequentially (tau <- beta tau) up to ``ls_max_iter`` trials.

    A trial is accepted when f <= f0 + gamma tau dot + slack |f0|. The steps
    tau are 0-dim tensors of ``tau_dtype`` (default: f0's dtype; the
    high-precision phase takes f32 steps on f64 values, as the JAX
    package's double-float phase does).

    Returns (tau, f, rest, ls_it, accepted): the accepted trial, or the
    last one tried.
    """
    # noise-aware slack: the dual value carries ~sqrt(Nterms)*eps relative
    # noise; near convergence exact comparisons stall
    eta = slack * f0.abs()
    tdt = f0.dtype if tau_dtype is None else tau_dtype

    def accepts(f, tau):
        return bool(f <= f0 + opts.ls_gamma * tau * dot + eta)

    one = torch.ones((), dtype=tdt, device=f0.device)
    if accepts(f1, one):
        return one, f1, rest1, 1, True
    tau, f, rest, ls_it = one, f1, rest1, 1
    T = min(opts.ls_batch, opts.ls_max_iter)
    if T > 0:
        taus = torch.pow(torch.full((), opts.ls_beta, dtype=tdt, device=f0.device),
                         torch.arange(1, T + 1, dtype=tdt, device=f0.device))
        for k in range(T):
            f, rest = f_at(taus[k])
            if accepts(f, taus[k]):
                return taus[k], f, rest, k + 2, True
        tau, ls_it = taus[-1], T + 1
    acc = False
    while not acc and ls_it < opts.ls_max_iter:
        tau = opts.ls_beta * tau
        f, rest = f_at(tau)
        ls_it += 1
        acc = accepts(f, tau)
    return tau, f, rest, ls_it, acc


def _residual_error(res, opts: TdunesOpts):
    """The termination measure of the dual residual (0-dim tensor)."""
    if opts.termination == "infnorm":
        return res.abs().max()
    sq = torch.sum(res * res)
    return torch.sqrt(sq) if opts.termination == "twonorm" else sq


def _build_dual_hessian(qp: TreeQPIn, sol, prep: _Prep):
    """The lambda-group blocks W [NpG, G, G] and parent couplings Ut
    [NpG, nxm, G] of M = J P J' with the clipping stage solver
    (build_dual_problem, dual_Newton_tree.c:551-615, clipping vtable
    dual_Newton_tree_clipping.c:264-355), built directly in f32: they feed
    only the f32 factorization."""
    dt = torch.float32
    t = prep.on(qp.device)
    NpG, G, nxm = prep.NpG, prep.G, prep.nxm
    kv = t["kvalid"].to(dt)[:, :, None, None]
    Ak = qp.A.to(dt)[t["kidsP"]] * kv                     # [NpG, K, nxm, nxm]
    Bk = qp.B.to(dt)[t["kidsP"]] * kv                     # [NpG, K, nxm, num]
    qtp = sol["qtilde"].to(dt)[t["gnodes"]]               # parent's masked inverses
    rtp = sol["rtilde"].to(dt)[t["gnodes"]]
    Af = (Ak * torch.sqrt(qtp)[:, None, None, :]).reshape(NpG, G, nxm)
    Bf = (Bk * torch.sqrt(rtp)[:, None, None, :]).reshape(NpG, G, Bk.shape[-1])
    W = Af @ Af.transpose(1, 2) + Bf @ Bf.transpose(1, 2)
    # + E P_c E' on the diagonal (add_EPmE): the kids' own qtilde
    dvals = torch.where(t["kvalid"][:, :, None], sol["qtilde"].to(dt)[t["kidsP"]],
                        1.0).reshape(NpG, G)
    W = W + torch.diag_embed(dvals)
    # coupling of group g to its parent's lambda: -qtilde_p A_k'
    Ut = -qtp[:, :, None] * Ak.permute(0, 3, 1, 2).reshape(NpG, nxm, G)
    return W, Ut


def _split_index(prep: _Prep, split, device) -> dict:
    """Index tensors of the split path (cached on the prep): ``chain``
    [S, L] the group of chain s at chain level j (j = 0 the boundary level
    next to the crown), ``dad`` / ``slot`` [S] the crown group and kid slot
    each chain hangs from, ``crown`` the crown levels as group-id arrays
    for ``crown_kernels``' schedule, and ``Nc`` the crown's group count.
    The crown's groups are 0..Nc-1: nodes come after their parents, so
    with each stage's groups contiguous (``_sliced_sched``) the shallow
    stages' groups come first."""
    cache = prep.__dict__.setdefault("_split_index", {})
    device = torch.device(device)
    hit = cache.get(device)
    if hit is None:
        chain_levels, crown_levels = split
        S = chain_levels[0][1]
        ids = np.stack([c0 + np.arange(S) for c0, *_ in reversed(chain_levels)], axis=1)
        lng = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)
        crown = [np.arange(c0, c0 + w) for c0, w, *_ in crown_levels]
        hit = dict(chain=lng(ids), dad=lng(prep.gdad[ids[:, 0]]),
                   slot=lng(prep.gslot[ids[:, 0]]), crown=crown,
                   Nc=1 + sum(len(lv) for lv in crown))
        cache[device] = hit
    return hit


def _tree_chol_factor(W, Ut, opts: TdunesOpts, prep: _Prep):
    """Tree-structured block Cholesky of the equilibrated f32 blocks
    (backward half of calculate_delta_lambda, dual_Newton_tree.c:668-735).

    On a multistage-shaped tree (``_split_sched``) the chain levels go
    through ``chain_factor`` (blocks [nxm, nxm], the LM shift pre-added),
    their Schur blocks into the crown groups they hang from, and the
    crown's groups alone through ``crown_factor``; on any other tree the
    whole tree goes through ``crown_factor``. The JAX package runs the
    split's crown in
    XLA and chooses between the paths by a TPU memory estimate; here
    every path is the kernels. Returns the stored factors for
    ``_tree_chol_solve``."""
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    reg = opts.reg_value if opts.reg_type == "always" else 0.0
    W, Ut = W.contiguous(), Ut.contiguous()
    split = _split_sched(prep)
    if split is None:
        CholW, CholUt = ckr.crown_factor(W, Ut, prep, reg=reg)
        return dict(CholW=CholW, CholUt=CholUt)
    sp = _split_index(prep, split, W.device)
    nxm, K, Nc = prep.nxm, prep.K, sp["Nc"]
    eye = torch.eye(nxm, dtype=W.dtype, device=W.device)
    Wc = (W[sp["chain"], :nxm, :nxm] + reg * eye).contiguous()
    Ls, CUs, schur0 = ck.chain_factor(Wc, Ut[sp["chain"], :, :nxm].contiguous())
    Wcr = W[:Nc].clone()
    Wcr.view(Nc, K, nxm, K, nxm)[sp["dad"], sp["slot"], :, sp["slot"], :] -= schur0
    CholW, CholUt = ckr.crown_factor(Wcr, Ut[:Nc], prep, reg=reg, levels=sp["crown"])
    return dict(Ls=Ls, CUs=CUs, CholW=CholW, CholUt=CholUt)


def _tree_chol_solve(fact, rg, prep: _Prep):
    """Solve M dlam = rg with ``_tree_chol_factor``'s factors, in f32:
    on the split path the chain backward sweeps, their right-hand-side
    updates into the crown, the crown solve, and the chain forward sweeps
    from the crown's direction at each chain's edge
    (dual_Newton_tree.c:745-775). Returns dlam [NpG, G] in rg's dtype."""
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    out_dt = rg.dtype
    rd = rg.to(torch.float32).contiguous()
    split = _split_sched(prep)
    if split is None:
        return ckr.crown_solve(fact["CholW"], fact["CholUt"], rd, prep).to(out_dt)
    sp = _split_index(prep, split, rg.device)
    nxm, K, Nc = prep.nxm, prep.K, sp["Nc"]
    ys, radd0 = ck.chain_solve_bwd(fact["Ls"], fact["CUs"],
                                   rd[sp["chain"], :nxm].contiguous())
    rcr = rd[:Nc].clone()
    rcr.view(Nc, K, nxm)[sp["dad"], sp["slot"]] -= radd0
    dcr = ckr.crown_solve(fact["CholW"], fact["CholUt"], rcr, prep, levels=sp["crown"])
    droot = dcr.view(Nc, K, nxm)[sp["dad"], sp["slot"]].contiguous()
    dl = torch.zeros_like(rd)
    dl[:Nc] = dcr
    dl[sp["chain"], :nxm] = ck.chain_forward(fact["Ls"], fact["CUs"], ys, droot)
    return dl.to(out_dt)


def _equilibrate(W, Ut, prep: _Prep):
    """Jacobi equilibration M~ = S M S, S = 1/sqrt(max(diag M, 1e-12)):
    returns (sW [NpG, G], the scaled W and Ut)."""
    t = prep.on(W.device)
    sW = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(W, dim1=1, dim2=2), min=1e-12))
    sUt_rows = sW[t["gdad_safe"][:, None], t["gslot_cols"]]
    return (sW, (W * sW[:, :, None] * sW[:, None, :]).contiguous(),
            (Ut * sUt_rows[:, :, None] * sW[:, None, :]).contiguous())


def _newton_factor(W, Ut, opts: TdunesOpts, prep: _Prep):
    """Equilibrate and factor; returns (scales, factors) for repeated
    ``_newton_solve`` calls."""
    sW, Ws, Uts = _equilibrate(W, Ut, prep)
    return sW, _tree_chol_factor(Ws, Uts, opts, prep)


def _newton_solve(sW, fact, rg, prep: _Prep):
    return _tree_chol_solve(fact, rg * sW, prep) * sW


def _apply_M_nodes(qp: TreeQPIn, sol, d_nodes, prep: _Prep):
    """Exact dual-Hessian action M d in the data dtype, via the J P J'
    structure: the linearized clipping stage response to a dual
    perturbation d, pushed through the linearized dynamics residual. Used
    for iterative refinement of f32-factored Newton directions."""
    xm, um, nrxm = _masks(qp, prep)
    nxm = prep.nxm
    par = prep.on(qp.device)["par"]
    AtBt = torch.cat([torch.einsum("nji,nj->ni", qp.A, d_nodes),
                      torch.einsum("nji,nj->ni", qp.B, d_nodes)], dim=1)
    sums = _kid_sum(AtBt, prep)
    xl = sol["qtilde"] * (d_nodes - sums[:, :nxm]) * xm
    ul = sol["rtilde"] * (-sums[:, nxm:]) * um
    res = (torch.einsum("nij,nj->ni", qp.A, xl[par])
           + torch.einsum("nij,nj->ni", qp.B, ul[par]) - xl) * nrxm
    return -res


def _newton_direction(W, Ut, rg, opts: TdunesOpts, prep: _Prep, qp, sol):
    """Factor + solve (calculate_delta_lambda) with Jacobi equilibration;
    with ``refine_steps`` > 0, plain or safeguarded iterative refinement of
    the f32-factored direction against the exact data-dtype Hessian
    action."""
    sW, fact = _newton_factor(W, Ut, opts, prep)
    dlam_g = _newton_solve(sW, fact, rg, prep)
    if opts.refine_steps == 0:
        return dlam_g
    nrxm = _masks(qp, prep)[2]

    def M_g(dg):
        d_nodes = _group_to_nodes_mm(dg, prep, qp.dtype) * nrxm
        return _nodes_to_group_mm(_apply_M_nodes(qp, sol, d_nodes, prep), prep)

    if not opts.refine_safeguard:
        for _ in range(opts.refine_steps):
            dlam_g = dlam_g + _newton_solve(sW, fact, rg - M_g(dlam_g), prep)
        return dlam_g
    # safeguarded: keep the candidate with the smaller Newton-system residual
    resid = rg - M_g(dlam_g)
    n_best = torch.sum(resid * resid)
    for _ in range(opts.refine_steps):
        cand = dlam_g + _newton_solve(sW, fact, resid, prep)
        resid2 = rg - M_g(cand)
        n_new = torch.sum(resid2 * resid2)
        if bool(n_new < n_best):
            dlam_g, resid, n_best = cand, resid2, n_new
    return dlam_g


def _line_search(qp: TreeQPIn, lam, dlam_nodes, sol0, dlam_g, rg, data,
                 opts: TdunesOpts, prep: _Prep, restart: int):
    """Armijo backtracking on f = -g (line_search,
    dual_Newton_tree.c:922-1019): accept tau when f(lam + tau d) <= f(lam)
    + gamma tau grad'd + slack |f(lam)|, grad'd = -sum res . dlam, with the
    noise slack 2^-45 (f64) or 2^-18 (f32). With ``ls_batch`` = T > 0 the
    JAX package evaluates tau = beta^k, k = 0..T-1, as one batch and
    backtracks sequentially beyond; ``_armijo`` gives the same steps. The
    restart heuristic takes a full step after ``ls_restart_trigger``
    consecutive maxed-out searches. Returns (new lam, ls iterations,
    descent ok, restart count)."""
    dt = lam.dtype
    dot = -torch.sum(rg * dlam_g)
    # documented deviation of the JAX package: the reference requires < 0
    # (dual_Newton_tree.c:951); near the residual floor g'd rounds to
    # +-eps. NaN compares false: not a descent.
    descent_ok = bool(dot < 1e-10)
    f0 = _dual_value(qp, lam, sol0, data, opts)

    def f_at(tau):
        lt = lam + tau * dlam_nodes
        return _dual_value(qp, lt, _stage_solve(qp, lt, data, opts, prep), data, opts), None

    one = torch.ones((), dtype=dt, device=lam.device)
    f1, _ = f_at(one)
    # the JAX batch of T includes tau = 1: T - 1 candidates after it
    T = min(opts.ls_batch, opts.ls_max_iter)
    ls_opts = dataclasses.replace(opts, ls_batch=max(T - 1, 0))
    slack = 2.0 ** -45 if dt == torch.float64 else 2.0 ** -18
    tau, _, _, ls_it, acc = _armijo(f_at, f0, dot, f1, None, ls_opts, slack=slack)
    restart = 0 if acc else restart + 1
    if opts.ls_restart_trigger > 0 and restart >= opts.ls_restart_trigger:
        tau, restart = one, 0
    return lam + tau * dlam_nodes, ls_it, descent_ok, restart


def _td_newton_loop(qp: TreeQPIn, lam0, opts: TdunesOpts, it0: int,
                    patience: int = 0):
    """One dual-Newton loop at the dtype of ``qp``'s data, counting
    iterations from ``it0``: per iteration the stage solve and the dual
    residual at lam, the termination test, then (unless converged) the
    Hessian blocks, the Newton direction and the line search.
    ``patience > 0`` adds the coarse phase's stall exit: stop once the
    error has not improved by 10% for ``patience`` consecutive iterations.
    Returns (lam, it, err, status, ls_it); err is a 0-dim tensor."""
    prep = _get_prep(qp.topo)
    dt = qp.dtype
    nrxm = _masks(qp, prep)[2]
    data = _stage_data(qp, opts, prep)
    lam, it, status, restart, ls_it = lam0, it0, TDUNES_OPTIMAL, 0, 0
    err = best = torch.full((), math.inf, dtype=dt, device=qp.device)
    noimp = 0
    while (bool(err >= opts.tol) and status == TDUNES_OPTIMAL
           and it < opts.max_iter and (patience <= 0 or noimp < patience)):
        sol = _stage_solve(qp, lam, data, opts, prep)
        res = _dual_residual(qp, sol, prep)
        err = _residual_error(res, opts)
        noimp = 0 if bool(err < 0.9 * best) else noimp + 1
        best = torch.minimum(best, err)
        if bool(err < opts.tol):
            break
        W, Ut = _build_dual_hessian(qp, sol, prep)
        rg = _nodes_to_group_mm(res, prep)
        dlam_g = _newton_direction(W, Ut, rg, opts, prep, qp, sol)
        dlam_nodes = _group_to_nodes_mm(dlam_g, prep, dt) * nrxm
        lam_new, ls_it, descent_ok, restart = _line_search(
            qp, lam, dlam_nodes, sol, dlam_g, rg, data, opts, prep, restart)
        if descent_ok:
            lam = lam_new
        else:
            status = TDUNES_NOT_DESCENT
        it += 1
    return lam, it, err, status, ls_it


def _check_generic(qp: TreeQPIn, opts: TdunesOpts, stage_ws):
    """Raise on options ``tdunes_solve`` does not implement yet."""
    if opts.stage_solver == "clipping" and not clipping_applicable(qp):
        raise ValueError(
            "clipping stage solver not applicable (needs diagonal Q/R, zero "
            "S, nc=0) (cf. stage_qp_clipping_is_applicable)")
    later = "is not ported yet (ROADMAP.md, port queue)"
    prep = _get_prep(qp.topo)
    for bad, what in (
            (opts.stage_solver != "clipping", f"stage_solver={opts.stage_solver!r}"),
            (stage_ws is not None, "stage_ws (the qpgen working-set hotstart)"),
            (opts.chain_backend != "pallas",
             f"chain_backend={opts.chain_backend!r} (the unfused tree Cholesky)"),
            (opts.factor_dtype != "float32", f"factor_dtype={opts.factor_dtype!r}"),
            (opts.reg_type not in ("always", "none"), f"reg_type={opts.reg_type!r}"),
            (opts.record_history, "record_history"),
            (opts.axis_name is not None, "axis_name (multi-device)"),
            (not (0 < prep.NpG and prep.G <= 64 and prep.nxm <= 16),
             f"a tree with {prep.NpG} lambda-groups of dim {prep.G}")):
        if bad:
            raise NotImplementedError(f"{what} {later}")


def tdunes_solve(qp: TreeQPIn, lam0=None, opts: TdunesOpts = TdunesOpts(),
                 stage_ws=None) -> TreeQPOut:
    """Solve a tree QP with dual Newton on the tree formulation
    (``treeqp_tdunes_solve``, dual_Newton_tree.c:1104-1263), on any tree
    topology, on the device of ``qp``'s tensors.

    ``lam0`` [Nn, nxm] warm-starts the duals (zeros when None). Ported:
    the clipping stage solver with f32 factors on the tree-Cholesky
    kernels (``factor_dtype="float32"``, ``chain_backend="pallas"``, a
    static regularization), one- and two-phase (``f32_phase_tol > 0``
    with f64 data: a coarse phase with everything in f32 down to
    f32_phase_tol or a stall of ``f32_patience`` iterations, then the
    data-dtype phase with refinement), plain or safeguarded refinement,
    sequential or batched Armijo, all three terminations. The other
    options raise ``NotImplementedError``. ``info["iter_f32"]`` counts the
    coarse iterations, ``info["iter"]`` both phases.
    """
    _check_generic(qp, opts, stage_ws)
    topo = qp.topo
    prep = _get_prep(topo)
    dt = qp.dtype
    xm, um, nrxm = _masks(qp, prep)
    if lam0 is None:
        lam0 = torch.zeros((topo.Nn, topo.nxm), dtype=dt, device=qp.device)
    lam0 = lam0 * nrxm

    it0 = 0
    if opts.f32_phase_tol > 0 and dt == torch.float64:
        f32 = torch.float32
        optsA = dataclasses.replace(opts, refine_steps=0,
                                    tol=max(opts.f32_phase_tol, opts.tol))
        lamA, it0, *_ = _td_newton_loop(qp.to(dtype=f32), lam0.to(f32), optsA, 0,
                                        patience=opts.f32_patience)
        # the coarse phase's status is dropped: a not-descent there is
        # expected noise near the f32 residual floor, not a failure
        lam0 = lamA.to(dt) * nrxm

    lam, it, _, status, ls_it = _td_newton_loop(qp, lam0, opts, it0)
    # final stage solve + multiplier recovery (dual_Newton_tree.c:1235-1247)
    data = _stage_data(qp, opts, prep)
    sol = _stage_solve(qp, lam, data, opts, prep)
    err = float(_residual_error(_dual_residual(qp, sol, prep), opts))
    if status == TDUNES_OPTIMAL and err >= opts.tol:
        status = TDUNES_MAX_ITER
    info = dict(iter=it, status=status, error=err, ls_iter=ls_it, iter_f32=it0)
    return TreeQPOut(
        x=sol["x"], u=sol["u"], lam=lam * nrxm,
        # mu = Q .* (xUnc - x) (stage_qp_clipping_export_mu)
        mu_x=data["Qd"] * (sol["xUnc"] - sol["x"]) * xm,
        mu_u=data["Rd"] * (sol["uUnc"] - sol["u"]) * um,
        mu_d=torch.zeros((topo.Nn, topo.ncm), dtype=dt, device=qp.device),
        info=info)

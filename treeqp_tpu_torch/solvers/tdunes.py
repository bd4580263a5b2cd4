"""tdunes — dual Newton on the tree formulation.

Port of ``treeqp_tpu/solvers/tdunes.py``: the options, the status codes,
the static topology prep with its level schedules, the stage solvers, the
dual residual and dual value, the node <-> lambda-group layout converters
(the pieces ``tdunes_multistage`` calls), and the generic-tree solver
``tdunes_solve``.

Algorithm (reference ``treeqp/src/dual_Newton_tree.{h,c}``): dualize all
parent->child dynamics constraints with multipliers lambda_c (one per
non-root node); each node becomes an independent small QP parametric in
lambda; a non-smooth Newton method runs on the concave dual, whose
block-sparse Hessian M = J P J' is factorized by a tree-structured block
Cholesky. The stage QPs (``stage_solver``):

* clipping — closed form for diagonal Q/R, S = 0, no C/D rows
  (dual_Newton_tree_clipping.c); P is diagonal;
* dense — unconstrained general Hessians, P = H^-1;
* boxqp — general Hessians with bounds, batched projected Newton;
* qpgen — general stage QPs with C/D rows (the qpOASES capability,
  dual_Newton_tree_qpoases.c): ADMM active-set identification on the
  ``admm_identify`` kernel, PDAS with a keep-best guard, an exact polish
  and the elimination matrix P = Z (Z'HZ)^-1 Z' (``_qpgen_batch``), with
  the working-set hotstart carried across Newton iterations and solves;
* mixed — clipping on the nodes where it applies, qpgen on the rest.

In ``tdunes_solve`` the stage solves, the Hessian blocks, the Jacobi
equilibration, the refinement's Hessian action and the line search are
eager PyTorch, as the JAX package leaves them to XLA; the ADMM loop of the
general stage QPs is the CUDA kernel of ``ops/qpgen_lanes.py``. The tree
Cholesky and its solves take one of two routes, chosen by the options
alone as the JAX package chooses them: with ``chain_backend="pallas"``, f32
factors and a static regularization (``reg_type`` "always" or "none") the
CUDA kernels of ``ops/crown_kernels.py`` (``crown_factor``,
``crown_solve``) and, on multistage-shaped trees, ``ops/chain_kernels.py``
(``chain_factor``, ``chain_solve_bwd``, ``chain_forward``); otherwise the
plain level-synchronous tree Cholesky at the factor dtype, with the
regularized block Cholesky ``_reg_cholesky`` (none, always, or the
on-the-fly Levenberg-Marquardt cascade).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TREEQP_INF, TreeQPIn, TreeQPOut
from treeqp_tpu_torch.solvers.ipm import _constraint_data
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["TdunesOpts", "tdunes_solve", "clipping_applicable", "diag_weights_applicable",
           "clipping_applicable_nodes", "STAGE_SOLVERS", "TDUNES_OPTIMAL",
           "TDUNES_MAX_ITER", "TDUNES_NOT_DESCENT"]

STAGE_SOLVERS = ("clipping", "dense", "boxqp", "qpgen", "mixed")

# status codes (cf. reference utils/types.h return_t)
TDUNES_OPTIMAL = 0
TDUNES_MAX_ITER = 1
TDUNES_NOT_DESCENT = 2


@dataclasses.dataclass(frozen=True)
class TdunesOpts:
    """Solver options: the same fields and defaults as
    ``treeqp_tpu.solvers.tdunes.TdunesOpts`` (reference
    treeqp_tdunes_opts_t, dual_Newton_tree.h:67-87), so that one dict builds
    both. The JAX docstrings describe each field; ``tdunes_solve`` and
    ``tdunes_multistage.tdunes_ms_solve`` take every field. ``axis_name``
    names the scenario axis of a sharded ``tdunes_ms_solve``
    (``parallel.sharding``); ``tdunes_solve`` does not read it, as in the
    JAX package."""

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
        self.nxm, self.num = topo.nxm, topo.num
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
        self._levels_on = {}

    def levels_on(self, device) -> list:
        """``levels`` as (groups, their dad groups, their slots there) long
        tensors on ``device`` (cached): the plain tree Cholesky's schedule."""
        device = torch.device(device)
        hit = self._levels_on.get(device)
        if hit is None:
            lng = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)
            hit = [(lng(g), lng(self.gdad[g]), lng(self.gslot[g])) for g in self.levels]
            self._levels_on[device] = hit
        return hit

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


def _bmv(M, v):
    """Batched M v: [..., m, k] x [..., k] -> [..., m]."""
    return (M @ v[..., None])[..., 0]


def _bmv_t(M, v):
    """Batched M' v: [..., m, k] x [..., m] -> [..., k]."""
    return (M.mT @ v[..., None])[..., 0]


def _cholesky(M):
    """Lower Cholesky factors of a batch of SPD matrices, with NaN in the
    lower triangle where a factorization fails (XLA's convention, which the
    guards downstream read; ``torch.linalg.cholesky`` would raise instead,
    and ``cholesky_ex`` leaves a partial factor)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info[..., None, None] > 0, torch.full_like(L, torch.nan).tril(), L)


def _dense_H(qp: TreeQPIn, prep: _Prep):
    """Per-node dense Hessian [[Q S'],[S R]], identity on padded dims."""
    xm, um, _ = _masks(qp, prep)
    Sm = qp.S * um[:, :, None] * xm[:, None, :]
    H = torch.cat([torch.cat([qp.Q * xm[:, :, None] * xm[:, None, :], Sm.mT], dim=2),
                   torch.cat([Sm, qp.R * um[:, :, None] * um[:, None, :]], dim=2)], dim=1)
    return H + torch.diag_embed(1.0 - torch.cat([xm, um], dim=1))


def _batched_inverse_spd(H):
    Linv = torch.linalg.solve_triangular(
        _cholesky(H), torch.eye(H.shape[-1], dtype=H.dtype, device=H.device).expand_as(H),
        upper=False)
    return Linv.mT @ Linv


def _stage_data(qp: TreeQPIn, opts: TdunesOpts, prep: _Prep):
    """Per-node solver data: diag weights + inverses (clipping,
    dual_Newton_tree_clipping.c:149-184), dense H and its bounds (boxqp),
    the general-constraint machinery (qpgen/mixed: constraint stack G,
    H^-1, the per-row ADMM penalty and the ADMM factor, the hoisted
    products G H^-1 and G H^-1 G'), or dense H and P = H^-1 (dense). In
    mixed mode, ``gen`` holds the general nodes' index and their rows of
    the qpgen fields."""
    xm, um, _ = _masks(qp, prep)
    s = opts.stage_solver
    data = {}
    if s in ("clipping", "mixed"):
        Qd = torch.diagonal(qp.Q, dim1=1, dim2=2) * xm + (1.0 - xm)
        Rd = torch.diagonal(qp.R, dim1=1, dim2=2) * um + (1.0 - um)
        data.update(Qd=Qd, Rd=Rd, Qinv=1.0 / Qd, Rinv=1.0 / Rd)
    if s == "boxqp":
        H = _dense_H(qp, prep)
        data.update(H=H, Hd=torch.diagonal(H, dim1=1, dim2=2),
                    lo=torch.cat([qp.xmin, qp.umin], dim=1),
                    hi=torch.cat([qp.xmax, qp.umax], dim=1))
    elif s in ("qpgen", "mixed"):
        dt = qp.dtype
        H = _dense_H(qp, prep)
        G, lo, hi, m_lo, m_hi = _constraint_data(qp)
        Hd = torch.diagonal(H, dim1=1, dim2=2)
        Hinv = _batched_inverse_spd(H)
        # per-row ADMM penalty: base = Hessian scale; equality rows
        # (lo == hi) get a 1e3 stiffer penalty (OSQP convention)
        eq = _general_bounds(lo, hi, m_lo, m_hi)[2]
        rho_row = Hd.mean(dim=1, keepdim=True) * (1.0 + 999.0 * eq)
        # the ADMM factor in the qpgen factor dtype: the identification
        # only seeds the working set (PDAS and the polish recompute every
        # final quantity in the data dtype)
        adt = (torch.float32 if opts.qpgen_factor_dtype == "float32"
               and dt == torch.float64 else dt)
        L_admm = _cholesky((H + (G * rho_row[:, :, None]).mT @ G).to(adt))
        GH = G @ Hinv
        data.update(H=H, Hd=Hd, Hinv=Hinv, G=G, lo=lo, hi=hi, m_lo=m_lo, m_hi=m_hi,
                    rho_row=rho_row, L_admm=L_admm, GH=GH, GHG=GH @ G.mT)
        if s == "mixed":
            idx = np.nonzero(np.asarray(opts.node_solver) == 0)[0]
            if len(idx):
                gi = torch.as_tensor(idx, dtype=torch.long, device=qp.device)
                data["gen"] = {k: data[k][gi] for k in _QPGEN_KEYS + ("GH", "GHG")}
                data["gen"]["idx"] = gi
    elif s != "clipping":
        H = _dense_H(qp, prep)
        data.update(H=H, P=_batched_inverse_spd(H))
    return data


# _qpgen_batch's per-node operands, in its argument order
_QPGEN_KEYS = ("H", "Hinv", "G", "lo", "hi", "m_lo", "m_hi", "rho_row", "L_admm")


def _kid_sum(v, prep: _Prep):
    """out[p] = sum over the kids c of node p of v[c]  ([Nn, m] -> [Nn, m]).

    The kids are added one slot at a time in slot order — the order of a
    sequential segment sum — as gathers, so the sum is deterministic on
    the GPU (an ``index_add_`` there adds with atomics in no fixed order)."""
    t = prep.on(v.device)
    kids, kv = t["kidsP"], t["kvalid"]
    if kids.shape[1] == 0:  # a tree of one node: no kid slots
        return torch.zeros_like(v)
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


def _general_bounds(lo, hi, m_lo, m_hi):
    """The general stage QPs' bounds with +-TREEQP_INF on the sides without
    one (lo_c, hi_c), and the mask of the equality rows (lo == hi)."""
    lo_c = torch.where(m_lo > 0, lo, -TREEQP_INF)
    hi_c = torch.where(m_hi > 0, hi, TREEQP_INF)
    return lo_c, hi_c, ((hi_c - lo_c <= 1e-14) & (m_lo > 0) & (m_hi > 0)).to(lo.dtype)


def _admm_operands(hmod, Hinv, G, lo_c, hi_c, rho_row, L_admm):
    """``admm_identify``'s operands at the cold start of ``_qpgen_batch``
    (lo_c/hi_c: the bounds with +-TREEQP_INF on the sides without one), in
    the ADMM factor's dtype: f32 under qpgen_factor_dtype="float32", as the
    identification only seeds the working set."""
    c = lambda v: v.to(L_admm.dtype).contiguous()
    return (c(G), c(L_admm), c(rho_row), c(lo_c), c(hi_c), c(hmod), c(_bmv(Hinv, hmod)))


def _admm_working_sets(lm, rho_row, m_lo, m_hi, m_eq):
    """The working sets (m_up, m_dn) the ADMM output seeds: the rows whose
    multiplier mu = rho lm exceeds the activity threshold, set at the
    identification dtype's noise floor relative to the node's largest
    multiplier; equality rows are left to m_eq."""
    dt = rho_row.dtype
    mu_admm = rho_row * lm.to(dt)
    tol_act = (1e-9 if lm.dtype == torch.float64 else 1e-5) * torch.clamp(
        mu_admm.abs().amax(dim=1, keepdim=True), min=1.0)
    m_up = ((mu_admm > tol_act) & (m_hi > 0)).to(dt) * (1.0 - m_eq)
    m_dn = ((mu_admm < -tol_act) & (m_lo > 0)).to(dt) * (1.0 - m_eq)
    return m_up, m_dn


def _qpgen_batch(hmod, H, Hinv, G, lo, hi, m_lo, m_hi, rho_row, L_admm,
                 opts: TdunesOpts, ws=None, GH=None, GHG=None):
    """Batched general stage QPs:  min 1/2 z'Hz - hmod'z,  lo <= G z <= hi.

    The qpOASES capability (dual_Newton_tree_qpoases.c:153-214, :401-476),
    node-major, in three phases:

    1. scaled ADMM active-set identification (``qpgen_iters`` iterations,
       per-row penalty with stiff equality rows), on the ``admm_identify``
       kernel in the ADMM factor's dtype;
    2. primal-dual active-set refinement steps with a per-node keep-best
       safeguard (the working set with the smallest KKT residual);
    3. one exact KKT polish on the selected set, and the elimination matrix
       P = H^-1 - H^-1 G_A' (G_A H^-1 G_A')^-1 G_A H^-1.

    With ``qpgen_factor_dtype="float32"`` and f64 data the working-set
    systems are factored in f32 and refined 3 times against the f64
    residual, and the inverse of phase 3 is the f32 inverse plus two
    Newton-Schulz steps in f64, falling back to the f64 inverse when their
    residual is not below 1e-6. The lane-major double-float pipeline the
    JAX package runs on the TPU (``qpgen_solve_lanes``) is a TPU workaround
    and is not ported: this is the JAX node-major path in native f64.

    Equality rows (lo == hi) stay permanently active. ``ws``: optional
    (m_up, m_dn) working-set hotstart (dual_Newton_tree_qpoases.c:312-356):
    phases 2+3 run from the given set, and phase 1 runs only if the
    hotstarted set fails the KKT guard (max residual < 1e-9; one host
    decision). Returns (z, P, mu, res, (m_up, m_dn)): mu signed (positive =
    upper active), res = the max over nodes of the violation/stationarity
    guard (0-dim tensor), and the final working-set masks."""
    from treeqp_tpu_torch.ops.qpgen_lanes import admm_identify
    dt, dev = hmod.dtype, hmod.device
    ng = G.shape[1]
    factor32 = opts.qpgen_factor_dtype == "float32" and dt == torch.float64
    fdt = torch.float32 if factor32 else dt
    n_refine = 3 if factor32 else 1
    mask = m_lo + m_hi - m_lo * m_hi  # any finite side
    lo_c, hi_c, m_eq = _general_bounds(lo, hi, m_lo, m_hi)
    eye = torch.eye(ng, dtype=dt, device=dev)
    if GH is None:
        GH = G @ Hinv
    if GHG is None:
        GHG = GH @ G.mT
    w = _bmv(GH, hmod)  # G H^-1 hmod
    dGHG = torch.diagonal(GHG, dim1=1, dim2=2)
    c_pd = 1.0 / torch.clamp(dGHG, min=1e-12)
    # relative working-set regularization (an absolute shift would bias the
    # active rows' residuals by ~reg / scale(GHG))
    regM = 1e-13 * torch.clamp(dGHG.mean(dim=1), min=1e-300)[:, None, None]

    def working_set_matrix(m_act):
        """The working-set system without (Mres) and with (Mfull) the shift."""
        Mres = m_act[:, :, None] * GHG * m_act[:, None, :] + torch.diag_embed(1.0 - m_act)
        return Mres, Mres + regM * eye

    def polish(m_up, m_dn):
        """Exact working-set solve + per-node KKT guard."""
        m_act = torch.clamp(m_up + m_dn + m_eq, max=1.0)
        d_act = (m_up * hi_c + m_dn * lo_c + m_eq * lo_c) * m_act
        # the factor of the shifted system is only a preconditioner: the
        # refinement targets the unshifted one, or active rows stay regM*mu
        # off their bounds
        Mres, Mfull = working_set_matrix(m_act)
        rhs = m_act * (w - d_act)
        Lm = _cholesky(Mfull.to(fdt))

        def spd_solve(b):
            y = torch.linalg.solve_triangular(Lm, b.to(fdt)[..., None], upper=False)
            return torch.linalg.solve_triangular(Lm.mT, y, upper=True)[..., 0].to(dt)

        mu = spd_solve(rhs)
        for _ in range(n_refine):
            mu = mu + spd_solve(rhs - _bmv(Mres, mu))
        mu = m_act * mu
        z = _bmv(Hinv, hmod - _bmv_t(G, mu))
        t = _bmv(G, z)
        viol = torch.clamp(torch.maximum(t - hi_c, lo_c - t), min=0.0) * mask
        # wrong-sign working-set multipliers are KKT violations too, and
        # active rows must sit on their bounds (two-sided)
        bad_mu = torch.clamp(-mu * m_up, min=0.0) + torch.clamp(mu * m_dn, min=0.0)
        slack = (t - d_act).abs() * m_act * mask
        res_node = torch.maximum(viol.amax(dim=1),
                                 torch.maximum(bad_mu.amax(dim=1), slack.amax(dim=1)))
        # a non-finite factor (a numerically semidefinite working set in the
        # factor dtype) counts as infinitely bad, not as a NaN that would
        # poison the keep-best choice
        res_node = torch.where(torch.isfinite(res_node), res_node, torch.inf)
        return [z, mu, t, m_act, res_node]

    def pdas_from(m_up, m_dn, n_sweeps):
        """Exact working-set solve + PDAS refinement with keep-best."""
        z, mu, t, m_act, res_node = polish(m_up, m_dn)
        best = [z, mu, t, m_act, res_node, m_up, m_dn]
        for _ in range(n_sweeps):
            m_up = ((mu + c_pd * (t - hi_c) > 0) & (m_hi > 0)).to(dt) * (1.0 - m_eq)
            m_dn = ((mu + c_pd * (t - lo_c) < 0) & (m_lo > 0)).to(dt) * (1.0 - m_eq)
            new = polish(m_up, m_dn) + [m_up, m_dn]
            z, mu, t, m_act, res_node = new[:5]
            better = res_node < best[4]
            best = [torch.where(better, n, b) if n.dim() == 1
                    else torch.where(better[:, None], n, b) for n, b in zip(new, best)]
        return best

    def cold_start():
        lm = admm_identify(*_admm_operands(hmod, Hinv, G, lo_c, hi_c, rho_row, L_admm),
                           opts.qpgen_iters)
        return pdas_from(*_admm_working_sets(lm, rho_row, m_lo, m_hi, m_eq), 3)

    if ws is None:
        best = cold_start()
    else:
        # working-set hotstart: PDAS from the previous set; the ADMM
        # identification only if the hotstarted set fails the KKT guard
        best = pdas_from(ws[0].to(dt) * (1.0 - m_eq), ws[1].to(dt) * (1.0 - m_eq), 2)
        if not bool(best[4].max() < 1e-9):
            best = cold_start()
    z, mu, _, m_act, res_node, m_up, m_dn = best

    # ---- phase 3: the elimination matrix on the selected set
    _, Mfull = working_set_matrix(m_act)
    if factor32:
        # f32 inverse + two Newton-Schulz steps X <- X + X(I - M X) in f64;
        # they diverge when kappa(Mfull) ~ 1/eps_f32 (near-dependent active
        # rows), which the z/mu guard cannot see: check the inverse residual
        # and fall back to the f64 inverse above 1e-6
        Minv = _batched_inverse_spd(Mfull.to(torch.float32)).to(dt)
        eyeb = eye.expand_as(Mfull)
        for _ in range(2):
            Minv = Minv + Minv @ (eyeb - Mfull @ Minv)
        Minv = 0.5 * (Minv + Minv.mT)
        ns_res = (eyeb - Mfull @ Minv).abs().max()
        if not bool(torch.isfinite(ns_res) & (ns_res < 1e-6)):
            Minv = _batched_inverse_spd(Mfull)
    else:
        Minv = _batched_inverse_spd(Mfull)
    HG_act = (Hinv @ G.mT) * m_act[:, None, :]
    P = Hinv - HG_act @ Minv @ HG_act.mT
    stat = _bmv(H, z) - hmod + _bmv_t(G, mu)
    res = torch.maximum(res_node.max(), stat.abs().max())
    return z, P, mu, res, (m_up, m_dn)


def _clip_solve(qp: TreeQPIn, qmod, rmod, data, xm, um):
    """The clipping closed form: x = clip(Qinv qmod), u = clip(Rinv rmod),
    with the active-set-masked inverses qtilde/rtilde."""
    xUnc = data["Qinv"] * qmod
    uUnc = data["Rinv"] * rmod
    x = torch.clamp(xUnc, qp.xmin, qp.xmax) * xm
    u = torch.clamp(uUnc, qp.umin, qp.umax) * um
    x_active = (xUnc > qp.xmax) | (xUnc < qp.xmin)
    u_active = (uUnc > qp.umax) | (uUnc < qp.umin)
    return dict(x=x, u=u, xUnc=xUnc, uUnc=uUnc,
                qtilde=torch.where(x_active, 0.0, data["Qinv"]),
                rtilde=torch.where(u_active, 0.0, data["Rinv"]))


def _boxqp_solve(hmod, data, opts: TdunesOpts):
    """General dense stage QPs with bounds as batched projected Newton:
    ``boxqp_iters`` free-set Newton steps with clipping (finitely
    convergent for strictly convex box QPs), then the final active set,
    the signed multipliers and the null-space elimination matrix
    P = Z (Z'HZ)^-1 Z' (QProblem_build_elimination_matrix semantics,
    dual_Newton_tree_qpoases.c:153-214). Returns (z, P, mu, free mask,
    boxqp_res: the max free-gradient residual, the convergence guard)."""
    H, lo, hi = data["H"], data["lo"], data["hi"]
    dt = hmod.dtype
    clip = lambda v: torch.minimum(torch.maximum(v, lo), hi)

    def free_set(z):
        g = _bmv(H, z) - hmod
        at_lo = (z <= lo + 1e-12) & (g > 0)
        at_hi = (z >= hi - 1e-12) & (g < 0)
        fm = (~(at_lo | at_hi)).to(dt)
        return g, fm, _cholesky(H * fm[:, :, None] * fm[:, None, :]
                                + torch.diag_embed(1.0 - fm))

    z = clip(hmod / data["Hd"])
    for _ in range(opts.boxqp_iters):
        g, fm, L = free_set(z)
        d = torch.linalg.solve_triangular(L, (-g * fm)[..., None], upper=False)
        d = torch.linalg.solve_triangular(L.mT, d, upper=True)[..., 0]
        z = clip(z + d)
    g, fm, L = free_set(z)
    Linv = torch.linalg.solve_triangular(
        L, torch.eye(z.shape[1], dtype=dt, device=z.device).expand_as(L), upper=False)
    P = (Linv.mT @ Linv) * fm[:, :, None] * fm[:, None, :]
    return z, P, -g * (1.0 - fm), fm, (g * fm).abs().max()


def _stage_solve(qp: TreeQPIn, lam, data, opts: TdunesOpts, prep: _Prep,
                 extra_q=None, extra_r=None, inner_ws=None):
    """Batched stage-QP solve over all nodes with the stage solver of
    ``opts`` and the ``data`` of ``_stage_data``: clipping
    (dual_Newton_tree_clipping.c:188-227), boxqp, qpgen, mixed (clipping on
    the nodes of ``opts.node_solver`` = 1, qpgen on the rest, their results
    written into the general nodes' rows) or dense (z = P hmod).
    ``inner_ws``: the qpgen working-set hotstart (m_up, m_dn) of the
    qpgen nodes; the solution carries the new set in sol["qpgen_ws"].
    Returns the solution plus what the Hessian build needs (qtilde/rtilde
    for clipping, the per-node elimination matrices P otherwise)."""
    xm, um, _ = _masks(qp, prep)
    qmod, rmod = _modified_gradient(qp, lam, prep, extra_q, extra_r)
    sol = dict(qmod=qmod, rmod=rmod)
    s, nxm = opts.stage_solver, prep.nxm
    nz = nxm + prep.num
    if s == "clipping":
        sol.update(_clip_solve(qp, qmod, rmod, data, xm, um))
        return sol
    hmod = torch.cat([qmod, rmod], dim=1)  # minus sign built in
    if s == "boxqp":
        z, P, mu, fm, sol["boxqp_res"] = _boxqp_solve(hmod, data, opts)
        sol.update(x=z[:, :nxm] * xm, u=z[:, nxm:] * um, P=P, mu=mu, free=fm)
    elif s == "qpgen":
        z, P, mu, res, ws_out = _qpgen_batch(
            hmod, *(data[k] for k in _QPGEN_KEYS), opts, ws=inner_ws, GH=data["GH"],
            GHG=data["GHG"])
        sol.update(x=z[:, :nxm] * xm, u=z[:, nxm:] * um, P=P, mu_x=mu[:, :nxm],
                   mu_u=mu[:, nxm:nz], mu_d=mu[:, nz:], qpgen_res=res, qpgen_ws=ws_out)
    elif s == "mixed":
        # the clipping closed form everywhere, the general nodes overwritten
        c = _clip_solve(qp, qmod, rmod, data, xm, um)
        x, u = c["x"], c["u"]
        P = torch.diag_embed(torch.cat([c["qtilde"] * xm, c["rtilde"] * um], dim=1))
        mu_x = data["Qd"] * (c["xUnc"] - x) * xm
        mu_u = data["Rd"] * (c["uUnc"] - u) * um
        ng = data["G"].shape[1]
        mu_d = torch.zeros((prep.topo.Nn, ng - nz), dtype=qp.dtype, device=qp.device)
        res = torch.zeros((), dtype=qp.dtype, device=qp.device)
        gd = data.get("gen")
        if gd is None:
            sol["qpgen_ws"] = inner_ws if inner_ws is not None else tuple(
                torch.zeros((0, ng), dtype=qp.dtype, device=qp.device) for _ in range(2))
        else:
            gi = gd["idx"]
            z_g, P_g, mu_g, res, sol["qpgen_ws"] = _qpgen_batch(
                hmod[gi], *(gd[k] for k in _QPGEN_KEYS), opts, ws=inner_ws,
                GH=gd["GH"], GHG=gd["GHG"])
            x[gi] = z_g[:, :nxm] * xm[gi]
            u[gi] = z_g[:, nxm:] * um[gi]
            P[gi] = P_g
            mu_x[gi] = mu_g[:, :nxm]
            mu_u[gi] = mu_g[:, nxm:nz]
            mu_d[gi] = mu_g[:, nz:]
        sol.update(x=x, u=u, P=P, mu_x=mu_x, mu_u=mu_u, mu_d=mu_d, qpgen_res=res)
    else:
        z = _bmv(data["P"], hmod)
        sol.update(x=z[:, :nxm] * xm, u=z[:, nxm:] * um)
    return sol


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
    per node -1/2 z'Hz + qmod'x + rmod'u, minus sum_c b_c'lam_c. With
    diagonal Hessians (``opts.h_diag``, set by ``tdunes_solve`` from the
    data) the quadratic form is elementwise."""
    x, u = sol["x"], sol["u"]
    if opts.stage_solver == "clipping":
        tx = x * (sol["qmod"] - 0.5 * data["Qd"] * x) - qp.b * lam
        tu = u * (sol["rmod"] - 0.5 * data["Rd"] * u)
        return torch.sum(tx) + torch.sum(tu)
    z = torch.cat([x, u], dim=1)
    if opts.h_diag and "Hd" in data:
        quad = torch.sum(z * data["Hd"] * z)
    else:
        quad = torch.sum(z * _bmv(data["H"], z))
    lin = torch.sum(sol["qmod"] * x) + torch.sum(sol["rmod"] * u)
    return -0.5 * quad + lin - torch.sum(qp.b * lam)


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


def clipping_applicable_nodes(qp: TreeQPIn, atol: float = 0.0) -> tuple:
    """Per-node clipping applicability (diagonal Q/R, zero S, nc = 0): the
    static node split of ``stage_solver="mixed"``, 1 = clipping, 0 = qpgen.
    Host-side check on concrete data."""
    def off_diag(M):
        return (M - torch.diag_embed(torch.diagonal(M, dim1=1, dim2=2))).abs().amax(dim=(1, 2))
    ok = ((off_diag(qp.Q) <= atol) & (off_diag(qp.R) <= atol)
          & (qp.S.abs().amax(dim=(1, 2)) <= atol)).cpu().numpy()
    return tuple(int(v) for v in ok & (qp.topo.nc_np == 0))


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


def _factor_dtype(opts, dt):
    """The dtype of the dual-Hessian blocks and their factors: f32 with
    ``factor_dtype="float32"``, else the data dtype ``dt``."""
    return torch.float32 if opts.factor_dtype == "float32" else dt


def _build_dual_hessian(qp: TreeQPIn, sol, data, opts: TdunesOpts, prep: _Prep,
                        dtype=torch.float32):
    """The lambda-group blocks W [NpG, G, G] and parent couplings Ut
    [NpG, nxm, G] of M = J P J' (build_dual_problem,
    dual_Newton_tree.c:551-615, with the clipping vtable
    dual_Newton_tree_clipping.c:264-355 or the dense elimination matrices
    P of the other stage solvers, dual_Newton_tree_qpoases.c), built
    directly in ``dtype``, the factor dtype (``_factor_dtype``): they feed
    only the factorization."""
    dt = dtype
    t = prep.on(qp.device)
    NpG, G, nxm, K = prep.NpG, prep.G, prep.nxm, prep.K
    kv = t["kvalid"].to(dt)[:, :, None, None]
    Ak = qp.A.to(dt)[t["kidsP"]] * kv                     # [NpG, K, nxm, nxm]
    Bk = qp.B.to(dt)[t["kidsP"]] * kv                     # [NpG, K, nxm, num]
    if opts.stage_solver != "clipping":
        # W = Cf P_p Cf' + the kids' E P_c E' blocks, Ut = -E P_p Cf'
        Pmat = (sol["P"] if "P" in sol else data["P"]).to(dt)
        Pp = Pmat[t["gnodes"]]                            # the parent's P
        Cf = torch.cat([Ak, Bk], dim=-1).reshape(NpG, G, Pmat.shape[-1])
        W = Cf @ Pp @ Cf.mT
        eye = torch.eye(nxm, dtype=dt, device=qp.device)
        Px = torch.where(t["kvalid"][:, :, None, None],
                         Pmat[:, :nxm, :nxm][t["kidsP"]], eye)  # [NpG, K, nxm, nxm]
        Wv = W.view(NpG, K, nxm, K, nxm)
        for k in range(K):
            Wv[:, k, :, k, :] += Px[:, k]
        return W, -(Pp[:, :nxm, :] @ Cf.mT)
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


def _reg_cholesky(W, opts):
    """Regularized Cholesky of a batch of blocks [..., n, n]
    (treeqp_dpotrf_l_with_reg_opts, dual_Newton_common.c:35-123), the JAX
    package's ``_reg_cholesky``: ``reg_type`` "none" factors W, "always"
    W + reg_value I, and "on_the_fly" escalates the Levenberg-Marquardt
    shift (x1, x1e3, x1e6) on each block that is bad, i.e. whose factor
    failed, is not finite or has a pivot at or below ``reg_tol``. All four
    factorizations of the cascade run batched and the choice is a select
    per block, with no host read. A factorization that fails is NaN (the
    JAX package's convention; ``_cholesky``)."""
    if opts.reg_type == "none":
        return _cholesky(W)
    eye = torch.eye(W.shape[-1], dtype=W.dtype, device=W.device)
    if opts.reg_type == "always":
        return _cholesky(W + opts.reg_value * eye)
    shifts = torch.tensor([0.0, 1.0, 1e3, 1e6], dtype=W.dtype, device=W.device)
    Ls = _cholesky(W + (shifts * opts.reg_value)[(slice(None),) + (None,) * W.dim()] * eye)

    def bad(L):
        piv = torch.diagonal(L, dim1=-2, dim2=-1)
        # NaN-safe: a NaN pivot compares false
        return ~torch.isfinite(L).all(-1).all(-1) | ~(piv > opts.reg_tol).all(-1)

    L = Ls[0]
    for k in range(1, 4):
        L = torch.where(bad(L)[..., None, None], Ls[k], L)
    return L


def _tri_solve(L, b, trans=False):
    """L y = b (or L' y = b) for batched lower-triangular L; b [..., n]."""
    return torch.linalg.solve_triangular(L.mT if trans else L, b[..., None],
                                         upper=trans)[..., 0]


def _plain_tree_factor(W, Ut, opts: TdunesOpts, prep: _Prep):
    """The plain level-synchronous tree Cholesky (dual_Newton_tree.c:668-735,
    the JAX package's ``_tree_chol_factor`` on its plain routes) at the
    blocks' dtype: per backward level, batched over its groups, the
    regularized factor of W, the parent coupling CholUt = Ut L^-T, and the
    Schur update CholUt CholUt' written into the parent group's diagonal
    block at the group's slot (one group per (dad, slot), so an indexed
    write); the root group last. Returns dict(kind="plain", CholW,
    CholUt); the kernel routes' factors carry no ``kind``."""
    nxm, K, NpG = prep.nxm, prep.K, prep.NpG
    W = W.clone()
    Wv = W.view(NpG, K, nxm, K, nxm)
    CholW = torch.zeros_like(W)
    CholUt = torch.zeros_like(Ut)
    for g, dad, slot in prep.levels_on(W.device):
        Lb = _reg_cholesky(W[g], opts)
        CUb = torch.linalg.solve_triangular(Lb.mT, Ut[g], upper=True, left=False)
        Wv[dad, slot, :, slot, :] -= CUb @ CUb.mT
        CholW[g], CholUt[g] = Lb, CUb
    CholW[:1] = _reg_cholesky(W[:1], opts)
    return dict(kind="plain", CholW=CholW, CholUt=CholUt)


def _plain_tree_solve(fact, rg, prep: _Prep):
    """Solve with ``_plain_tree_factor``'s factors at their dtype: the
    backward right-hand-side sweep, the root solve and the forward
    substitution (dual_Newton_tree.c:745-775). Returns dlam [NpG, G]."""
    CholW, CholUt = fact["CholW"], fact["CholUt"]
    nxm, K, NpG = prep.nxm, prep.K, prep.NpG
    rd = rg.to(CholW.dtype).clone()
    ys = torch.zeros_like(rd)
    levels = prep.levels_on(rd.device)
    for g, dad, slot in levels:
        yb = _tri_solve(CholW[g], rd[g])
        rd.view(NpG, K, nxm)[dad, slot] -= _bmv(CholUt[g], yb)
        ys[g] = yb
    dlam = torch.zeros_like(rd)
    dlam[:1] = _tri_solve(CholW[:1], _tri_solve(CholW[:1], rd[:1]), trans=True)
    for g, dad, slot in reversed(levels):
        dp = dlam.view(NpG, K, nxm)[dad, slot]
        dlam[g] = _tri_solve(CholW[g], ys[g] - _bmv_t(CholUt[g], dp), trans=True)
    return dlam


def _tree_kernels(opts) -> bool:
    """The tree Cholesky runs on the CUDA kernels: ``chain_backend="pallas"``,
    f32 factors and a static regularization, the options of the JAX
    package's ``crown_supported`` (the kernels' shape limits are
    ``crown_kernels.crown_supported``'s)."""
    return (opts.chain_backend == "pallas" and opts.factor_dtype == "float32"
            and opts.reg_type in ("always", "none"))


def _tree_chol_factor(W, Ut, opts: TdunesOpts, prep: _Prep):
    """Tree-structured block Cholesky of the equilibrated blocks (backward
    half of calculate_delta_lambda, dual_Newton_tree.c:668-735).

    With the kernels' options (``crown_kernels.crown_supported``) on a
    multistage-shaped tree (``_split_sched``) the chain levels go through
    ``chain_factor`` (blocks [nxm, nxm], the LM shift pre-added), their
    Schur blocks into the crown groups they hang from, and the crown's
    groups alone through ``crown_factor``; on any other tree the whole
    tree goes through ``crown_factor``. The JAX package runs the split's
    crown in XLA and chooses between the paths by a TPU memory estimate;
    here both are the kernels. With other options the plain tree Cholesky
    (``_plain_tree_factor``) at the blocks' dtype. Returns the stored
    factors for ``_tree_chol_solve``."""
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    if not (_tree_kernels(opts) and ckr.crown_supported(prep, opts)):
        return _plain_tree_factor(W, Ut, opts, prep)
    reg = opts.reg_value if opts.reg_type == "always" else 0.0
    W, Ut = W.to(torch.float32).contiguous(), Ut.to(torch.float32).contiguous()
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
    """Solve M dlam = rg with ``_tree_chol_factor``'s factors, at their
    dtype: the plain solve (``_plain_tree_solve``), the crown kernel's
    solve, or on the split path the chain backward sweeps, their
    right-hand-side updates into the crown, the crown solve, and the chain
    forward sweeps from the crown's direction at each chain's edge
    (dual_Newton_tree.c:745-775). Returns dlam [NpG, G] in rg's dtype."""
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    out_dt = rg.dtype
    if fact.get("kind") == "plain":
        return _plain_tree_solve(fact, rg, prep).to(out_dt)
    rd = rg.to(torch.float32).contiguous()
    if "Ls" not in fact:
        return ckr.crown_solve(fact["CholW"], fact["CholUt"], rd, prep).to(out_dt)
    sp = _split_index(prep, _split_sched(prep), rg.device)
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


def _apply_M_nodes(qp: TreeQPIn, sol, data, d_nodes, opts: TdunesOpts, prep: _Prep):
    """Exact dual-Hessian action M d in the data dtype, via the J P J'
    structure: the linearized stage response to a dual perturbation d
    (the clipping inverses, or z = P h with the stage solver's elimination
    matrices), pushed through the linearized dynamics residual. Used for
    iterative refinement of f32-factored Newton directions."""
    xm, um, nrxm = _masks(qp, prep)
    nxm = prep.nxm
    par = prep.on(qp.device)["par"]
    AtBt = torch.cat([torch.einsum("nji,nj->ni", qp.A, d_nodes),
                      torch.einsum("nji,nj->ni", qp.B, d_nodes)], dim=1)
    sums = _kid_sum(AtBt, prep)
    ql = (d_nodes - sums[:, :nxm]) * xm
    rl = -sums[:, nxm:] * um
    if opts.stage_solver == "clipping":
        xl, ul = sol["qtilde"] * ql, sol["rtilde"] * rl
    else:
        zl = _bmv(sol["P"] if "P" in sol else data["P"], torch.cat([ql, rl], dim=1))
        xl, ul = zl[:, :nxm] * xm, zl[:, nxm:] * um
    res = (torch.einsum("nij,nj->ni", qp.A, xl[par])
           + torch.einsum("nij,nj->ni", qp.B, ul[par]) - xl) * nrxm
    return -res


def _newton_direction(W, Ut, rg, opts: TdunesOpts, prep: _Prep, qp, sol, data):
    """Factor + solve (calculate_delta_lambda) with Jacobi equilibration;
    with ``refine_steps`` > 0 and f32 factors, plain or safeguarded
    iterative refinement of the f32-factored direction against the exact
    data-dtype Hessian action (none with factors in the data dtype, as in
    the JAX package)."""
    sW, fact = _newton_factor(W, Ut, opts, prep)
    dlam_g = _newton_solve(sW, fact, rg, prep)
    if opts.refine_steps == 0 or opts.factor_dtype != "float32":
        return dlam_g
    nrxm = _masks(qp, prep)[2]

    def M_g(dg):
        d_nodes = _group_to_nodes_mm(dg, prep, qp.dtype) * nrxm
        return _nodes_to_group_mm(_apply_M_nodes(qp, sol, data, d_nodes, opts, prep), prep)

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
                 opts: TdunesOpts, prep: _Prep, restart: int, inner_ws=None):
    """Armijo backtracking on f = -g (line_search,
    dual_Newton_tree.c:922-1019): accept tau when f(lam + tau d) <= f(lam)
    + gamma tau grad'd + slack |f(lam)|, grad'd = -sum res . dlam, with the
    noise slack 2^-45 (f64) or 2^-18 (f32). With ``ls_batch`` = T > 0 the
    JAX package evaluates tau = beta^k, k = 0..T-1, as one batch and
    backtracks sequentially beyond; ``_armijo`` gives the same steps. The
    restart heuristic takes a full step after ``ls_restart_trigger``
    consecutive maxed-out searches. Every trial stage solve hotstarts the
    qpgen working sets from ``inner_ws``. Returns (new lam, ls iterations,
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
        sol = _stage_solve(qp, lt, data, opts, prep, inner_ws=inner_ws)
        return _dual_value(qp, lt, sol, data, opts), None

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
                    patience: int = 0, ws0=None, data=None, hist=None):
    """One dual-Newton loop at the dtype of ``qp``'s data, counting
    iterations from ``it0``: per iteration the stage solve and the dual
    residual at lam, the termination test, then (unless converged) the
    Hessian blocks, the Newton direction and the line search.
    ``patience > 0`` adds the coarse phase's stall exit: stop once the
    error has not improved by 10% for ``patience`` consecutive iterations.
    With the qpgen and mixed stage solvers the working sets (m_up, m_dn)
    of the general nodes are carried across iterations and into the line
    search's trial solves (the qpOASES hotstart,
    dual_Newton_tree_qpoases.c:312-356), starting from ``ws0`` (default:
    empty sets). ``data``: ``_stage_data`` of ``qp``, if the caller has
    it. ``hist``: (err_hist, ls_hist) tensors of length ``max_iter`` into
    which each pass records its error and line-search count at the index of
    its iteration (``record_history``). Returns (lam, it, err, status,
    ls_it, ws); err is a 0-dim tensor, ws None for the other stage
    solvers."""
    prep = _get_prep(qp.topo)
    dt = qp.dtype
    nrxm = _masks(qp, prep)[2]
    if data is None:
        data = _stage_data(qp, opts, prep)
    ws = None
    if opts.stage_solver in ("qpgen", "mixed"):
        ws = ws0
        if ws is None:
            n_ws = len(data["gen"]["idx"]) if "gen" in data else (
                0 if opts.stage_solver == "mixed" else prep.topo.Nn)
            ws = tuple(torch.zeros((n_ws, data["G"].shape[1]), dtype=dt, device=qp.device)
                       for _ in range(2))
    lam, it, status, restart, ls_it = lam0, it0, TDUNES_OPTIMAL, 0, 0
    err = best = torch.full((), math.inf, dtype=dt, device=qp.device)
    noimp = 0
    while (bool(err >= opts.tol) and status == TDUNES_OPTIMAL
           and it < opts.max_iter and (patience <= 0 or noimp < patience)):
        sol = _stage_solve(qp, lam, data, opts, prep, inner_ws=ws)
        ws = sol.get("qpgen_ws", ws)
        res = _dual_residual(qp, sol, prep)
        err = _residual_error(res, opts)
        noimp = 0 if bool(err < 0.9 * best) else noimp + 1
        best = torch.minimum(best, err)
        if bool(err < opts.tol):
            if hist is not None:
                hist[0][it], hist[1][it] = err, ls_it
            break
        W, Ut = _build_dual_hessian(qp, sol, data, opts, prep, _factor_dtype(opts, dt))
        rg = _nodes_to_group_mm(res, prep)
        dlam_g = _newton_direction(W, Ut, rg, opts, prep, qp, sol, data)
        dlam_nodes = _group_to_nodes_mm(dlam_g, prep, dt) * nrxm
        lam_new, ls_it, descent_ok, restart = _line_search(
            qp, lam, dlam_nodes, sol, dlam_g, rg, data, opts, prep, restart, inner_ws=ws)
        if descent_ok:
            lam = lam_new
        else:
            status = TDUNES_NOT_DESCENT
        if hist is not None:
            hist[0][it], hist[1][it] = err, ls_it
        it += 1
    return lam, it, err, status, ls_it, ws


def _check_generic(qp: TreeQPIn, opts: TdunesOpts):
    """Raise on options ``tdunes_solve`` does not take: an unknown or
    inapplicable stage solver, and on the kernel route a tree outside the
    kernels' shapes. ``axis_name`` is not read (the JAX package's
    ``tdunes_solve`` does not read it either)."""
    if opts.stage_solver not in STAGE_SOLVERS:
        raise ValueError(f"stage_solver={opts.stage_solver!r} (one of {STAGE_SOLVERS})")
    if opts.stage_solver == "clipping" and not clipping_applicable(qp):
        raise ValueError(
            "clipping stage solver not applicable (needs diagonal Q/R, zero "
            "S, nc=0) (cf. stage_qp_clipping_is_applicable)")
    later = "is not ported yet (ROADMAP.md, port queue)"
    prep = _get_prep(qp.topo)
    if _tree_kernels(opts) and not (0 < prep.NpG and prep.G <= 64 and prep.nxm <= 16):
        raise NotImplementedError(
            f"the tree-Cholesky kernels on a tree with {prep.NpG} lambda-groups "
            f"of dim {prep.G} {later}")


def tdunes_solve(qp: TreeQPIn, lam0=None, opts: TdunesOpts = TdunesOpts(),
                 stage_ws=None) -> TreeQPOut:
    """Solve a tree QP with dual Newton on the tree formulation
    (``treeqp_tdunes_solve``, dual_Newton_tree.c:1104-1263), on any tree
    topology, on the device of ``qp``'s tensors.

    ``lam0`` [Nn, nxm] warm-starts the duals (zeros when None). Every
    option of ``TdunesOpts`` (``axis_name`` is not read): every stage solver
    (clipping, dense, boxqp, qpgen, mixed), the factors in f32 or in the
    data dtype, the tree Cholesky on the kernels (``chain_backend="pallas"``,
    f32 factors, ``reg_type`` "always" or "none") or plain (any other
    options, ``reg_type="on_the_fly"`` among them), one- and two-phase
    (``f32_phase_tol > 0`` with f64 data and f32 factors: a coarse phase
    with everything in f32 down to f32_phase_tol or a stall of
    ``f32_patience`` iterations, then the data-dtype phase with
    refinement), plain or safeguarded refinement (f32 factors only),
    sequential or batched Armijo, all three terminations.

    ``stage_ws``: the qpgen working sets of a previous solve
    (``info["qpgen_ws"]``), the qpOASES hotstart across MPC steps
    (dual_Newton_tree_qpoases.c:335-342). As in the JAX package, the
    coarse phase starts from empty sets and hands its own to the
    data-dtype phase, so ``stage_ws`` reaches the one-phase solve only.
    With stage solver mixed, ``opts.node_solver`` is derived from the data
    when None, and ``h_diag`` is set when the Hessians are diagonal.

    ``info["iter_f32"]`` counts the coarse iterations, ``info["iter"]``
    both phases; qpgen and mixed add ``qpgen_res`` (the general stage QPs'
    KKT guard at the solution) and ``qpgen_ws`` (their final working
    sets), boxqp adds ``boxqp_res``. With ``record_history`` the data-dtype
    phase records each iteration's error and line-search count in
    ``info["err_hist"]`` / ``info["ls_hist"]`` (tensors of length
    ``max_iter`` at the index of the iteration, NaN / -1 elsewhere; the
    coarse phase records nothing).
    """
    s = opts.stage_solver
    if s == "mixed" and opts.node_solver is None:
        opts = dataclasses.replace(opts, node_solver=clipping_applicable_nodes(qp))
    if s != "clipping" and not opts.h_diag and diag_weights_applicable(qp):
        opts = dataclasses.replace(opts, h_diag=True)
    _check_generic(qp, opts)
    topo = qp.topo
    prep = _get_prep(topo)
    dt = qp.dtype
    xm, um, nrxm = _masks(qp, prep)
    if lam0 is None:
        lam0 = torch.zeros((topo.Nn, topo.nxm), dtype=dt, device=qp.device)
    lam0 = lam0 * nrxm
    ws_in = None if stage_ws is None else tuple(w.to(dt) for w in stage_ws)

    it0 = 0
    if opts.f32_phase_tol > 0 and dt == torch.float64 and opts.factor_dtype == "float32":
        f32 = torch.float32
        optsA = dataclasses.replace(opts, refine_steps=0,
                                    tol=max(opts.f32_phase_tol, opts.tol),
                                    record_history=False)
        lamA, it0, _, _, _, wsA = _td_newton_loop(qp.to(dtype=f32), lam0.to(f32), optsA, 0,
                                                  patience=opts.f32_patience)
        # the coarse phase's status is dropped: a not-descent there is
        # expected noise near the f32 residual floor, not a failure
        lam0 = lamA.to(dt) * nrxm
        if wsA is not None:
            ws_in = tuple(w.to(dt) for w in wsA)

    data = _stage_data(qp, opts, prep)
    hist = None
    if opts.record_history:
        hist = (torch.full((opts.max_iter,), math.nan, dtype=dt, device=qp.device),
                torch.full((opts.max_iter,), -1, dtype=torch.int32, device=qp.device))
    lam, it, _, status, ls_it, ws_f = _td_newton_loop(qp, lam0, opts, it0, ws0=ws_in,
                                                      data=data, hist=hist)
    # final stage solve + multiplier recovery (dual_Newton_tree.c:1235-1247)
    sol = _stage_solve(qp, lam, data, opts, prep, inner_ws=ws_f)
    err = float(_residual_error(_dual_residual(qp, sol, prep), opts))
    if status == TDUNES_OPTIMAL and err >= opts.tol:
        status = TDUNES_MAX_ITER
    info = dict(iter=it, status=status, error=err, ls_iter=ls_it, iter_f32=it0)
    if hist is not None:
        info["err_hist"], info["ls_hist"] = hist
    mu_d = torch.zeros((topo.Nn, topo.ncm), dtype=dt, device=qp.device)
    if s == "clipping":
        # mu = Q .* (xUnc - x) (stage_qp_clipping_export_mu)
        mu_x = data["Qd"] * (sol["xUnc"] - sol["x"]) * xm
        mu_u = data["Rd"] * (sol["uUnc"] - sol["u"]) * um
    elif s == "boxqp":
        mu_x, mu_u = sol["mu"][:, :topo.nxm] * xm, sol["mu"][:, topo.nxm:] * um
        info["boxqp_res"] = float(sol["boxqp_res"])
    elif s in ("qpgen", "mixed"):
        mu_x, mu_u = sol["mu_x"] * xm, sol["mu_u"] * um
        mu_d = sol["mu_d"][:, :topo.ncm] * torch.as_tensor(topo.c_mask, dtype=dt,
                                                           device=qp.device)
        info["qpgen_res"] = float(sol["qpgen_res"])
        info["qpgen_ws"] = sol["qpgen_ws"]
    else:
        mu_x, mu_u = torch.zeros_like(sol["x"]), torch.zeros_like(sol["u"])
    return TreeQPOut(x=sol["x"], u=sol["u"], lam=lam * nrxm, mu_x=mu_x, mu_u=mu_u,
                     mu_d=mu_d, info=info)

"""tdunes — dual Newton on the tree formulation: the pieces the multistage
solver calls.

Port of the parts of ``treeqp_tpu/solvers/tdunes.py`` that
``tdunes_multistage`` reaches with the clipping stage solver: the options,
the status codes, the static topology prep, the clipping stage solve, the
dual residual and dual value, and the node <-> lambda-group layout
converters. The generic-tree solver ``tdunes_solve`` and the other stage
solvers are not ported yet.

Algorithm (reference ``treeqp/src/dual_Newton_tree.{h,c}``): dualize all
parent->child dynamics constraints with multipliers lambda_c (one per
non-root node); each node becomes an independent small QP parametric in
lambda, solved in closed form by clipping for diagonal Q/R
(dual_Newton_tree_clipping.c); a non-smooth Newton method runs on the
concave dual.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TreeQPIn
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["TdunesOpts", "TDUNES_OPTIMAL", "TDUNES_MAX_ITER",
           "TDUNES_NOT_DESCENT"]

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
    subset ``tdunes_multistage.tdunes_ms_solve`` documents and raises
    ``NotImplementedError`` on the rest."""

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
        stages = topo.groups_by_stage
        self.levels = [np.asarray(stages[s], np.int32)
                       for s in range(len(stages) - 1, 0, -1)
                       if len(stages[s]) > 0]
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

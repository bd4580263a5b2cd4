"""Tree-structured primal-dual interior-point method (the HPIPM capability
class).

Port of ``treeqp_tpu/solvers/ipm.py``:

* Mehrotra predictor-corrector on the full tree QP with box and general
  constraints t = G z in [lo, hi], G = [I 0; 0 I; C D] (two-sided, the
  signed fold mu = lam_ub - lam_lb on export, hpmpc_tree.c:405-433);
* each iteration solves its KKT systems with a tree Riccati recursion: a
  backward sweep over the tree's stages, deepest first, factorizing all
  nodes of a stage as one batch, then two right-hand-side solves (affine
  and centering-corrector) with the same factors;
* termination on the four residual max-norms res_g / res_b / res_d / res_m
  (hpipm_tree.c:102-105); infinite bounds (|bound| >= 0.5e12) are masked
  out, their slacks and duals pinned at (1, 0).

With ``factor_dtype="float32"`` on f64 data the solve runs two phases: f32
Riccati factors and solves while max(res4) >= max(tol, f32_until), then
f64 ones (the residuals and steps are always computed in the data dtype,
so an f32 direction only perturbs the path). On diagonal box-only trees
with ``chain_backend="pallas"`` the f32 phase runs the whole tree's
recursion as ONE launch each of the CUDA kernels ``crown_ric_factor`` and
``crown_ric_solve`` (``ops/crown_riccati.py``), at any node count and
depth. The JAX package gates that path on ``topo.ncm == 0``, which its
padded ``ncm`` (>= 1) never meets, so it never takes it; the port takes
the path the JAX docstring describes (``clipping_applicable``). Elsewhere
the plain recursion below runs (``_riccati_factor`` / ``_riccati_solve``,
in f32 or f64, as XLA runs it in JAX).

JAX's ``lax.while_loop`` is a Python loop here with one host read per
iteration (the termination test, the step-failure flag, the barrier for
the stall counter); the best iterate is kept on the host's side of that
read. As in the JAX package, ``ipm_solve`` does not read ``axis_name``:
the multi-device IPM is ``ipm_multistage.ipm_ms_solve``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TREEQP_INF, TreeQPIn, TreeQPOut
from treeqp_tpu_torch.ops import crown_riccati as crk
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["IpmOpts", "ipm_solve", "IPM_OPTIMAL", "IPM_MAX_ITER", "IPM_MIN_STEP"]

IPM_OPTIMAL = 0
IPM_MAX_ITER = 1
IPM_MIN_STEP = 2

_INF_THRESH = 0.5 * TREEQP_INF


@dataclasses.dataclass(frozen=True)
class IpmOpts:
    """Options: the same fields and defaults as
    ``treeqp_tpu.solvers.ipm.IpmOpts`` (cf. treeqp_hpipm_opts_t,
    hpipm_tree.c:82-106), so that one dict builds both; the JAX docstring
    describes each field. ``axis_name`` names the scenario axis of a
    sharded ``ipm_ms_solve`` (``parallel.sharding``)."""

    max_iter: int = 30
    tol: float = 1e-10  # applied to all four residuals (res_g/b/d/m)
    mu0: float = 1e2  # initial slack/dual magnitude
    alpha_min: float = 1e-8  # minimum step -> IPM_MIN_STEP
    tau_frac: float = 0.995  # fraction-to-boundary
    tau_frac_general: float = 0.95  # ... with general C/D rows
    reg_eps: float = 0.0  # static regularization of the Muu diagonals
    ws_eps: float = 1e-3  # slack/dual floor of a warm start
    factor_dtype: str = "same"  # same | float32
    f32_until: float = 1e-5  # residual switch point of the f32 phase
    chain_backend: str = "xla"  # xla | pallas (the CUDA Riccati kernels)
    refine_steps: int = 0  # refinement of each solve against the exact KKT
    stall_patience: int = 4  # stall exit to the best iterate (0: off)
    record_history: bool = False  # info["hist"]: [max_iter, 7] per iteration
    axis_name: str | None = None


def _check_opts(opts: IpmOpts):
    if opts.factor_dtype not in ("same", "float32"):
        raise ValueError(f"factor_dtype={opts.factor_dtype!r}")
    if opts.chain_backend not in ("xla", "pallas"):
        raise ValueError(f"chain_backend={opts.chain_backend!r}")


class _IpmPrep:
    """Static per-topology schedule: the nodes of each stage, deepest stage
    first, the root last (``levels``; the JAX prep's padded per-depth
    batches without their padding). The recursions' index lists are
    ``ops.crown_riccati._get_sched`` of this prep."""

    def __init__(self, topo: TreeStructure):
        self.topo = topo
        self.levels = [np.nonzero(topo.stage == s)[0] for s in range(topo.Nh, -1, -1)]

    def par_on(self, device) -> torch.Tensor:
        """Each node's parent (0 at the root) as a long tensor."""
        return crk._get_sched(self).on(device)["par"].long()


_PREP_CACHE: dict = {}


def _get_ipm_prep(topo: TreeStructure) -> _IpmPrep:
    if topo not in _PREP_CACHE:
        _PREP_CACHE[topo] = _IpmPrep(topo)
    return _PREP_CACHE[topo]


def _kid_sum(v, topo: TreeStructure):
    """out[p] = sum over the kids of p of v[kid] ([Nn, m]), slot by slot in
    the order of a sequential segment sum (deterministic on the card)."""
    from treeqp_tpu_torch.solvers import tdunes as td
    return td._kid_sum(v, td._get_prep(topo))


def _constraint_data(qp: TreeQPIn):
    """Stack bounds + general constraints: t = G z in [lo, hi], with
    finite-side masks. G rows: [I 0; 0 I; C D] (ng = nxm + num + ncm), the
    identity rows and the C/D rows masked to each node's real dims.
    Returns (G [Nn, ng, nz], lo, hi, m_lo, m_hi [Nn, ng])."""
    topo = qp.topo
    kw = dict(dtype=qp.dtype, device=qp.device)
    Nn, nxm, num, ncm = topo.Nn, topo.nxm, topo.num, topo.ncm
    xm = torch.as_tensor(topo.x_mask, **kw)
    um = torch.as_tensor(topo.u_mask, **kw)
    cm = torch.as_tensor(topo.c_mask, **kw)
    nz = nxm + num
    G = torch.zeros((Nn, nxm + num + ncm, nz), **kw)
    G[:, :nxm, :nxm] = torch.diag_embed(xm)
    G[:, nxm:nz, nxm:] = torch.diag_embed(um)
    G[:, nz:, :nxm] = qp.C * cm[:, :, None]
    G[:, nz:, nxm:] = qp.D * cm[:, :, None]
    lo = torch.cat([qp.xmin, qp.umin, qp.dmin], dim=1)
    hi = torch.cat([qp.xmax, qp.umax, qp.dmax], dim=1)
    rmask = torch.cat([xm, um, cm], dim=1)
    m_lo = (lo > -_INF_THRESH) & (rmask > 0)
    m_hi = (hi < _INF_THRESH) & (rmask > 0)
    return G, lo, hi, m_lo.to(qp.dtype), m_hi.to(qp.dtype)


def _stage_hessian(qp: TreeQPIn):
    """H = [[Q S'],[S R]] per node, identity on padded dims; and the
    [x; u] mask."""
    topo = qp.topo
    kw = dict(dtype=qp.dtype, device=qp.device)
    xm = torch.as_tensor(topo.x_mask, **kw)
    um = torch.as_tensor(topo.u_mask, **kw)
    Sm = qp.S * um[:, :, None] * xm[:, None, :]
    H = torch.cat([torch.cat([qp.Q * xm[:, :, None] * xm[:, None, :], Sm.mT], dim=2),
                   torch.cat([Sm, qp.R * um[:, :, None] * um[:, None, :]], dim=2)], dim=1)
    zmask = torch.cat([xm, um], dim=1)
    return H + torch.diag_embed(1.0 - zmask), zmask


def _cholesky(M):
    """Lower Cholesky factors, NaN where a factorization fails (XLA's
    convention, which the NaN guard of the IPM reads)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info[..., None, None] > 0, torch.nan, L)


def _chol_solve(L, B):
    """(L L')^-1 B for a batch; L lower [..., n, n], B [..., n, m]."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _bmv(M, v):
    return (M @ v[..., None])[..., 0]


def _riccati_factor(qp: TreeQPIn, Hbar, prep: _IpmPrep, opts: IpmOpts,
                    fdt=None, Wsum0=None):
    """Backward stage sweep, deepest stage first: per node M = Hbar +
    (sum of its kids' [A B]' P [A B]), Luu = chol(Muu + reg_eps I),
    K = -Muu^-1 Mux, P = sym(Mxx + Mxu K). ``fdt`` (e.g. torch.float32)
    runs it in that dtype; ``Wsum0`` [Nn, nz, nz] seeds the kids' sums (the
    chains' terms when the tree is the crown of a multistage tree). The
    kids' terms are summed in kid order and then added to their parent.
    Returns dict(P, Luu, K, Mxu, AB)."""
    topo = qp.topo
    if fdt is not None:
        Hbar = Hbar.to(fdt)
    dt = Hbar.dtype
    kw = dict(dtype=dt, device=Hbar.device)
    Nn, nxm, num = topo.Nn, topo.nxm, topo.num
    nz = nxm + num
    AB = torch.cat([qp.A, qp.B], dim=2).to(dt)
    P = torch.zeros((Nn, nxm, nxm), **kw)
    Luu = torch.zeros((Nn, num, num), **kw)
    K = torch.zeros((Nn, num, nxm), **kw)
    Mxu = torch.zeros((Nn, nxm, num), **kw)
    Wsum = torch.zeros((Nn, nz, nz), **kw) if Wsum0 is None else Wsum0.to(dt).clone()
    Wc = torch.zeros((Nn, nz, nz), **kw)
    reg = opts.reg_eps * torch.eye(num, **kw)
    for nodes, pars, kk in crk._get_sched(prep).levels(Hbar.device):
        M = Hbar[nodes] + Wsum[nodes]
        Lb = _cholesky(M[:, nxm:, nxm:] + reg)
        Kb = -_chol_solve(Lb, M[:, nxm:, :nxm])
        Pb = M[:, :nxm, :nxm] + M[:, :nxm, nxm:] @ Kb
        Pb = 0.5 * (Pb + Pb.mT)
        P[nodes], Luu[nodes], K[nodes], Mxu[nodes] = Pb, Lb, Kb, M[:, :nxm, nxm:]
        ABc = AB[nodes]
        Wc[nodes] = ABc.mT @ Pb @ ABc
        if len(pars):
            Wsum[pars] = Wsum[pars] + crk._kid_sum(Wc, pars, kk)
    return dict(P=P, Luu=Luu, K=K, Mxu=Mxu, AB=AB)


def _riccati_solve(qp: TreeQPIn, fact, rg, rb, prep: _IpmPrep, wsum0=None):
    """Two-sweep solve with stored factors, in the factors' dtype (the
    right-hand side cast in, the solution cast back out).

    rg [Nn, nz] the stationarity rhs, rb [Nn, nxm] the dynamics residual of
    the edge into each node; ``wsum0`` [Nn, nz] seeds the kids' sums.
    Returns (dz [Nn, nz], dlam [Nn, nxm]) solving Hbar dz + rg + edge-duals
    = 0, dx_c = A dx_p + B du_p + rb_c."""
    topo = qp.topo
    out_dt = rg.dtype
    P, Luu, K, Mxu, AB = (fact[k] for k in ("P", "Luu", "K", "Mxu", "AB"))
    dt = P.dtype
    kw = dict(dtype=dt, device=P.device)
    rg, rb = rg.to(dt), rb.to(dt)
    Nn, nxm, num = topo.Nn, topo.nxm, topo.num
    nz = nxm + num
    p = torch.zeros((Nn, nxm), **kw)
    k = torch.zeros((Nn, num), **kw)
    wsum = torch.zeros((Nn, nz), **kw) if wsum0 is None else wsum0.to(dt).clone()
    wc = torch.zeros((Nn, nz), **kw)
    levels = crk._get_sched(prep).levels(P.device)
    for nodes, pars, kk in levels:
        m = rg[nodes] + wsum[nodes]
        kb = -_chol_solve(Luu[nodes], m[:, nxm:, None])[..., 0]
        pb = m[:, :nxm] + torch.einsum("bxu,bu->bx", Mxu[nodes], kb)
        p[nodes], k[nodes] = pb, kb
        v = torch.einsum("bxy,by->bx", P[nodes], rb[nodes]) + pb
        wc[nodes] = torch.einsum("bxz,bx->bz", AB[nodes], v)
        if len(pars):
            wsum[pars] = wsum[pars] + crk._kid_sum(wc, pars, kk)
    # the root: P_0 dx0 = -p_0 (free or eliminated root state)
    dx0 = -_chol_solve(_cholesky(P[:1]), p[:1, :, None])[..., 0]
    dz = torch.zeros((Nn, nz), **kw)
    dlam = torch.zeros((Nn, nxm), **kw)
    dz[:1] = torch.cat([dx0, torch.einsum("bux,bx->bu", K[:1], dx0) + k[:1]], dim=1)
    dlam[:1] = torch.einsum("bxy,by->bx", P[:1], dx0) + p[:1]
    par = prep.par_on(P.device)
    for nodes, _, _ in levels[-2::-1]:
        x = torch.einsum("bxz,bz->bx", AB[nodes], dz[par[nodes]]) + rb[nodes]
        dz[nodes] = torch.cat([x, torch.einsum("bux,bx->bu", K[nodes], x) + k[nodes]], dim=1)
        dlam[nodes] = torch.einsum("bxy,by->bx", P[nodes], x) + p[nodes]
    return dz.to(out_dt), dlam.to(out_dt)


def _kkt_apply(qp: TreeQPIn, Hbar, dz, dlam, prep: _IpmPrep, nrxm, zmask):
    """Exact data-dtype action of the equality-constrained KKT operator the
    Riccati recursion solves:
        L1(dz, dlam) = Hbar dz - E'dlam + sum_kids [A B]' dlam_kid
        L2(dz)       = dx - (A dx_p + B du_p)
    (``_riccati_solve`` returns L1 = -rg, L2 = rb); for the refinement of
    f32-factored solves."""
    nxm = qp.topo.nxm
    AB = torch.cat([qp.A, qp.B], dim=2)
    par = prep.par_on(dz.device)
    dln = dlam * nrxm
    r1 = _bmv(Hbar, dz)
    r1 = torch.cat([r1[:, :nxm] - dln, r1[:, nxm:]], dim=1)
    r1 = (r1 + _kid_sum(_bmv(AB.mT, dln), qp.topo)) * zmask
    r2 = (dz[:, :nxm] - _bmv(AB, dz[par])) * nrxm
    return r1, r2


def _max_step(v, dv, mask, frac=1.0):
    """Largest alpha in (0, 1] with v + alpha frac dv >= 0 on the masked
    entries; 1 when no constraint blocks (NaN propagates)."""
    neg = (dv < 0) & (mask > 0)
    ratio = torch.where(neg, -v / torch.where(dv < 0, dv, -1.0), torch.inf)
    return torch.minimum(torch.ones((), dtype=v.dtype, device=v.device),
                         frac * ratio.min())


def _ipm_loop(iteration, st0, opts: IpmOpts, dt, device):
    """The phases of the Mehrotra loop around ``iteration(st, fdt) ->
    (st2, res4, flags, hist_row)``, ``flags`` = [max(res4), failed step
    (alpha < alpha_min or a NaN direction), barrier mu after the step]:
    with ``factor_dtype="float32"`` on f64 data an f32-factored phase while
    max(res4) >= max(tol, f32_until) (its MIN_STEP / stall is handed over
    as OPTIMAL with the stall counter reset), then the data-dtype phase to
    ``tol``; the stall exit; the best iterate seen; the status rules.
    Returns (st, it, it_f32, status, res4, hist)."""
    inf4 = torch.full((4,), torch.inf, dtype=dt, device=device)
    hist = (torch.full((opts.max_iter, 7), torch.nan, dtype=dt, device=device)
            if opts.record_history else None)
    c = dict(st=st0, it=0, status=IPM_OPTIMAL, res4=inf4, m4=float("inf"),
             bst=st0, best4=inf4, best_m4=float("inf"), noimp=0)

    def run(fdt, stop):
        while (c["m4"] >= stop and c["status"] == IPM_OPTIMAL and c["it"] < opts.max_iter
               and (opts.stall_patience <= 0 or c["noimp"] < opts.stall_patience)):
            st2, res4, flags, row = iteration(c["st"], fdt)
            m4, failed, mu2 = flags.tolist()  # the iteration's one host read
            if hist is not None:
                hist[c["it"]] = row
            if failed:
                c["status"] = IPM_MIN_STEP
            best = c["best_m4"]
            c["noimp"] = 0 if m4 < 0.9 * best else (c["noimp"] + 1 if mu2 < opts.tol else 0)
            if m4 < best:
                c.update(bst=st2, best4=res4, best_m4=m4)
            c.update(st=st2, res4=res4, m4=m4, it=c["it"] + 1)

    it_f32 = 0
    if opts.factor_dtype == "float32" and dt == torch.float64:
        run(torch.float32, max(opts.tol, opts.f32_until))
        it_f32 = c["it"]
        c.update(status=IPM_OPTIMAL, noimp=0)
    run(None, opts.tol)
    st, res4, m4, status = c["st"], c["res4"], c["m4"], c["status"]
    if c["best_m4"] < m4:  # export the best iterate seen
        st, res4, m4 = c["bst"], c["best4"], c["best_m4"]
    if status == IPM_OPTIMAL and not m4 < opts.tol:  # NaN-safe
        status = IPM_MAX_ITER
    if status == IPM_MIN_STEP and m4 < opts.tol:
        status = IPM_OPTIMAL
    return st, c["it"], it_f32, status, res4, hist


def ipm_solve(qp: TreeQPIn, opts: IpmOpts = IpmOpts(), ws=None) -> TreeQPOut:
    """Solve the tree QP with a Mehrotra predictor-corrector IPM
    (capability of ``treeqp_hpipm_solve``, hpipm_tree.c:307-562).

    ``ws``: optional warm start from a previous solution (a TreeQPOut or
    any object with x/u/lam/mu_x/mu_u/mu_d): slacks start at the constraint
    distances and duals at the signed-fold multipliers, floored at
    ``opts.ws_eps``. Returns a TreeQPOut with info = dict(iter, iter_f32
    (the f32-factored phase's share), status, res4 (tensor [4]) and, with
    ``record_history``, hist [max_iter, 7]: res4, alpha, mu, sigma)."""
    _check_opts(opts)
    from treeqp_tpu_torch.solvers.tdunes import clipping_applicable
    diag_box = opts.chain_backend == "pallas" and clipping_applicable(qp)
    topo = qp.topo
    prep = _get_ipm_prep(topo)
    dt, dev = qp.dtype, qp.device
    has_general = max(topo.nc) > 0
    Nn, nxm, num = topo.Nn, topo.nxm, topo.num
    nz = nxm + num
    f32 = torch.float32

    H, zmask = _stage_hessian(qp)
    G, lo, hi, m_lo, m_hi = _constraint_data(qp)
    h = torch.cat([qp.q, qp.r], dim=1) * zmask
    nrxm = torch.as_tensor(topo.nonroot_x_mask, dtype=dt, device=dev)
    par = prep.par_on(dev)
    n_ineq = torch.clamp(m_lo.sum() + m_hi.sum(), min=1.0)
    AB = torch.cat([qp.A, qp.B], dim=2)
    if diag_box:
        AB32 = AB.to(f32).contiguous()
        Wz32 = torch.zeros((Nn, nz, nz), dtype=f32, device=dev)
        wz32 = torch.zeros((Nn, nz), dtype=f32, device=dev)
        Hd = torch.diagonal(H, dim1=1, dim2=2)

    def residuals(z, lam, l_lo, l_hi, s_lo, s_hi):
        """HPIPM-style res_g / res_b / res_d / res_m."""
        t = _bmv(G, z)
        lamn = lam * nrxm
        rg = _bmv(H, z) * zmask + h + _bmv(G.mT, l_hi - l_lo)
        rg = torch.cat([rg[:, :nxm] - lamn, rg[:, nxm:]], dim=1)
        rg = (rg + _kid_sum(_bmv(AB.mT, lamn), topo)) * zmask
        rb = (_bmv(AB, z[par]) + qp.b - z[:, :nxm]) * nrxm
        rd_lo = (s_lo - (t - lo)) * m_lo
        rd_hi = (s_hi - (hi - t)) * m_hi
        return rg, rb, rd_lo, rd_hi, s_lo * l_lo * m_lo, s_hi * l_hi * m_hi

    def inv_slacks(s_lo, s_hi):
        return (torch.where(m_lo > 0, 1.0 / s_lo, 0.0),
                torch.where(m_hi > 0, 1.0 / s_hi, 0.0))

    def kkt_rhs(rg, rd_lo, rd_hi, rm_lo, rm_hi, s_lo, s_hi, l_lo, l_hi):
        """Eliminate (ds, dl): the condensed (rhs_g, Gamma) for the
        Riccati, (H + G'Gamma G) dz + dual terms + rhs_g = 0."""
        inv_slo, inv_shi = inv_slacks(s_lo, s_hi)
        gamma = l_lo * inv_slo + l_hi * inv_shi
        qx = (rm_lo - l_lo * rd_lo) * inv_slo - (rm_hi - l_hi * rd_hi) * inv_shi
        return rg + _bmv(G.mT, qx), gamma

    def expand_step(dz, rd_lo, rd_hi, rm_lo, rm_hi, s_lo, s_hi, l_lo, l_hi):
        dt_ = _bmv(G, dz)
        ds_lo = (dt_ - rd_lo) * m_lo
        ds_hi = (-dt_ - rd_hi) * m_hi
        inv_slo, inv_shi = inv_slacks(s_lo, s_hi)
        dl_lo = (-(rm_lo + l_lo * ds_lo) * inv_slo) * m_lo
        dl_hi = (-(rm_hi + l_hi * ds_hi) * inv_shi) * m_hi
        return ds_lo, ds_hi, dl_lo, dl_hi

    if ws is None:
        # cold start: slacks at least the distance to the bound at z = 0,
        # duals mu0 / s
        z0 = torch.zeros((Nn, nz), dtype=dt, device=dev)
        lam0 = torch.zeros((Nn, nxm), dtype=dt, device=dev)
        s_init = float(np.sqrt(opts.mu0))
        s_lo0 = torch.where(m_lo > 0, torch.clamp(-lo, min=s_init), 1.0)
        s_hi0 = torch.where(m_hi > 0, torch.clamp(hi, min=s_init), 1.0)
        l_lo0 = torch.where(m_lo > 0, opts.mu0 / s_lo0, 0.0)
        l_hi0 = torch.where(m_hi > 0, opts.mu0 / s_hi0, 0.0)
    else:
        eps = opts.ws_eps
        z0 = torch.cat([ws.x, ws.u], dim=1).to(dt) * zmask
        lam0 = ws.lam.to(dt) * nrxm
        t0 = _bmv(G, z0)
        s_lo0 = torch.where(m_lo > 0, torch.clamp(t0 - lo, min=eps), 1.0)
        s_hi0 = torch.where(m_hi > 0, torch.clamp(hi - t0, min=eps), 1.0)
        mu_fold = torch.cat([ws.mu_x, ws.mu_u, ws.mu_d], dim=1).to(dt)
        l_lo0 = torch.where(m_lo > 0, torch.clamp(-mu_fold, min=eps), 0.0)
        l_hi0 = torch.where(m_hi > 0, torch.clamp(mu_fold, min=eps), 0.0)
    tf = opts.tau_frac_general if has_general else opts.tau_frac

    def iteration(st, fdt):
        z, lam, l_lo, l_hi, s_lo, s_hi = st
        rg, rb, rd_lo, rd_hi, rm_lo, rm_hi = residuals(*st)
        rhs_g_aff, gamma = kkt_rhs(rg, rd_lo, rd_hi, rm_lo, rm_hi, s_lo, s_hi, l_lo, l_hi)
        Hbar = H + torch.einsum("ngi,ng,ngj->nij", G, gamma, G)
        if diag_box and fdt == f32:
            # G = [I; I]: the barrier keeps the Hessian diagonal; the whole
            # tree's recursion in one launch each
            hbar_d = (Hd + gamma[:, :nz]).to(f32).contiguous()
            fact = crk.crown_ric_factor(hbar_d, AB32, Wz32, prep, nxm, reg=opts.reg_eps)

            def one_solve(rg_, rb_):
                dz_, dlam_ = crk.crown_ric_solve(fact, rg_, rb_, wz32, prep)
                return dz_.to(rg_.dtype), dlam_.to(rg_.dtype)
        else:
            fact = _riccati_factor(qp, Hbar, prep, opts, fdt)

            def one_solve(rg_, rb_):
                return _riccati_solve(qp, fact, rg_, rb_, prep)

        def rsolve(rg_, rb_):
            dz_, dlam_ = one_solve(rg_, rb_)
            for _ in range(opts.refine_steps):
                # refinement against the exact data-dtype KKT operator
                r1, r2 = _kkt_apply(qp, Hbar, dz_, dlam_, prep, nrxm, zmask)
                cz, clam = one_solve(rg_ + r1, rb_ - r2)
                dz_, dlam_ = dz_ + cz, dlam_ + clam
            return dz_, dlam_

        # affine (predictor) step
        dz_a, _ = rsolve(rhs_g_aff, rb)
        ds_lo_a, ds_hi_a, dl_lo_a, dl_hi_a = expand_step(
            dz_a, rd_lo, rd_hi, rm_lo, rm_hi, s_lo, s_hi, l_lo, l_hi)
        a_p = torch.minimum(_max_step(s_lo, ds_lo_a, m_lo), _max_step(s_hi, ds_hi_a, m_hi))
        a_d = torch.minimum(_max_step(l_lo, dl_lo_a, m_lo), _max_step(l_hi, dl_hi_a, m_hi))
        alpha_aff = torch.minimum(a_p, a_d)
        mu = ((s_lo * l_lo * m_lo).sum() + (s_hi * l_hi * m_hi).sum()) / n_ineq
        mu_aff = (((s_lo + alpha_aff * ds_lo_a) * (l_lo + alpha_aff * dl_lo_a) * m_lo).sum()
                  + ((s_hi + alpha_aff * ds_hi_a) * (l_hi + alpha_aff * dl_hi_a)
                     * m_hi).sum()) / n_ineq
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 0.0, 1.0)

        # corrector: complementarity target sigma mu - ds_aff dl_aff
        rm_lo_c = rm_lo + (ds_lo_a * dl_lo_a - sigma * mu) * m_lo
        rm_hi_c = rm_hi + (ds_hi_a * dl_hi_a - sigma * mu) * m_hi
        rhs_g_c, _ = kkt_rhs(rg, rd_lo, rd_hi, rm_lo_c, rm_hi_c, s_lo, s_hi, l_lo, l_hi)
        dz, dlam = rsolve(rhs_g_c, rb)
        ds_lo, ds_hi, dl_lo, dl_hi = expand_step(
            dz, rd_lo, rd_hi, rm_lo_c, rm_hi_c, s_lo, s_hi, l_lo, l_hi)
        a_p = torch.minimum(_max_step(s_lo, ds_lo, m_lo, tf), _max_step(s_hi, ds_hi, m_hi, tf))
        a_d = torch.minimum(_max_step(l_lo, dl_lo, m_lo, tf), _max_step(l_hi, dl_hi, m_hi, tf))
        alpha = torch.minimum(a_p, a_d)

        # numerical-failure guard: a NaN direction (a failed Cholesky on a
        # late-barrier Muu) exits as MIN_STEP with the last finite iterate;
        # the direction is zeroed too (0 * NaN = NaN)
        ok = ~(torch.isnan(alpha) | torch.isnan(dz.sum()))
        alpha = torch.where(ok, alpha, 0.0)
        san = lambda v: torch.where(ok, v, 0.0)
        z = z + alpha * san(dz)
        lam = lam + alpha * san(dlam) * nrxm
        s_lo = torch.where(m_lo > 0, s_lo + alpha * san(ds_lo), 1.0)
        s_hi = torch.where(m_hi > 0, s_hi + alpha * san(ds_hi), 1.0)
        l_lo = torch.where(m_lo > 0, l_lo + alpha * san(dl_lo), 0.0)
        l_hi = torch.where(m_hi > 0, l_hi + alpha * san(dl_hi), 0.0)
        st2 = (z, lam, l_lo, l_hi, s_lo, s_hi)
        _, rb2, rd_lo2, rd_hi2, rm_lo2, rm_hi2 = r2 = residuals(*st2)
        res4 = torch.stack([
            r2[0].abs().max(), rb2.abs().max(),
            torch.maximum(rd_lo2.abs().max(), rd_hi2.abs().max()),
            torch.maximum(rm_lo2.abs().max(), rm_hi2.abs().max())])
        mu2 = ((s_lo * l_lo * m_lo).sum() + (s_hi * l_hi * m_hi).sum()) / n_ineq
        failed = (alpha < opts.alpha_min) | ~ok
        flags = torch.stack([res4.max(), failed.to(dt), mu2])
        return st2, res4, flags, torch.cat([res4, torch.stack([alpha, mu, sigma])])

    st0 = (z0, lam0, l_lo0, l_hi0, s_lo0, s_hi0)
    st, it, it_f32, status, res4, hist = _ipm_loop(iteration, st0, opts, dt, dev)
    z, lam, l_lo, l_hi, _, _ = st
    # export with the signed multiplier fold mu = l_hi - l_lo
    xm, um = (torch.as_tensor(m, dtype=dt, device=dev) for m in (topo.x_mask, topo.u_mask))
    mu_all = l_hi - l_lo
    info = dict(iter=it, iter_f32=it_f32, status=status, res4=res4)
    if opts.record_history:
        info["hist"] = hist
    return TreeQPOut(
        x=z[:, :nxm] * xm, u=z[:, nxm:] * um, lam=lam * nrxm,
        mu_x=mu_all[:, :nxm] * xm, mu_u=mu_all[:, nxm:nz] * um,
        mu_d=mu_all[:, nz:] * torch.as_tensor(topo.c_mask, dtype=dt, device=dev),
        info=info)

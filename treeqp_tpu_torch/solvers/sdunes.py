"""sdunes — dual Newton on the scenario decomposition.

Port of ``treeqp_tpu/solvers/sdunes.py`` (the reference's
``dual_Newton_scenarios.{h,c}``). The multistage tree is decomposed into
``Ns = md**Nr`` full-horizon scenarios; per-node costs are split across the
scenarios through the node; the dynamics inside each scenario are dualized
with ``mu[s, k]`` and the non-anticipativity of the controls at shared
nodes with ``lam[s, k]`` between adjacent scenarios (u[s, k] == u[s+1, k]
for k below their common prefix). Same restrictions as the reference:
uniform nx / nu, diagonal weights, bounds only, x0 fixed by equal bounds.

One Newton iteration: batched clipping stage solves and residuals in the
data dtype; the banded per-scenario mu-systems built, Jacobi-equilibrated
and factorized at the factor dtype (``tdunes_multistage._chain_factor`` in
reversed stage order, no crown coupling); ONE multi-right-hand-side full
solve ``Z = Mmm^-1 [r_mu | U]``; the Schur complement onto lam (the
block-tridiagonal "Jay" system) solved by cyclic reduction; with f32
factors, iterative refinement against the exact data-dtype dual Hessian
(``_sd_apply_M``); an Armijo step on the dual function with the gradient
fallback and the stall-triggered Levenberg-Marquardt shift of a cold
start. With ``chain_backend="pallas"`` (f32 factors) the factor, the full
solve and the Jay solve are the CUDA kernels ``ops.chain_kernels.chain_factor``,
``chain_full_solve_mat`` and ``ops.jay_kernel.jay_cr_solve``; with
``chain_backend="xla"`` they are plain PyTorch at the factor dtype (the
chain factor with the regularized block Cholesky, the sweeps, and
``ops.tridiag.tridiag_cr_solve``). The JAX version is one jitted
``while_loop``; here the loops are Python control flow, one host read per
decision.

``sdunes_solve`` runs the two-phase schedule of the tdunes solvers: with
``f32_phase_tol > 0`` a coarse all-f32 phase (stall exit after 3
iterations without progress), then the f64 phase, or with ``df64_phase``
``solvers.sd_df64``'s final phase (native f64 here); both need f64 data and
f32 factors. Every option the JAX package takes: the kernels or the plain
route, factors in f32 or in the data dtype. As in the JAX package the
chain kernels with factors in the data dtype raise ``ValueError``.

With ``axis_name`` set the solver runs on one rank of a sharded solve (the
JAX package's ``_SdShard`` under ``shard_map``): the scenario arrays hold
the rank's scenarios (``parallel.sharding.shard_scenarios``), the
non-anticipativity multipliers lambda and the Jay system stay replicated.
The control rows u[:, :Nr] of the coupling residual, the Jay system's
Gram blocks [Ns, nl, nl] and rt rows, its right-hand side's Kv rows and
the refinement's kv and rt rows are all-gathered; the lambda pulls act on
the rank's rows in the one-device order and the coupling coefficients are
formed globally and sliced; the dual value, the error and the line-search
scalars are reduced, so every host decision reads a value all ranks
share. The high-precision ``df64_phase`` is
bypassed under an axis, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TreeQPIn, TreeQPOut
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import jay_kernel as jk
from treeqp_tpu_torch.ops.tridiag import tridiag_cr_solve
from treeqp_tpu_torch.parallel import sharding
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm
from treeqp_tpu_torch.solvers.tdunes import (
    TDUNES_OPTIMAL, TDUNES_MAX_ITER, TDUNES_NOT_DESCENT)
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["SdunesOpts", "ScenarioQP", "sdunes_solve", "scenario_data", "scenario_meta",
           "scenario_duals_from_tree", "scenario_output", "SQP_FIELDS"]

SQP_FIELDS = ("Qd", "Rd", "q", "r", "xmin", "xmax", "umin", "umax", "A", "B", "b")


@dataclasses.dataclass(frozen=True)
class SdunesOpts:
    """Options: the same fields and defaults as
    ``treeqp_tpu.solvers.sdunes.SdunesOpts`` (reference
    treeqp_sdunes_opts_t, dual_Newton_scenarios.h:49-66), whose docstrings
    describe each field. ``stall_boost_after``: after that many iterations
    without a 10% residual improvement on the O(1) cold-start plateau
    (error > 1e-2), a Levenberg-Marquardt shift of ``reg_value`` (times
    min(error, 1)) enters every factorization, decaying tenfold an iteration
    once Newton makes progress; 0 disables. ``grad_fallback``: a
    curvature-scaled gradient step when the Newton step is not a descent
    direction or its Armijo search fails."""

    max_iter: int = 100
    termination: str = "infnorm"  # infnorm | twonorm | sumsquared
    tol: float = 1e-8
    ls_max_iter: int = 50
    ls_gamma: float = 0.1
    ls_beta: float = 0.6
    reg_type: str = "on_the_fly"  # none | always | on_the_fly
    reg_tol: float = 1e-6
    reg_value: float = 1e-6
    stall_boost_after: int = 4
    grad_fallback: bool = True
    factor_dtype: str = "same"  # same | float32
    refine_steps: int = 0
    f32_phase_tol: float = 0.0
    chain_backend: str = "xla"  # xla | pallas
    df64_phase: bool = False
    axis_name: str | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class _ScenMeta:
    Ns: int
    Nh: int
    Nr: int
    nx: int
    nu: int
    topo: TreeStructure
    paths: np.ndarray  # [Ns, Nh+1] node ids of each scenario, stage order
    common: tuple      # common[s] = # stages where scenarios s, s+1 share nodes


@dataclasses.dataclass(frozen=True)
class ScenarioQP:
    """Scenario-decomposed QP data, stacked [Ns, Nh(+1), ...]."""

    Qd: torch.Tensor  # [Ns, Nh+1, nx] probability-split diagonal weights
    Rd: torch.Tensor  # [Ns, Nh+1, nu] (stage Nh row is identity padding)
    q: torch.Tensor
    r: torch.Tensor
    xmin: torch.Tensor
    xmax: torch.Tensor
    umin: torch.Tensor
    umax: torch.Tensor
    A: torch.Tensor  # [Ns, Nh, nx, nx] dynamics of the edge into stage k+1
    B: torch.Tensor  # [Ns, Nh, nx, nu]
    b: torch.Tensor  # [Ns, Nh, nx]
    meta: _ScenMeta

    def replace(self, **kw) -> "ScenarioQP":
        return dataclasses.replace(self, **kw)

    def to(self, device=None, dtype=None) -> "ScenarioQP":
        """Every tensor moved to ``device`` and/or cast to ``dtype`` (the
        JAX package's ``_cast_sqp``)."""
        return self.replace(**{f: getattr(self, f).to(device=device, dtype=dtype)
                               for f in SQP_FIELDS})


def scenario_meta(topo: TreeStructure) -> _ScenMeta:
    """The scenario decomposition of a multistage tree: each scenario's
    leaf-to-root node ids in stage order (scenarios in leaf node order) and
    the stages that adjacent scenarios share below Nr."""
    params = topo.multistage_params
    if params is None:
        raise ValueError("sdunes requires a multistage scenario tree")
    md, Nr, Nh = params
    Ns = md**Nr
    leaves = np.nonzero(topo.nkids == 0)[0]
    assert len(leaves) == Ns
    parent = topo.parent_np
    paths = np.zeros((Ns, Nh + 1), dtype=np.int64)
    for s, leaf in enumerate(leaves):
        n = leaf
        for k in range(Nh, -1, -1):
            paths[s, k] = n
            n = parent[n]
    common = tuple(int(np.sum(paths[s, :Nr] == paths[s + 1, :Nr])) for s in range(Ns - 1))
    return _ScenMeta(Ns=Ns, Nh=Nh, Nr=Nr, nx=int(topo.nx[leaves[0]]), nu=int(topo.nu[0]),
                     topo=topo, paths=paths, common=common)


def scenario_data(qp: TreeQPIn) -> ScenarioQP:
    """Decompose a multistage tree QP into scenarios, on ``qp``'s device:
    each node's diagonal weights and gradients are divided by the number of
    scenarios through it (dual_Newton_scenarios.c:1884-1898)."""
    topo = qp.topo
    meta = scenario_meta(topo)
    paths = meta.paths
    share = np.ones(paths.shape)
    for k in range(meta.Nh + 1):
        _, inv, counts = np.unique(paths[:, k], return_inverse=True, return_counts=True)
        share[:, k] = counts[inv]
    dev, dt = qp.device, qp.dtype
    share = torch.as_tensor(share, dtype=dt, device=dev)[..., None]
    ids = torch.as_tensor(paths, device=dev)
    xm = torch.as_tensor(topo.x_mask, dtype=dt, device=dev)[ids]
    um = torch.as_tensor(topo.u_mask, dtype=dt, device=dev)[ids]
    Qd = torch.diagonal(qp.Q, dim1=1, dim2=2)[ids] / share * xm + (1 - xm)
    Rd = torch.diagonal(qp.R, dim1=1, dim2=2)[ids] / share * um + (1 - um)
    eids = ids[:, 1:]  # edge data indexed by the child node
    return ScenarioQP(
        Qd=Qd, Rd=Rd, q=qp.q[ids] / share * xm, r=qp.r[ids] / share * um,
        xmin=qp.xmin[ids], xmax=qp.xmax[ids], umin=qp.umin[ids], umax=qp.umax[ids],
        A=qp.A[eids], B=qp.B[eids], b=qp.b[eids], meta=meta)


def _coupling_masks(meta: _ScenMeta, dt, device):
    """cmask [max(Ns-1, 1), Nr]: 1 where lam[s, k] exists (k < common prefix)."""
    cm = np.zeros((max(meta.Ns - 1, 1), meta.Nr))
    for s in range(meta.Ns - 1):
        cm[s, : meta.common[s]] = 1.0
    return torch.as_tensor(cm, dtype=dt, device=device)


def _dmask(cmask, meta: _ScenMeta, nu: int):
    """The coupling mask per lam row, [Ns-1, Nr nu] (zeros [1, Nr nu] when
    Ns == 1)."""
    nl = meta.Nr * nu
    if meta.Ns > 1:
        return cmask.repeat_interleave(nu, dim=-1).reshape(meta.Ns - 1, nl)
    return torch.zeros((1, nl), dtype=cmask.dtype, device=cmask.device)


def _stage_solve(sqp: ScenarioQP, mu, lam, cmask, shard=sharding.ONE_DEVICE):
    """Batched clipping stage solves of all [Ns, Nh+1] scenario stages:
    hmod_x[s,k] = -q + mu[s,k] - A[s,k]'mu[s,k+1]      (mu[s,0] := 0)
    hmod_u[s,k] = -r - B[s,k]'mu[s,k+1] - lam[s,k] + lam[s-1,k].
    The rank's scenarios (from ``shard.start``), each pulled by the
    replicated lam in the one-device solve's order (its own pair's, then
    the previous one's), so that the rank's rows are the one-device
    solve's bit for bit."""
    Ns, Nr = sqp.meta.Ns, sqp.meta.Nr
    Atmu = torch.einsum("skji,skj->ski", sqp.A, mu)  # A_k' mu_{k+1} at stage k
    Btmu = torch.einsum("skji,skj->ski", sqp.B, mu)
    qmod = -sqp.q
    qmod[:, 1:] += mu
    qmod[:, :-1] -= Atmu
    rmod = -sqp.r
    rmod[:, :-1] -= Btmu
    if Ns > 1:
        lm = lam * cmask[..., None]
        lo = shard.start
        hi = lo + sqp.b.shape[0]
        own, prev = min(hi, Ns - 1), max(lo, 1)  # rows with a pair of their own / before
        rmod[:own - lo, :Nr] -= lm[lo:own]
        rmod[prev - lo:, :Nr] += lm[prev - 1:hi - 1]
    Qinv, Rinv = 1.0 / sqp.Qd, 1.0 / sqp.Rd
    xUnc, uUnc = Qinv * qmod, Rinv * rmod
    x = torch.clamp(xUnc, sqp.xmin, sqp.xmax)
    u = torch.clamp(uUnc, sqp.umin, sqp.umax)
    qt = torch.where((xUnc > sqp.xmax) | (xUnc < sqp.xmin), 0.0, Qinv)
    rt = torch.where((uUnc > sqp.umax) | (uUnc < sqp.umin), 0.0, Rinv)
    return dict(qmod=qmod, rmod=rmod, x=x, u=u, xUnc=xUnc, uUnc=uUnc, qt=qt, rt=rt)


def _residuals(sqp: ScenarioQP, sol, cmask, shard=sharding.ONE_DEVICE):
    """r_mu[s,k] = A x_k + B u_k + b - x_{k+1};  r_lam = u_s - u_{s+1} on
    the coupled stages ([1, Nr, nu] zeros when Ns == 1). r_mu is the
    rank's; the coupling rows u[:, :Nr] are all-gathered (``shard``), so
    r_lam is replicated."""
    x, u = sol["x"], sol["u"]
    r_mu = (torch.einsum("skij,skj->ski", sqp.A, x[:, :-1])
            + torch.einsum("skij,skj->ski", sqp.B, u[:, :-1]) + sqp.b - x[:, 1:])
    Nr = sqp.meta.Nr
    if sqp.meta.Ns > 1:
        u_c = shard.gather_s(u[:, :Nr])
        r_lam = (u_c[:-1] - u_c[1:]) * cmask[..., None]
    else:
        r_lam = torch.zeros((1, Nr, u.shape[-1]), dtype=u.dtype, device=u.device)
    return r_mu, r_lam


def _dual_value(sqp: ScenarioQP, sol, mu, shard=sharding.ONE_DEVICE):
    """f = -g: over the scenario stages -1/2 z'Hz + hmod'z, minus sum b'mu
    (the coupling constraints have no constant term); every term is a
    scenario's, summed over the ranks (``shard``)."""
    x, u = sol["x"], sol["u"]
    quad = torch.sum(x * sqp.Qd * x) + torch.sum(u * sqp.Rd * u)
    lin = torch.sum(sol["qmod"] * x) + torch.sum(sol["rmod"] * u)
    return shard.psum(-0.5 * quad + lin - torch.sum(sqp.b * mu))


def _error_of(opts: SdunesOpts, r_mu, r_lam, shard=sharding.ONE_DEVICE):
    """The termination measure of the dual residuals (0-dim tensor); a tree
    without couplings (Nr == 0) has an empty r_lam. r_mu is the rank's
    (reduced over the ranks, ``shard``), r_lam replicated."""
    if opts.termination == "infnorm":
        e = shard.pmax(r_mu.abs().max())
        return torch.maximum(e, r_lam.abs().max()) if r_lam.numel() else e
    sq = shard.psum(torch.sum(r_mu**2)) + torch.sum(r_lam**2)
    return torch.sqrt(sq) if opts.termination == "twonorm" else sq


def _banded_blocks(A, B, qt, rt):
    """mu-mu dual Hessian blocks per scenario (banded):
    D[s,k] = A_k qt_k A_k' + B_k rt_k B_k' + qt_{k+1}   (k = 0..Nh-1)
    Ssub[s,k] = M[mu_{k+2}, mu_{k+1}] = -A_{k+1} qt_{k+1}  (k = 0..Nh-2)."""
    D = (torch.einsum("skin,skn,skjn->skij", A, qt[:, :-1], A)
         + torch.einsum("skin,skn,skjn->skij", B, rt[:, :-1], B))
    nx = D.shape[-1]
    D = D + torch.eye(nx, dtype=D.dtype, device=D.device) * qt[:, 1:, None, :]
    Ssub = -(A[:, 1:] * qt[:, 1:-1, None, :])
    return D, Ssub


def _coupling_columns(B, rt, meta: _ScenMeta):
    """U [Ns, Nh, nx, Nr nu]: the columns of lam(t, :) in the mu rows of
    scenario t (mu stage k+1 sees u[t, k] through B_k: block B_k rt_k); the
    columns of lam(t-1, :) are -U of scenario t."""
    Ns, Nh, nx, nu = B.shape
    Nr = meta.Nr
    Brt = B[:, :Nr] * rt[:, :Nr, None, :]  # [Ns, Nr, nx, nu]
    U = torch.zeros((Ns, Nh, nx, Nr, nu), dtype=B.dtype, device=B.device)
    for k in range(Nr):
        U[:, k, :, k] = Brt[:, k]
    return U.reshape(Ns, Nh, nx, Nr * nu)


def _jay_blocks(rt, Gram, cmask, meta: _ScenMeta):
    """Jay = Mll - Mlm Mmm^-1 Mml, block-tridiagonal over scenario pairs:
    diagonal block of pair s diag(rt_s + rt_{s+1}) - Gram_s - Gram_{s+1},
    off-diagonal (pair s+1, pair s) -diag(rt_{s+1}) + Gram_{s+1}; rows and
    columns of missing couplings set to the identity. Returns (diag, off,
    rt_l, dm); their dtype follows ``cmask``'s promotion with ``Gram``'s,
    as in the JAX package."""
    Ns, Nr = meta.Ns, meta.Nr
    nu = rt.shape[-1]
    nl = Nr * nu
    dt, dev = Gram.dtype, Gram.device
    eye = torch.eye(nl, dtype=dt, device=dev)
    rt_l = rt[:, :Nr].reshape(Ns, nl)
    dm = _dmask(cmask, meta, nu)
    diag = eye * (rt_l[:-1] + rt_l[1:])[:, None, :] - Gram[:-1] - Gram[1:]
    off = (-(eye * rt_l[1:-1, None, :]) + Gram[1:-1] if Ns > 2
           else torch.zeros((max(Ns - 2, 0), nl, nl), dtype=dt, device=dev))
    diag = diag * dm[:, :, None] * dm[:, None, :] + eye * (1.0 - dm)[:, None, :]
    if Ns > 2:
        off = off * dm[1:, :, None] * dm[:-1, None, :]
    return diag, off, rt_l, dm


def _jay_solve(diag, off, rhs, opts: SdunesOpts, extra_shift=None):
    """Solve the Jay system by Jacobi-equilibrated cyclic reduction at the
    factor dtype (f32 with ``factor_dtype="float32"``, else rhs's), in
    rhs's dtype times the scale: ``ops.jay_kernel.jay_cr_solve`` with
    ``chain_backend="pallas"`` where the kernel takes the block size, else
    ``ops.tridiag.tridiag_cr_solve``. The Levenberg-Marquardt shift acts at
    the original scale (reg_value scJ^2 after equilibration);
    ``extra_shift`` (0-dim) is added to the diagonal unconditionally (the
    stall escalation)."""
    out_dt = rhs.dtype
    fdt = td._factor_dtype(opts, out_dt)
    if extra_shift is not None:
        diag = diag + extra_shift.to(diag.dtype) * torch.eye(
            diag.shape[-1], dtype=diag.dtype, device=diag.device)
    scJ = torch.rsqrt(torch.clamp(torch.diagonal(diag, dim1=1, dim2=2), min=1e-12))
    dg = (diag * scJ[:, :, None] * scJ[:, None, :]).to(fdt).contiguous()
    of = (off * scJ[1:, :, None] * scJ[:-1, None, :]).to(fdt).contiguous()
    r = (rhs * scJ).to(fdt).contiguous()
    shift = ((opts.reg_value * scJ * scJ).to(fdt).contiguous()
             if opts.reg_type != "none" else None)
    reg_tol = opts.reg_tol if opts.reg_type == "on_the_fly" else -1.0
    if opts.chain_backend == "pallas" and jk.jay_supported(*dg.shape[:2]):
        x = jk.jay_cr_solve(dg, of, r, shift=shift, reg_tol=reg_tol)
    else:
        x = tridiag_cr_solve(dg, of, r, shift=shift, reg_tol=reg_tol)
    return x.to(out_dt) * scJ


def _sd_factor(D, Ssub, opts: SdunesOpts, extra_shift=None):
    """Equilibrate the per-scenario banded mu-systems and factor them with
    ``tdunes_multistage._chain_factor`` (``chain_factor`` with
    ``chain_backend="pallas"``, else plain with the regularized block
    Cholesky of ``opts.reg_type``): the reversed stage order maps the
    forward banded Cholesky onto the chains' backward one, with no crown
    coupling (Ut_0 = 0). The shift on a zero-curvature row acts on the raw
    diagonal (the original scale); ``extra_shift`` (0-dim) is added
    unconditionally. Returns dict(Ls, CUs, sc)."""
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    dg = torch.diagonal(D, dim1=2, dim2=3)
    if extra_shift is not None:
        es = extra_shift.to(D.dtype)
        D = D + es * eye
        dg = dg + es
    if opts.reg_type != "none":
        shift = torch.where(dg < opts.reg_tol,
                            torch.tensor(opts.reg_value, dtype=D.dtype, device=D.device), 0.0)
        D = D + shift[..., :, None] * eye
        dg = dg + shift
    sc = torch.rsqrt(torch.clamp(dg, min=1e-12))
    Ds = D * sc[..., :, None] * sc[..., None, :]
    Ss = Ssub * sc[:, 1:, :, None] * sc[:, :-1, None, :]
    Wc = torch.flip(Ds, (1,))
    Ut = torch.cat([torch.zeros_like(Ss[:, :1]), torch.flip(Ss, (1,))], dim=1)
    Ls, CUs, _ = tm._chain_factor(Wc, Ut, opts)
    return dict(Ls=Ls, CUs=CUs, sc=sc)


def _sd_full_solve(fact, rhs, opts: SdunesOpts):
    """Mmm^-1 rhs for rhs [Ns, Nh, nx, m] (any dtype; solved at the
    factors' dtype: one ``chain_full_solve_mat`` launch with
    ``chain_backend="pallas"``, else the plain backward and forward
    sweeps), in rhs's dtype times the scale."""
    sc, Ls, CUs = fact["sc"], fact["Ls"], fact["CUs"]
    rr = torch.flip((rhs * sc[..., None]).to(Ls.dtype), (1,))
    if opts.chain_backend == "pallas":
        z = ck.chain_full_solve_mat(Ls, CUs, rr.contiguous())
    else:
        z = torch.empty_like(rr)
        acc = torch.zeros_like(rr[:, 0])
        for j in range(Ls.shape[1] - 1, -1, -1):
            z[:, j] = torch.linalg.solve_triangular(Ls[:, j], rr[:, j] - acc, upper=False)
            acc = CUs[:, j] @ z[:, j]
        zp = torch.zeros_like(rr[:, 0])
        for j in range(Ls.shape[1]):
            zp = torch.linalg.solve_triangular(Ls[:, j].mT, z[:, j] - CUs[:, j].mT @ zp,
                                               upper=True)
            z[:, j] = zp
    return torch.flip(z, (1,)).to(rhs.dtype) * sc[..., None]


def _sd_apply_M(sqp: ScenarioQP, sol, cmask, dm, dmu, dlam_flat, AT=None, BT=None,
                shard=sharding.ONE_DEVICE):
    """Exact data-dtype action of the full dual Hessian on (dmu, dlam):
    Mmm dmu (banded) + Mml dlam, and Mlm dmu + Mll dlam, applied in factored
    form (matvecs, no materialized blocks). The coupling coefficients are
    formed in ``dlam_flat * dm``'s dtype (f32 in the high-precision phase,
    as the JAX package's). Returns (A [Ns, Nh, nx], Al [Ns-1, Nr nu]): A
    the rank's; the rt and kv coupling rows are all-gathered (``shard``),
    so Al is replicated."""
    Ns, Nr = sqp.meta.Ns, sqp.meta.Nr
    nu = sqp.r.shape[-1]
    nl = Nr * nu
    qt, rt = sol["qt"][:, :-1], sol["rt"][:, :-1]   # stage k (edge parent)
    qt_c = sol["qt"][:, 1:]                          # stage k+1 (child x)
    if AT is None:
        AT, BT = sqp.A.transpose(2, 3), sqp.B.transpose(2, 3)
    t0 = torch.einsum("skij,skj->ski", AT, dmu)      # A_k' dmu_k
    t = t0.clone()
    t[:, 1:] -= dmu[:, :-1]
    r = torch.einsum("skij,skj->ski", BT, dmu)       # B_k' dmu_k
    A = (torch.einsum("skij,skj->ski", sqp.A, qt * t)
         + torch.einsum("skij,skj->ski", sqp.B, rt * r))
    u = dmu.clone()
    u[:, :-1] -= t0[:, 1:]
    A = A + qt_c * u
    if Ns > 1:
        rt_l = shard.gather_s(sol["rt"][:, :Nr]).reshape(Ns, nl)
        dl = dlam_flat * dm
        coef = torch.zeros((Ns, nl), dtype=dl.dtype, device=dl.device)
        coef[:-1] += dl
        coef[1:] -= dl
        coef = shard.slice_s(coef)
        A[:, :Nr] += torch.einsum("skij,skj->ski", sqp.B[:, :Nr],
                                  rt[:, :Nr] * coef.reshape(-1, Nr, nu))
        kv = shard.gather_s((rt[:, :Nr] * r[:, :Nr]).reshape(-1, nl))
        Al = (rt_l[:-1] + rt_l[1:]) * dl
        if Ns > 2:
            Al[1:] -= rt_l[1:-1] * dl[:-1]
            Al[:-1] -= rt_l[1:-1] * dl[1:]
        Al = (Al + kv[:-1] - kv[1:]) * dm
    else:
        Al = torch.zeros_like(dlam_flat, dtype=A.dtype)
    return A, Al


def _coef_of(dlam_flat, Ns):
    """The lam coefficients per scenario: +dlam of its own pair, -dlam of
    the previous one."""
    coef = torch.zeros((Ns,) + tuple(dlam_flat.shape[1:]), dtype=dlam_flat.dtype,
                       device=dlam_flat.device)
    if Ns > 1:
        coef[:-1] += dlam_flat
        coef[1:] -= dlam_flat
    return coef


def _armijo(f_at, f0, dot, tau0, f1, opts, slack):
    """Backtracking from tau0 (f1 = f_at(tau0)): accept f <= f0 + gamma tau
    dot + slack. Returns (tau, line-search count, accepted)."""
    tau, i = tau0, 1
    acc = bool(f1 <= f0 + opts.ls_gamma * tau * dot + slack)
    while not acc and i < opts.ls_max_iter:
        tau = opts.ls_beta * tau
        acc = bool(f_at(tau) <= f0 + opts.ls_gamma * tau * dot + slack)
        i += 1
    return tau, i, acc


def _sd_consts(sqp: ScenarioQP, opts: SdunesOpts):
    """What every iteration of ``_sd_newton_loop`` reads besides its carry:
    the coupling masks, the dynamics at the factor dtype (the blocks) and
    transposed (the refinement's Hessian action)."""
    cmask = _coupling_masks(sqp.meta, sqp.b.dtype, sqp.b.device)
    bdt = td._factor_dtype(opts, sqp.b.dtype)
    return dict(cmask=cmask, dm=_dmask(cmask, sqp.meta, sqp.r.shape[-1]),
                A_b=sqp.A.to(bdt), B_b=sqp.B.to(bdt),
                AT=sqp.A.transpose(2, 3), BT=sqp.B.transpose(2, 3))


def _sd_newton_step(sqp: ScenarioQP, opts: SdunesOpts, c, lam, mu, status, sol, r_mu,
                    r_lam, boost, shard=sharding.ONE_DEVICE):
    """One Newton step from (lam, mu) with the stage solution ``sol`` and
    residuals there: blocks and factorization at the factor dtype
    (``boost`` added to every factorization), one full solve of
    [r_mu | U], the Jay solve, with f32 factors ``refine_steps``
    refinement passes (each one full solve and one Jay solve) against the
    exact Hessian, then the Armijo search (noise slack 2^-45 |f0| in f64,
    2^-18 in f32) or the gradient fallback. ``c`` is ``_sd_consts(sqp,
    opts)``; ``shard`` the solve's shard context
    (``parallel.sharding.shard_for``). Returns (lam, mu, status, ls_it)."""
    meta = sqp.meta
    Ns, Nr = meta.Ns, meta.Nr
    nu = sqp.r.shape[-1]
    nl = Nr * nu
    dt, dev = sqp.b.dtype, sqp.b.device
    cmask, dm = c["cmask"], c["dm"]
    gather, psum = shard.gather_s, shard.psum  # over every rank's scenarios

    def f_at(mu_t, lam_t):
        return _dual_value(sqp, _stage_solve(sqp, mu_t, lam_t, cmask, shard), mu_t, shard)

    bdt = c["A_b"].dtype
    qt_b, rt_b = sol["qt"].to(bdt), sol["rt"].to(bdt)
    D, Ssub = _banded_blocks(c["A_b"], c["B_b"], qt_b, rt_b)
    Uown = _coupling_columns(c["B_b"], rt_b, meta)
    fact = _sd_factor(D, Ssub, opts, extra_shift=boost)
    # ONE multi-RHS full solve: [r_mu | U] -> [z_mu | Z_u]
    Z = _sd_full_solve(fact, torch.cat([r_mu.to(bdt)[..., None], Uown], dim=-1), opts)
    z_mu, Zu = Z[..., 0], Z[..., 1:]
    # the Jay system's Gram blocks: the boundary tensor of the scenario
    # decomposition ([Ns, nl, nl] a factorization), with its rt rows
    Gram = gather(torch.einsum("skxl,skxm->slm", Uown, Zu))
    diag, off, _, _ = _jay_blocks(gather(rt_b[:, :Nr]), Gram, cmask, meta)
    rl_full = (r_lam.reshape(Ns - 1, nl) * dm if Ns > 1
               else torch.zeros((1, nl), dtype=dt, device=dev))

    def schur_solve(e_l, z_mu_):
        """Direction from a mu-space solve z_mu_ = Mmm^-1 e_mu."""
        if Ns > 1:
            Kv = gather(torch.einsum("skxl,skx->sl", Uown, z_mu_.to(bdt)))  # [Ns, nl] rows
            rl = (e_l.to(bdt) - (Kv[:-1] - Kv[1:])) * dm.to(bdt)
            dl = _jay_solve(diag, off, rl, opts, extra_shift=boost).to(dt) * dm
        else:
            dl = torch.zeros((1, nl), dtype=dt, device=dev)
        coef = shard.slice_s(_coef_of(dl, Ns))
        dmu_ = z_mu_.to(dt) - torch.einsum("skxl,sl->skx", Zu, coef.to(bdt)).to(dt)
        return dmu_, dl

    dmu, dlam_flat = schur_solve(rl_full, z_mu)
    for _ in range(max(opts.refine_steps, 0) if opts.factor_dtype == "float32" else 0):
        Amu, Al = _sd_apply_M(sqp, sol, cmask, dm, dmu, dlam_flat, c["AT"], c["BT"], shard)
        z2 = _sd_full_solve(fact, (r_mu - Amu)[..., None], opts)[..., 0]
        cmu, cl = schur_solve(rl_full - Al, z2)
        dmu = dmu + cmu
        dlam_flat = dlam_flat + cl
    dlam = dlam_flat.reshape(max(Ns - 1, 1), Nr, nu) * cmask[..., None]

    # Armijo on f = -g over (lam, mu) jointly, with the noise slack
    dot = -(psum(torch.sum(r_mu * dmu)) + torch.sum(r_lam * dlam))
    descent_ok = bool(dot < 1e-10)  # the JAX package's documented < 0 deviation
    f0 = _dual_value(sqp, sol, mu, shard)
    eta = (2.0 ** -45 if dt == torch.float64 else 2.0 ** -18) * torch.abs(f0)
    one = torch.ones((), dtype=dt, device=dev)
    tau, ls_it, acc = _armijo(lambda t: f_at(mu + t * dmu, lam + t * dlam), f0, dot,
                              one, f_at(mu + one * dmu, lam + one * dlam), opts, eta)
    lam2, mu2 = (lam + tau * dlam, mu + tau * dmu) if descent_ok else (lam, mu)
    if opts.grad_fallback:
        if not descent_ok or not acc:
            # a curvature-scaled gradient step: (r_lam, r_mu) is always
            # an ascent direction of g
            # D is the rank's, the Jay diagonal replicated
            L_est = shard.pmax(torch.diagonal(D, dim1=2, dim2=3).abs().max().to(dt))
            if Ns > 1:
                L_est = torch.maximum(
                    L_est, torch.diagonal(diag, dim1=1, dim2=2).abs().max().to(dt))
            t0 = 1.0 / torch.clamp(L_est, min=1e-12)
            dot_g = -(psum(torch.sum(r_mu * r_mu)) + torch.sum(r_lam * r_lam))
            fg = lambda t: f_at(mu + t * r_mu, lam + t * r_lam)
            tau_g, ls_g, _ = _armijo(fg, f0, dot_g, t0, fg(t0), opts, 0.0)
            lam2, mu2 = lam + tau_g * r_lam, mu + tau_g * r_mu
            ls_it += ls_g
    elif not descent_ok:
        status = TDUNES_NOT_DESCENT
    return lam2, mu2, status, ls_it


def _escalates(opts: SdunesOpts, noimp: int, err) -> bool:
    """Whether the stall escalation engages at an iteration: on the O(1)
    cold-start plateau only (``stall_boost_after`` iterations without a
    10% improvement and the error above 1e-2)."""
    return (opts.stall_boost_after > 0 and noimp >= opts.stall_boost_after
            and bool(err > 1e-2))


def _sd_iteration(sqp: ScenarioQP, opts: SdunesOpts, c, lam, mu, status, ls_it, best,
                  noimp, boost, shard=sharding.ONE_DEVICE):
    """One pass of the loop body from its carry (the JAX loop's ``body``):
    the stage solution and error at (lam, mu), the stall bookkeeping
    (``best``, ``noimp``, the escalation ``boost``), then a Newton step
    unless the error is below tol. Returns (lam, mu, err, status, ls_it,
    best, noimp, boost, shift_now, stepped)."""
    dt, dev = sqp.b.dtype, sqp.b.device
    sol = _stage_solve(sqp, mu, lam, c["cmask"], shard)
    r_mu, r_lam = _residuals(sqp, sol, c["cmask"], shard)
    err = _error_of(opts, r_mu, r_lam, shard)
    noimp = 0 if bool(err < 0.9 * best) else noimp + 1
    best = torch.minimum(best, err)
    if opts.stall_boost_after > 0:
        # the shift engages on the plateau, and decays once Newton makes
        # progress so that the tail is exact
        if _escalates(opts, noimp, err):
            boost = torch.full((), opts.reg_value, dtype=dt, device=dev)
        else:
            boost = 0.1 * boost
    # the shift scales with the residual (LM for nonlinear equations)
    shift_now = boost * torch.clamp(err, max=1.0)
    stepped = not bool(err < opts.tol)
    if stepped:
        lam, mu, status, ls_it = _sd_newton_step(sqp, opts, c, lam, mu, status, sol, r_mu,
                                                 r_lam, shift_now, shard)
    return lam, mu, err, status, ls_it, best, noimp, boost, shift_now, stepped


def _sd_newton_loop(sqp: ScenarioQP, lam0, mu0, opts: SdunesOpts, it0: int,
                    patience: int = 0, shard=sharding.ONE_DEVICE):
    """The sdunes dual-Newton loop at the dtype of ``sqp``'s data, counting
    Newton steps from ``it0``: ``_sd_iteration`` until the error is below
    tol, the status is not optimal or max_iter is reached. ``patience > 0``
    adds the coarse phase's stall exit. Returns (lam, mu, it, err, status,
    ls_it, boosts: the iterations at which the stall escalation engaged)."""
    dt, dev = sqp.b.dtype, sqp.b.device
    c = _sd_consts(sqp, opts)
    lam, mu, it = lam0, mu0, it0
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    err, best, boost = inf, inf, torch.zeros((), dtype=dt, device=dev)
    status, ls_it, noimp, boosts = TDUNES_OPTIMAL, 0, 0, 0
    while (bool(err >= opts.tol) and status == TDUNES_OPTIMAL and it < opts.max_iter
           and (patience <= 0 or noimp < patience)):
        lam, mu, err, status, ls_it, best, noimp, boost, _, stepped = _sd_iteration(
            sqp, opts, c, lam, mu, status, ls_it, best, noimp, boost, shard)
        boosts += _escalates(opts, noimp, err)
        if not stepped:
            break
        it += 1
    return lam, mu, it, err, status, ls_it, boosts


def _check_opts(opts: SdunesOpts):
    """Raise on options ``sdunes_solve`` does not take: the chain kernels
    with factors in the data dtype (they are f32 only; the JAX package's
    raise too), an unknown regularization or termination."""
    if opts.chain_backend == "pallas" and opts.factor_dtype != "float32":
        raise ValueError("chain_backend='pallas' needs factor_dtype='float32' "
                         "(the chain kernels are f32)")
    if opts.reg_type not in ("none", "always", "on_the_fly"):
        raise ValueError(f"reg_type={opts.reg_type!r}")
    if opts.termination not in ("infnorm", "twonorm", "sumsquared"):
        raise ValueError(f"termination={opts.termination!r}")


def sdunes_solve(sqp: ScenarioQP, lam0=None, mu0=None, opts: SdunesOpts = SdunesOpts()):
    """Dual Newton on the scenario decomposition (treeqp_sdunes_solve,
    dual_Newton_scenarios.c:1850-2091), on the device of ``sqp``'s tensors.

    ``lam0`` [max(Ns-1, 1), Nr, nu] / ``mu0`` [Ns, Nh, nx] warm-start the
    duals (zeros when None). The stall escalation is a cold-start
    globalization: it stays on only when the caller passes no duals. With
    ``f32_phase_tol > 0`` (f64 data, f32 factors) a coarse all-f32 phase
    runs to f32_phase_tol or a 3-iteration stall first; then the f64 phase,
    or with ``df64_phase`` (f64 data, f32 factors)
    ``sd_df64.sd_newton_loop_df``.

    Returns (sol dict of [Ns, Nh+1] trajectories, lam, mu, info);
    ``info["iter"]`` counts the Newton steps of both phases,
    ``info["iter_f32"]`` the coarse phase's, ``info["stall_boosts"]`` the
    iterations at which the stall escalation engaged (0 on a warm start).

    With ``opts.axis_name`` set, one rank of a sharded solve (the module
    docstring; ``parallel.shard_solver.sdunes_solve_shmap``): ``sqp`` and
    ``mu0`` hold the rank's scenarios, ``lam0`` all couplings; ``sol`` and
    ``mu`` come out the rank's, ``lam`` and ``info`` the same on every
    rank, and ``info["comm"]`` counts the collectives (``bytes``,
    ``calls``, ``max_call``, ``bytes_per_iter``). A cold start (no duals)
    keeps the stall escalation, as on one device."""
    _check_opts(opts)
    meta = sqp.meta
    Ns, Nh, Nr = meta.Ns, meta.Nh, meta.Nr
    nx, nu = sqp.b.shape[-1], sqp.r.shape[-1]
    dt, dev = sqp.b.dtype, sqp.b.device
    S_loc = sqp.b.shape[0]
    shard = sharding.shard_for(opts.axis_name, S_loc)
    cmask = _coupling_masks(meta, dt, dev)
    if (lam0 is not None or mu0 is not None) and opts.stall_boost_after:
        opts = dataclasses.replace(opts, stall_boost_after=0)
    if mu0 is None:
        mu0 = torch.zeros((S_loc, Nh, nx), dtype=dt, device=dev)
    if lam0 is None:
        lam0 = torch.zeros((max(Ns - 1, 1), Nr, nu), dtype=dt, device=dev)

    it0, boosts = 0, 0
    f32 = torch.float32
    f32_factors = opts.factor_dtype == "float32"
    if opts.f32_phase_tol > 0 and dt == torch.float64 and f32_factors:
        optsA = dataclasses.replace(opts, refine_steps=0,
                                    tol=max(opts.f32_phase_tol, opts.tol))
        lamA, muA, it0, _, _, _, boosts = _sd_newton_loop(
            sqp.to(dtype=f32), lam0.to(f32), mu0.to(f32), optsA, it0, patience=3,
            shard=shard)
        # the coarse phase's status is dropped: a not-descent there is
        # expected noise near the f32 residual floor, not a failure
        lam0, mu0 = lamA.to(dt), muA.to(dt)

    if opts.df64_phase and dt == torch.float64 and f32_factors and opts.axis_name is None:
        from treeqp_tpu_torch.solvers.sd_df64 import sd_newton_loop_df
        lam, mu, it, _, status, ls_it = sd_newton_loop_df(sqp, lam0, mu0, opts, it0)
    else:
        lam, mu, it, _, status, ls_it, boosts_hi = _sd_newton_loop(sqp, lam0, mu0, opts, it0,
                                                                   shard=shard)
        boosts += boosts_hi

    sol = _stage_solve(sqp, mu, lam, cmask, shard)
    err = float(_error_of(opts, *_residuals(sqp, sol, cmask, shard), shard))
    if status == TDUNES_OPTIMAL and not err < opts.tol:
        status = TDUNES_MAX_ITER
    info = dict(iter=it, status=status, error=err, ls_iter=ls_it, iter_f32=it0,
                stall_boosts=boosts)
    if opts.axis_name is not None:
        info["comm"] = shard.summary(it)
    return sol, lam, mu, info


def scenario_duals_from_tree(sqp: ScenarioQP, lam_tree, out: TreeQPOut = None):
    """Scenario duals (lam0, mu0) from a tree solution.

    With ``lam_tree`` only (the tree-edge dynamics multipliers), the copies
    of a shared edge split its multiplier equally: mu[s, k] =
    lam_tree[path(s, k+1)] / #scenarios through the edge (exact on the
    chains, inconsistent at branching stages). With the full tree solution
    ``out``, the copy duals are recovered exactly: mu by the per-scenario
    adjoint recursion of the copy's x-stationarity
        mu[s, k-1] = Qd x_k + q_k + mu_x_k / cnt + A_k' mu[s, k]
    (no A term at k = Nh), and lam by telescoping the copy u-stationarity
    over each coupled block, lam[s, k] = lam[s-1, k] + rmod0 - Rd u_k -
    mu_u_k / cnt (rmod0 the lam-free modified gradient)."""
    meta = sqp.meta
    Ns, Nh, Nr = meta.Ns, meta.Nh, meta.Nr
    nx, nu = sqp.b.shape[-1], sqp.r.shape[-1]
    dt, dev = sqp.b.dtype, sqp.b.device
    paths = meta.paths
    cnt = np.zeros(meta.topo.Nn)
    np.add.at(cnt, paths.reshape(-1), 1.0)
    lam0 = torch.zeros((max(Ns - 1, 1), Nr, nu), dtype=dt, device=dev)
    ids = torch.as_tensor(paths, device=dev)
    if out is None:
        div = torch.as_tensor(cnt[paths[:, 1:]], dtype=dt, device=dev)[..., None]
        return lam0, (lam_tree[ids[:, 1:], :nx] / div).to(dt)

    share = torch.as_tensor(cnt[paths], dtype=dt, device=dev)[..., None]
    x_sc = out.x[ids][..., :nx]
    mux_sc = out.mu_x[ids][..., :nx] / share
    muu_sc = out.mu_u[ids][..., :nu] / share
    u_sc = out.u[ids][..., :nu]
    mus, mu_next = [], None
    for k in range(Nh, 0, -1):
        g = sqp.Qd[:, k] * x_sc[:, k] + sqp.q[:, k] + mux_sc[:, k]
        if k < Nh:
            g = g + torch.einsum("sji,sj->si", sqp.A[:, k], mu_next)
        mus.append(g)
        mu_next = g
    mu0 = torch.flip(torch.stack(mus, dim=1), (1,))  # [Ns, Nh, nx]

    if Ns > 1:
        cmask = _coupling_masks(meta, dt, dev)
        sol0 = _stage_solve(sqp, mu0, lam0, cmask)
        d = sol0["rmod"][:, :Nr] - sqp.Rd[:, :Nr] * u_sc[:, :Nr] - muu_sc[:, :Nr]
        lams, prev = [], torch.zeros((Nr, nu), dtype=dt, device=dev)
        for s in range(Ns - 1):
            prev = (prev + d[s]) * cmask[s][:, None]  # restarts at block edges
            lams.append(prev)
        lam0 = torch.stack(lams)
    return lam0, mu0


def scenario_output(sqp: ScenarioQP, sol, lam, mu, info) -> TreeQPOut:
    """Average the scenario copies back onto the tree and recover the
    multipliers (export at dual_Newton_scenarios.c:2028-2075): tree-edge
    lam = sum of the mu of the scenarios through the edge; bound
    multipliers sum Qd (xUnc - x) over the copies. ``lam`` is not read: the
    non-anticipativity multipliers have no tree counterpart."""
    meta = sqp.meta
    topo = meta.topo
    dt, dev = sqp.b.dtype, sqp.b.device
    Nn = topo.Nn
    paths = meta.paths
    Ns, Nh1 = paths.shape
    flat = torch.as_tensor(paths.reshape(-1), device=dev)
    share = np.zeros(Nn)
    np.add.at(share, paths.reshape(-1), 1.0)

    def tot(v, idx):
        w = v.reshape(idx.numel(), -1)
        return torch.zeros((Nn, w.shape[1]), dtype=dt, device=dev).index_add_(0, idx, w)

    avg = lambda v: tot(v, flat) / torch.as_tensor(share, dtype=dt, device=dev)[:, None]
    mask = lambda m: torch.as_tensor(m, dtype=dt, device=dev)
    eflat = torch.as_tensor(paths[:, 1:].reshape(-1), device=dev)
    return TreeQPOut(
        x=avg(sol["x"]) * mask(topo.x_mask), u=avg(sol["u"]) * mask(topo.u_mask),
        lam=tot(mu, eflat) * mask(topo.nonroot_x_mask),
        mu_x=tot(sqp.Qd * (sol["xUnc"] - sol["x"]), flat) * mask(topo.x_mask),
        mu_u=tot(sqp.Rd * (sol["uUnc"] - sol["u"]), flat) * mask(topo.u_mask),
        mu_d=torch.zeros((Nn, topo.ncm), dtype=dt, device=dev), info=info)

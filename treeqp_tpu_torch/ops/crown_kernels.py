"""Crown (generic-tree) factorize of the multistage dual Hessian.

Port of ``_get_sched`` and ``crown_blocks_factor`` in
``treeqp_tpu/ops/crown_kernels.py``. ``crown_blocks_factor`` launches the
CUDA kernel of ``csrc/crown_blocks_factor.cu`` on CUDA tensors and runs
the plain PyTorch twin ``crown_blocks_factor_ref`` on CPU tensors; both
are f32, like the Pallas kernel. The level schedule is a list of (child
group, parent group, slot) triples per level instead of the TPU kernel's
one-hot lane-permutation matrices. ``crown_factor``, ``crown_solve`` and
``crown_eval`` of that module are not ported yet.

Factors are group-major: CholW [NpG, G, G], CholUt [NpG, nxm, G] (the JAX
kernel's are lane-major [G, G, NPg]).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.ops import _build, _dense

__all__ = ["crown_supported", "crown_blocks_factor", "crown_blocks_factor_ref"]

_MAX_G = 64  # block dim bound, as in the JAX crown_supported


@dataclasses.dataclass(frozen=True)
class _CrownSched:
    """Backward level schedule of the crown block Cholesky (deepest parent
    stage first; the root group 0 comes after the last level)."""

    n_lev: int
    K: int
    G: int
    nxm: int
    NpG: int
    lev_ptr: np.ndarray     # [n_lev + 1] offsets into the lev_* arrays
    lev_child: np.ndarray   # group factorized at this entry
    lev_parent: np.ndarray  # its parent group
    lev_slot: np.ndarray    # its slot in the parent group
    committed: np.ndarray   # [NpG] 1 where a level or the root factorizes the group
    width: int              # most groups on one level
    _tensors: dict = dataclasses.field(default_factory=dict, compare=False)

    def on(self, device) -> dict:
        """The int32 schedule arrays on ``device`` (cached)."""
        device = torch.device(device)
        hit = self._tensors.get(device)
        if hit is None:
            hit = {k: torch.as_tensor(getattr(self, k), dtype=torch.int32,
                                      device=device)
                   for k in ("lev_ptr", "lev_child", "lev_parent",
                             "lev_slot", "committed")}
            self._tensors[device] = hit
        return hit


def _get_sched(prep) -> _CrownSched:
    """Build / fetch the per-topology schedule from a tdunes ``_Prep``."""
    sched = getattr(prep, "_crown_sched", None)
    if sched is not None:
        return sched
    assert prep.NpG == 0 or prep.gdad[0] == -1, "group 0 must be the root group"
    ptr, child, parent, slot = [0], [], [], []
    committed = np.zeros(prep.NpG, np.int32)
    if prep.NpG:
        committed[0] = 1
    for lev in prep.levels:
        child.extend(lev)
        parent.extend(prep.gdad[lev])
        slot.extend(prep.gslot[lev])
        committed[lev] = 1
        ptr.append(len(child))
    i32 = lambda v: np.asarray(v, np.int32)
    sched = _CrownSched(
        n_lev=len(prep.levels), K=prep.K, G=prep.G, nxm=prep.nxm,
        NpG=prep.NpG, lev_ptr=i32(ptr), lev_child=i32(child),
        lev_parent=i32(parent), lev_slot=i32(slot), committed=committed,
        width=max([len(v) for v in prep.levels] + [1]))
    prep._crown_sched = sched
    return sched


def crown_supported(prep, opts) -> bool:
    """The fused crown path applies: moderate block dim, f32 factors, a
    static regularization (the kernel's LM shift)."""
    return (prep.G <= _MAX_G and prep.nxm <= 16
            and opts.factor_dtype == "float32"
            and opts.reg_type in ("always", "none"))


def _crown_blocks(ABk, ztp, dvals, sW, sUt, Wadd):
    """Scaled crown blocks W [NpG, G, G] and Ut [NpG, nxm, G]."""
    NpG, K, nxm, nz = ABk.shape
    G = K * nxm
    AB = ABk.reshape(NpG, G, nz)
    W = _dense.outer_sum(AB, AB, ztp) + torch.diag_embed(dvals)
    W = W * sW[:, :, None] * sW[:, None, :] + Wadd
    # Ut[i, k*nxm + c] = -ztp[i] A_k[c, i]  (x rows only)
    Ut = -(ztp[:, :nxm, None] * AB[:, :, :nxm].transpose(1, 2))
    Ut = Ut * sUt[:, :, None] * sW[:, None, :]
    return W.contiguous(), Ut.contiguous()


def crown_blocks_factor_ref(ABk, ztp, dvals, sW, sUt, Wadd, prep, reg=0.0):
    """Plain PyTorch twin of the kernel (see ``crown_blocks_factor``)."""
    sched = _get_sched(prep)
    K, nxm = sched.K, sched.nxm
    W, Ut = _crown_blocks(ABk, ztp, dvals, sW, sUt, Wadd)
    NpG, G = W.shape[0], W.shape[1]
    committed = torch.as_tensor(sched.committed > 0, device=W.device)
    eye = torch.eye(G, dtype=W.dtype, device=W.device).expand(NpG, G, G)
    CholW = torch.where(committed[:, None, None], W, eye).clone()
    CholUt = torch.zeros_like(Ut)
    Wv = W.view(NpG, K, nxm, K, nxm)
    for r in range(sched.n_lev):
        sl = slice(int(sched.lev_ptr[r]), int(sched.lev_ptr[r + 1]))
        g = torch.as_tensor(sched.lev_child[sl], dtype=torch.long, device=W.device)
        d = torch.as_tensor(sched.lev_parent[sl], dtype=torch.long, device=W.device)
        s = torch.as_tensor(sched.lev_slot[sl], dtype=torch.long, device=W.device)
        Lf = _dense.chol(W[g], reg=reg, clamp_diag=True)
        CU = _dense.rtrsm_t(Lf, Ut[g])
        CholW[g], CholUt[g] = Lf, CU
        # one child per (parent, slot): a plain indexed update
        Wv[d, s, :, s, :] -= _dense.outer_sum(CU, CU)
    if sched.committed[0]:
        CholW[0] = _dense.chol(W[0], reg=reg, clamp_diag=True)
    return CholW, CholUt


def crown_blocks_factor(ABk, ztp, dvals, sW, sUt, Wadd, prep, reg=0.0):
    """Crown block build (sibling cross terms A_i qtp A_j' + the kids' own
    qtilde, dual_Newton_tree_clipping.c:264-355) + Jacobi scaling + the
    additive chain-Schur term + the level-synchronous block Cholesky with a
    static LM shift ``reg``.

    ABk [NpG, K, nxm, nz] kids' masked [A B]; ztp [NpG, nz] the parent
    node's masked inverses; dvals [NpG, G] kids' own qtilde diagonals (1 on
    empty slots); sW [NpG, G] Jacobi scales; sUt [NpG, nxm] the dad-row
    scales; Wadd [NpG, G, G] pre-scaled additive term (the negated chain
    Schur complements). All f32. Returns CholW [NpG, G, G], CholUt
    [NpG, nxm, G].
    """
    if ABk.device.type == "cpu":
        return crown_blocks_factor_ref(ABk, ztp, dvals, sW, sUt, Wadd, prep, reg)
    name = "crown_blocks_factor"
    sched = _get_sched(prep)
    NpG, K, nxm, G = sched.NpG, sched.K, sched.nxm, sched.G
    nz = ABk.shape[-1]
    dev = ABk.device
    for arg, t, shape in (("ABk", ABk, (NpG, K, nxm, nz)), ("ztp", ztp, (NpG, nz)),
                          ("dvals", dvals, (NpG, G)), ("sW", sW, (NpG, G)),
                          ("sUt", sUt, (NpG, nxm)), ("Wadd", Wadd, (NpG, G, G))):
        _build.require(name, arg, t, shape, dev)
    if not (0 < NpG and 0 < nxm <= 16 and G <= _MAX_G and nxm <= nz):
        raise ValueError(f"{name}: unsupported shape {tuple(ABk.shape)}")
    f32 = dict(dtype=torch.float32, device=dev)
    CholW = torch.empty((NpG, G, G), **f32)
    CholUt = torch.empty((NpG, nxm, G), **f32)
    t = sched.on(dev)
    threads = min(1024, max(32, -(-max(NpG, sched.width) // 32) * 32))
    err = _build.lib().tq_crown_blocks_factor(
        ABk.data_ptr(), ztp.data_ptr(), dvals.data_ptr(), sW.data_ptr(),
        sUt.data_ptr(), Wadd.data_ptr(), t["lev_ptr"].data_ptr(),
        t["lev_child"].data_ptr(), t["lev_parent"].data_ptr(),
        t["lev_slot"].data_ptr(), t["committed"].data_ptr(),
        CholW.data_ptr(), CholUt.data_ptr(), NpG, K, nxm, nz, sched.n_lev,
        float(reg), threads, _build.stream(dev))
    _build.check(err, name)
    crown_blocks_factor.launches += 1
    return CholW, CholUt


crown_blocks_factor.launches = 0

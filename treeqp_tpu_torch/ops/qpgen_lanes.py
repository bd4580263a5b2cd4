"""The ADMM active-set identification of the general stage QPs (the
qpOASES capability of tdunes).

Port of ``admm_identify`` of ``treeqp_tpu/ops/qpgen_lanes.py``: the scaled
ADMM loop over all general stage QPs in one kernel launch
(``csrc/admm_identify.cu``), and its plain PyTorch twin
``admm_identify_ref``. The module keeps the JAX name so that a reader finds
the counterpart, but nodes are not on lanes here: the operands are
node-major ([N, ng, nz], [N, nz, nz], [N, ng], [N, nz]), the layout of
``solvers/tdunes._qpgen_batch``, which calls it. The rest of the JAX
module, the lane-major pipeline ``qpgen_solve_lanes`` with its
double-float polish, is a TPU workaround the port does not carry:
``_qpgen_batch`` runs in native f64.

The wrapper checks the operands on every device, then launches the kernel
on CUDA tensors (f32 or f64) and runs the twin on CPU tensors.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _build, _dense

__all__ = ["admm_identify", "admm_identify_ref", "MAX_NZ", "MAX_NG"]

MAX_NZ = 16  # the kernel's bounds on the stage dim nz and the rows ng
MAX_NG = 32


def admm_identify_ref(G, L, rho, lo, hi, h, z0, iters: int):
    """Plain PyTorch twin of the kernel (see ``admm_identify``), in the
    Pallas body's order of operations: G z summed over z per row g, G'u
    over g with h added last, the triangular solves of ``_dense``."""
    y = torch.minimum(torch.maximum(_dense.mv(G, z0), lo), hi)
    lm = torch.zeros_like(y)
    for _ in range(iters):
        rhs = h + _dense.mv(G, rho * (y - lm), trans=True)
        z = _dense.uttrsv(L, _dense.ltrsv(L, rhs))
        t = _dense.mv(G, z) + lm
        y = torch.minimum(torch.maximum(t, lo), hi)
        lm = t - y
    return lm


def admm_identify(G, L, rho, lo, hi, h, z0, iters: int):
    """Scaled ADMM for all general stage QPs  min 1/2 z'Hz - h'z,
    lo <= G z <= hi, the whole loop in one launch: with L the lower
    Cholesky factor of H + G' diag(rho) G, y = clip(G z0, lo, hi), lm = 0,
    then ``iters`` times z = L'^-1 L^-1 (h + G'(rho (y - lm))),
    t = G z + lm, y = clip(t, lo, hi), lm = t - y.

    G [N, ng, nz], L [N, nz, nz], rho, lo, hi [N, ng], h, z0 [N, nz], all
    of one dtype (f32, or f64) on one device. Returns lm [N, ng]
    (mu = rho lm). Raises on nz > MAX_NZ, ng > MAX_NG or ng < nz (the
    kernel's bounds, on the CPU too)."""
    name = "admm_identify"
    if G.dim() != 3:
        raise ValueError(f"{name}: G must be [N, ng, nz], got {tuple(G.shape)}")
    N, ng, nz = G.shape
    dt, dev = G.dtype, G.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: dtype {dt} (takes float32 or float64)")
    if not (0 < N and 0 < nz <= MAX_NZ and nz <= ng <= MAX_NG):
        raise ValueError(f"{name}: unsupported shape G {tuple(G.shape)} (nz <= "
                         f"{MAX_NZ}, nz <= ng <= {MAX_NG})")
    if iters < 0:
        raise ValueError(f"{name}: iters={iters}")
    args = (("G", G, (N, ng, nz)), ("L", L, (N, nz, nz)), ("rho", rho, (N, ng)),
            ("lo", lo, (N, ng)), ("hi", hi, (N, ng)), ("h", h, (N, nz)), ("z0", z0, (N, nz)))
    for arg, t, shape in args:
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {shape} {dt} on {dev}")
    if dev.type == "cpu":
        return admm_identify_ref(G, L, rho, lo, hi, h, z0, iters)
    for arg, t, shape in args:
        _build.require(name, arg, t, shape, dev, dt)
    lm = torch.empty((N, ng), dtype=dt, device=dev)
    entry = "tq_admm_identify_f32" if dt == torch.float32 else "tq_admm_identify_f64"
    err = getattr(_build.lib(), entry)(
        G.data_ptr(), L.data_ptr(), rho.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        h.data_ptr(), z0.data_ptr(), lm.data_ptr(), N, ng, nz, int(iters),
        _build.stream(dev))
    _build.check(err, name)
    admm_identify.launches += 1
    return lm


admm_identify.launches = 0

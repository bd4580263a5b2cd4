"""Cyclic-reduction (parallel-scan) variants of the chain solve sweeps.

Port of ``chain_cr_precompute``, ``chain_solve_bwd_cr`` and
``chain_forward_cr`` in ``treeqp_tpu/ops/chain_cr.py``. The serial sweeps
of ``chain_kernels`` (``chain_solve_bwd``, ``chain_forward``) are L
dependent n x n triangular steps per chain; written as affine recurrences

    bwd:  y_j = b_j + A_j y_{j+1},   A_j = -L_j^-1 CU_{j+1}  (A_{L-1} = 0),
          b_j = L_j^-1 r_j
    fwd:  d_j = c_j + B_j d_{j-1},   B_j = -L_j^-T CU_j',
          c_j = L_j^-T y_j  (the root term B_0 droot folded into c_0)

they are a suffix and a prefix scan, computed by ceil(log2 L) doubling
levels of independent n x n compositions. A and B depend only on the
factors: ``chain_cr_precompute`` builds them once per factorization.

No solver of the port calls these kernels, as none of the JAX package's
does: they are the accept/reject variant of the chain sweeps, measured
against the serial kernels by ``scripts/prof_torch_chain_cr.py``.

Layout is the port's chain layout (``chain_kernels``): factors ``Ls``,
``CUs`` [S, L, n, n] from ``chain_factor``, vectors [S, L, n], so
``chain_solve_bwd_cr``'s ys feeds ``chain_forward_cr`` or
``chain_forward`` directly. Each wrapper launches its CUDA kernel
(``csrc/chain_cr.cu``) on CUDA tensors and runs its plain PyTorch twin
(``*_ref``, the same doubling, not the serial sweep) on CPU tensors. All
f32, like the Pallas kernels.
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _build, _dense
from treeqp_tpu_torch.ops.chain_kernels import _chain_shape_check

__all__ = ["chain_cr_precompute", "chain_cr_precompute_ref", "chain_solve_bwd_cr",
           "chain_solve_bwd_cr_ref", "chain_forward_cr", "chain_forward_cr_ref"]

# the shared memory one thread block may take on the card (227 KB with the
# opt-in); a sweep whose buffers need more gets a global scratch
_MAX_SMEM = 227 * 1024


def chain_cr_precompute_ref(Ls, CUs):
    """Plain PyTorch twin of the kernel (see ``chain_cr_precompute``)."""
    Abwd = torch.zeros_like(CUs)
    Abwd[:, :-1] = -_dense.ltrsv_mat(Ls[:, :-1], CUs[:, 1:])
    Bfwd = -_dense.uttrsv_mat(Ls, CUs.mT.contiguous())
    return Abwd, Bfwd


def chain_cr_precompute(Ls, CUs):
    """The composition operands of the CR sweeps, once per factorization:
    Abwd_j = -Ls_j^-1 CUs_{j+1} (Abwd_{L-1} = 0) and Bfwd_j = -Ls_j^-T
    CUs_j'.

    Ls, CUs [S, L, n, n] (``chain_factor``'s), f32. Returns (Abwd, Bfwd)
    [S, L, n, n]."""
    if Ls.device.type == "cpu":
        return chain_cr_precompute_ref(Ls, CUs)
    name = "chain_cr_precompute"
    S, L, n, _ = Ls.shape
    dev = Ls.device
    for arg, t in (("Ls", Ls), ("CUs", CUs)):
        _build.require(name, arg, t, (S, L, n, n), dev)
    _chain_shape_check(name, S, L, n)
    Abwd = torch.empty((S, L, n, n), dtype=torch.float32, device=dev)
    Bfwd = torch.empty_like(Abwd)
    err = _build.lib().tq_chain_cr_precompute(
        Ls.data_ptr(), CUs.data_ptr(), Abwd.data_ptr(), Bfwd.data_ptr(), S, L, n,
        _build.stream(dev))
    _build.check(err, name)
    chain_cr_precompute.launches += 1
    return Abwd, Bfwd


chain_cr_precompute.launches = 0


def _shifted(X, h, up):
    """X with its chain index moved by h: entry j holds X_{j+h} (``up``) or
    X_{j-h}, zero where that index leaves the chain."""
    Z = torch.zeros_like(X)
    if up:
        Z[:, :-h] = X[:, h:]
    else:
        Z[:, h:] = X[:, :-h]
    return Z


def _doubling(M, v, suffix):
    """v_j <- v_j + M_j v_{j+-h}, M_j <- M_j M_{j+-h} for h = 1, 2, 4, ..
    < L (j + h for the suffix scan, j - h for the prefix scan)."""
    L, h = M.shape[1], 1
    while h < L:
        v = v + _dense.mv(M, _shifted(v, h, suffix))
        M = _dense.mm(M, _shifted(M, h, suffix))
        h *= 2
    return v


def chain_solve_bwd_cr_ref(Ls, CUs, Abwd, res):
    """Plain PyTorch twin of the kernel (see ``chain_solve_bwd_cr``)."""
    ys = _doubling(Abwd, _dense.ltrsv(Ls, res), suffix=True)
    return ys, _dense.mv(CUs[:, 0], ys[:, 0])


def _scratch(S, L, n, dev):
    """A sweep's global scratch when its buffers exceed a block's shared
    memory, else None."""
    floats = 2 * (L * n * n + L * n)
    if floats * 4 <= _MAX_SMEM:
        return None
    return torch.empty((S, floats), dtype=torch.float32, device=dev)


def chain_solve_bwd_cr(Ls, CUs, Abwd, res):
    """``chain_solve_bwd`` as a suffix scan: b_j = Ls_j^-1 res_j for every
    j at once, then the doubling levels of y_j = b_j + Abwd_j y_{j+1}.

    Ls, CUs, Abwd [S, L, n, n] (``chain_cr_precompute``'s Abwd); res
    [S, L, n]. All f32. Returns (ys [S, L, n], radd0 [S, n] = CUs_0 ys_0),
    as ``chain_solve_bwd``."""
    if Ls.device.type == "cpu":
        return chain_solve_bwd_cr_ref(Ls, CUs, Abwd, res)
    name = "chain_solve_bwd_cr"
    S, L, n, _ = Ls.shape
    dev = Ls.device
    for arg, t, shape in (("Ls", Ls, (S, L, n, n)), ("CUs", CUs, (S, L, n, n)),
                          ("Abwd", Abwd, (S, L, n, n)), ("res", res, (S, L, n))):
        _build.require(name, arg, t, shape, dev)
    _chain_shape_check(name, S, L, n)
    ys = torch.empty((S, L, n), dtype=torch.float32, device=dev)
    radd0 = torch.empty((S, n), dtype=torch.float32, device=dev)
    scratch = _scratch(S, L, n, dev)
    err = _build.lib().tq_chain_solve_bwd_cr(
        Ls.data_ptr(), CUs.data_ptr(), Abwd.data_ptr(), res.data_ptr(), ys.data_ptr(),
        radd0.data_ptr(), None if scratch is None else scratch.data_ptr(), S, L, n,
        _build.stream(dev))
    _build.check(err, name)
    chain_solve_bwd_cr.launches += 1
    return ys, radd0


chain_solve_bwd_cr.launches = 0


def chain_forward_cr_ref(Ls, CUs, Bfwd, ys, droot):
    """Plain PyTorch twin of the kernel (see ``chain_forward_cr``)."""
    c = _dense.uttrsv(Ls, ys)
    c = torch.cat([(c[:, 0] + _dense.mv(Bfwd[:, 0], droot))[:, None], c[:, 1:]], dim=1)
    return _doubling(Bfwd, c, suffix=False)


def chain_forward_cr(Ls, CUs, Bfwd, ys, droot):
    """``chain_forward`` as a prefix scan: c_j = Ls_j^-T ys_j for every j at
    once, c_0 += Bfwd_0 droot, then the doubling levels of d_j = c_j +
    Bfwd_j d_{j-1}.

    Ls, CUs, Bfwd [S, L, n, n] (``chain_cr_precompute``'s Bfwd; CUs enters
    only through it and is taken for the signature of ``chain_forward``);
    ys [S, L, n]; droot [S, n]. All f32. Returns dls [S, L, n]."""
    if Ls.device.type == "cpu":
        return chain_forward_cr_ref(Ls, CUs, Bfwd, ys, droot)
    name = "chain_forward_cr"
    S, L, n, _ = Ls.shape
    dev = Ls.device
    for arg, t, shape in (("Ls", Ls, (S, L, n, n)), ("CUs", CUs, (S, L, n, n)),
                          ("Bfwd", Bfwd, (S, L, n, n)), ("ys", ys, (S, L, n)),
                          ("droot", droot, (S, n))):
        _build.require(name, arg, t, shape, dev)
    _chain_shape_check(name, S, L, n)
    dls = torch.empty((S, L, n), dtype=torch.float32, device=dev)
    scratch = _scratch(S, L, n, dev)
    err = _build.lib().tq_chain_forward_cr(
        Ls.data_ptr(), Bfwd.data_ptr(), ys.data_ptr(), droot.data_ptr(), dls.data_ptr(),
        None if scratch is None else scratch.data_ptr(), S, L, n, _build.stream(dev))
    _build.check(err, name)
    chain_forward_cr.launches += 1
    return dls


chain_forward_cr.launches = 0

"""Block cyclic reduction of the sdunes Jay system in one launch.

Port of ``jay_cr_solve`` in ``treeqp_tpu/ops/jay_kernel.py``: the Jay
system (non-anticipativity couplings, block tridiagonal with P = Ns - 1
blocks of size b = Nr nu) is solved by block cyclic reduction in
ceil(log2 P) dependent levels. The wrapper launches the CUDA kernel
(``csrc/jay_cr.cu``) on CUDA tensors and runs the plain PyTorch twin
``jay_cr_solve_ref`` on CPU tensors. f32, like the Pallas kernel, whose
semantics both keep: each block's Cholesky floors its pivots at 1e-12 and
writes d rsqrt(d) on the diagonal; the per-row Levenberg-Marquardt shift is
added always (reg_tol < 0) or on the fly to a block whose raw pivot
a_kk rsqrt(max(a_kk, 1e-12)) is <= reg_tol or NaN. Level h eliminates the
blocks with index % 2h == h and updates those with index % 2h == 0; block
0 is the root; back substitution runs deepest level first (the order of
``treeqp_tpu/ops/tridiag.py``). The Pallas kernel's lane layout, padding to
128 lanes, one-hot shift matmuls and its caps on P and b are not carried
over: any P and b <= 16.

The kernel runs in one thread block, a group of 4, 8 or 16 lanes per block
system (b <= 4, 8, 16): the Cholesky a lane a row with shuffles, the 2b + 1
right-hand sides a lane a column, the updates a lane a row. It is bound by
the latency of its dependent levels, not by its bytes. Its operands live in
shared memory where they fit (P = 255, b = 4 does); beyond, in a global
scratch this wrapper allocates (``tq_jay_cr_scratch`` says how much).
"""

from __future__ import annotations

import torch

from treeqp_tpu_torch.ops import _build, _dense

__all__ = ["jay_cr_solve", "jay_cr_solve_ref", "jay_supported"]

PIVOT_FLOOR = 1e-12
MAX_B = 16


def _chol(W, sh, reg_tol):
    """Per-block Cholesky [..., b, b] with the kernel's pivot rule and
    shift rule (``sh`` [..., b] or None; reg_tol >= 0: on the fly)."""
    def factor(add):
        b = W.shape[-1]
        Lf = torch.zeros_like(W)
        ok = torch.ones(W.shape[:-2], dtype=torch.bool, device=W.device)
        for k in range(b):
            a = W[..., :, k].clone()
            if add is not None:
                a[..., k] = a[..., k] + add[..., k]
            for m in range(k):
                a = a - Lf[..., :, m] * Lf[..., k:k + 1, m]
            d = torch.clamp(a[..., k:k + 1], min=PIVOT_FLOOR)
            dinv = torch.rsqrt(d)
            ok &= (a[..., k] * dinv[..., 0]) > reg_tol
            col = a * dinv
            col[..., k:k + 1] = d * dinv
            col[..., :k] = 0.0
            Lf[..., :, k] = col
        return Lf, ok
    if sh is None:
        return factor(None)[0]
    if reg_tol < 0:
        return factor(sh)[0]
    L0, ok = factor(None)
    L1, _ = factor(sh)
    return torch.where(ok[..., None, None], L0, L1)


def _solve_vec(Lf, v):
    return _dense.uttrsv(Lf, _dense.ltrsv(Lf, v))


def _solve_mat(Lf, B):
    return _dense.uttrsv_mat(Lf, _dense.ltrsv_mat(Lf, B))


def _at(v, idx, P):
    """v[idx] with zeros where idx is out of [0, P)."""
    ok = (idx >= 0) & (idx < P)
    out = torch.zeros((idx.numel(),) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    out[ok] = v[idx[ok]]
    return out


def jay_cr_solve_ref(diag, off, rhs, shift=None, reg_tol: float = -1.0):
    """Plain PyTorch twin of the kernel (see ``jay_cr_solve``)."""
    P, b, _ = diag.shape
    dev = diag.device
    D = diag.clone()
    C = torch.zeros_like(diag)
    C[1:] = off
    r = rhs.clone()
    Z1s, Z2s, zrs = torch.zeros_like(diag), torch.zeros_like(diag), torch.zeros_like(rhs)
    h, levels = 1, []
    while h < P:
        p = torch.arange(h, P, 2 * h, device=dev)
        Lm = _chol(D[p], None if shift is None else shift[p], reg_tol)
        Z1s[p] = _solve_mat(Lm, C[p])
        Z2s[p] = _solve_mat(Lm, _at(C, p + h, P).transpose(1, 2))
        zrs[p] = _solve_vec(Lm, r[p])
        e = torch.arange(0, P, 2 * h, device=dev)
        Ce, Cr = C[e], _at(C, e + h, P)
        Z1r, zrr = _at(Z1s, e + h, P), _at(zrs, e + h, P)
        D[e] = (D[e] - _dense.mm(Ce, _at(Z2s, e - h, P))) - _dense.mm(Cr, Z1r, trans_a=True)
        r[e] = (r[e] - _dense.mv(Ce, _at(zrs, e - h, P))) - _dense.mv(Cr, zrr, trans=True)
        C[e] = -_dense.mm(Ce, _at(Z1s, e - h, P))
        levels.append(h)
        h *= 2
    x = torch.zeros_like(rhs)
    x[:1] = _solve_vec(_chol(D[:1], None if shift is None else shift[:1], reg_tol), r[:1])
    for h in reversed(levels):
        o = torch.arange(h, P, 2 * h, device=dev)
        x[o] = ((zrs[o] - _dense.mv(Z1s[o], x[o - h]))
                - _dense.mv(Z2s[o], _at(x, o + h, P)))
    return x


_SCRATCH = {}


def _scratch_floats(P, b):
    """Floats of global scratch the kernel needs at (P, b): 0 where its
    operands fit shared memory (cached)."""
    n = _SCRATCH.get((P, b))
    if n is None:
        n = _SCRATCH[P, b] = int(_build.lib().tq_jay_cr_scratch(P, b))
    return n


def jay_supported(P: int, b: int) -> bool:
    """The kernel takes the system: any number of blocks, blocks of size
    b <= 16 (the Pallas kernel's caps on P and b are not carried over)."""
    return P >= 1 and 0 < b <= MAX_B


def jay_cr_solve(diag, off, rhs, shift=None, reg_tol: float = -1.0):
    """Solve the SPD block-tridiagonal system by cyclic reduction in one
    launch.

    diag [P, b, b], off [P-1, b, b] (block (i+1, i)), rhs [P, b], shift
    [P, b] the per-row Levenberg-Marquardt diagonal (None: no shift);
    reg_tol < 0 adds the shift to every block, >= 0 only to the blocks with
    a raw pivot <= reg_tol or NaN. All f32. Returns x [P, b]."""
    if diag.device.type == "cpu":
        return jay_cr_solve_ref(diag, off, rhs, shift, reg_tol)
    name = "jay_cr_solve"
    P, b, _ = diag.shape
    dev = diag.device
    if not jay_supported(P, b):
        raise ValueError(f"{name}: unsupported shape P={P} b={b}")
    for arg, t, shape in (("diag", diag, (P, b, b)), ("off", off, (P - 1, b, b)),
                          ("rhs", rhs, (P, b))):
        _build.require(name, arg, t, shape, dev)
    if shift is not None:
        _build.require(name, "shift", shift, (P, b), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.empty((P, b), **f32)
    n_scratch = _scratch_floats(P, b)
    scratch = torch.empty((n_scratch,), **f32) if n_scratch else None
    err = _build.lib().tq_jay_cr_solve(
        diag.data_ptr(), off.data_ptr(), rhs.data_ptr(),
        None if shift is None else shift.data_ptr(), x.data_ptr(),
        None if scratch is None else scratch.data_ptr(), P, b, float(reg_tol),
        _build.stream(dev))
    _build.check(err, name)
    jay_cr_solve.launches += 1
    return x


jay_cr_solve.launches = 0

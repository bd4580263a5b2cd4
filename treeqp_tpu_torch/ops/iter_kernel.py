"""One whole f32 Newton iteration of the coarse phase in one launch.

Port of ``iter_sched``, ``iter_supported`` and ``newton_iter`` in
``treeqp_tpu/ops/iter_kernel.py``. ``newton_iter`` launches the CUDA kernel
of ``csrc/newton_iter.cu`` on CUDA tensors and runs the plain PyTorch twin
``newton_iter_ref`` on CPU tensors; both are f32. The twin is the
composition the kernel fuses: ``system_kernels.system_solve_ref``, the
trial step, ``chain_kernels.chain_eval_ref`` and
``crown_kernels.crown_eval_ref``. The TPU kernel's one-hot layout matrices
(J, N2G, R) become the index lists of ``iter_sched``. The kernel runs on
one cluster of 8 thread blocks (8 SMs): the chain sweeps on lane groups,
the crown's levels a warp a group, the evaluation a thread a node.

Layouts are the port's: chains [S, L, ...], crown nodes [Nn, ...], crown
groups [NpG, G].
"""

from __future__ import annotations

import numpy as np
import torch

from treeqp_tpu_torch.ops import _build, _dense
from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import crown_kernels as ckr
from treeqp_tpu_torch.ops import system_kernels as sk
from treeqp_tpu_torch.solvers import tdunes as td

__all__ = ["iter_sched", "iter_supported", "newton_iter", "newton_iter_ref",
           "launch_args"]


def iter_sched(prep, root_ids, device) -> dict:
    """The index lists of the fused iteration as int32 tensors on
    ``device``: the crown level schedule (``crown_kernels._get_sched``),
    each chain root's crown group and slot (``system_kernels.ms_sched``),
    the crown tree (``crown_kernels.eval_sched``), and rid [S], the crown
    node of each chain root, which replaces the TPU kernel's injection
    matrix R. Cached by the schedules it collects."""
    cache = prep.__dict__.setdefault("_iter_rid", {})
    key = (tuple(root_ids), torch.device(device))
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(root_ids), dtype=torch.int32,
                                     device=device)
    return {**ckr._get_sched(prep).on(device), **sk.ms_sched(prep, root_ids, device),
            **ckr.eval_sched(prep, device), "rid": cache[key]}


def iter_supported(prep, meta, opts) -> bool:
    """The fused iteration applies where the fused system solve does and
    the chains' [x, u] width equals the crown's (the root contributions are
    added to the crown's modified gradients as they are). No node cap."""
    return sk.system_supported(prep, meta, opts) and meta.nu == prep.topo.num


def newton_iter_ref(data_ch, data_cr, fact, state, prep, root_ids, mode="iter"):
    """Plain PyTorch twin of the kernel (see ``newton_iter``)."""
    f32 = torch.float32
    lam_cr, lam_ch = state["lam_cr"].to(f32), state["lam_ch"].to(f32)
    if mode == "eval":
        dcr, dch = torch.zeros_like(lam_cr), torch.zeros_like(lam_ch)
        dotc = torch.zeros_like(lam_cr[:, 0])
        dots = torch.zeros_like(lam_ch[:, 0, 0])
        lam2_cr, lam2_ch = lam_cr, lam_ch
    else:
        res_cr, res_ch = state["res_cr"].to(f32), state["res_ch"].to(f32)
        rg = td._nodes_to_group_mm(res_cr * fact["s_node"], prep)
        dg, dch_s = sk.system_solve_ref(fact["Ls"], fact["CUs"], fact["CholW"],
                                        fact["CholUt"], rg, res_ch * fact["sc"],
                                        prep, root_ids)
        dcr = td._group_to_nodes_mm(dg, prep, f32) * fact["s_node"]
        dch = dch_s * fact["sc"]
        lam2_cr, lam2_ch = lam_cr + dcr, lam_ch + dch
        dotc = -_dense.sum_last(res_cr * dcr)
        per_j = _dense.sum_last(res_ch * dch)
        dots = torch.zeros_like(per_j[:, 0])
        for j in range(per_j.shape[1]):
            dots = dots + per_j[:, j]
        dots = -dots
    ch = ck.chain_eval_ref(data_ch, lam2_ch)
    rid = torch.as_tensor(np.asarray(root_ids), device=lam_cr.device)
    extra = torch.zeros_like(data_cr["ABt"][:, 0])
    extra[rid] = ch["cqr"]
    cr = ckr.crown_eval_ref(data_cr, lam2_cr, extra, prep)
    z_root = torch.cat([cr["x"][rid], cr["u"][rid]], dim=1)
    res_ch2 = ch["res_part"].clone()
    res_ch2[:, 0] = res_ch2[:, 0] + _dense.mv(data_ch["ABt"][:, 0], z_root)
    return dict(
        dcr=dcr, dch=dch, lam2_cr=lam2_cr, lam2_ch=lam2_ch,
        res2_cr=cr["res"], res2_ch=res_ch2, qt=ch["qt"], rt=ch["rt"],
        qtilde=cr["qtilde"], rtilde=cr["rtilde"], x=ch["x"], u=ch["u"],
        cx=cr["x"], cu=cr["u"], xUnc=ch["xUnc"], uUnc=ch["uUnc"],
        cxUnc=cr["xUnc"], cuUnc=cr["uUnc"],
        f1p=(ch["fch"], cr["fcr"]), dotp=(dots, dotc),
        errp=(res_ch2.abs().amax(dim=(1, 2)), cr["res"].abs().amax(dim=1)))


def launch_args(data_ch, data_cr, fact, state, prep, root_ids, mode="iter", stamps=None):
    """The kernel's checked operands on CUDA tensors: (out, ptrs, dims,
    keep), with ``out`` the output dict the launch fills, ``ptrs`` and
    ``dims`` the C call's pointer and int arrays, and ``keep`` the tensors
    the pointers address (alive until the launch returns). ``stamps``: None,
    or an int64 CUDA tensor [8, 20] for the kernel's timer reads around its
    phases (``csrc/newton_iter.cu``)."""
    name = "newton_iter"
    if mode not in ("iter", "eval"):
        raise ValueError(f"{name}: mode must be 'iter' or 'eval', not {mode!r}")
    lam_ch = state["lam_ch"]
    S, L, n, nz = data_ch["ABt"].shape
    nu = nz - n
    Nn = data_cr["ABt"].shape[0]
    sched = ckr._get_sched(prep)
    NpG, G, K = sched.NpG, sched.G, sched.K
    dev = lam_ch.device
    f32 = dict(dtype=torch.float32, device=dev)
    as32 = lambda t: t.to(torch.float32).contiguous()
    lam_cr, lam_ch = as32(state["lam_cr"]), as32(lam_ch)
    checks = [("lam_cr", lam_cr, (Nn, n)), ("lam_ch", lam_ch, (S, L, n))]
    checks += [(k, data_ch[k], sh) for k, sh in ck.chain_data_shapes(S, L, n, nu).items()]
    checks += [(k, data_cr[k], sh) for k, sh in ckr.crown_data_shapes(Nn, n, nu).items()]
    iterate = mode == "iter"
    if iterate:
        res_cr, res_ch = as32(state["res_cr"]), as32(state["res_ch"])
        checks += [("res_cr", res_cr, (Nn, n)), ("res_ch", res_ch, (S, L, n))]
        checks += [(k, fact[k], sh) for k, sh in (
            ("Ls", (S, L, n, n)), ("CUs", (S, L, n, n)), ("CholW", (NpG, G, G)),
            ("CholUt", (NpG, n, G)), ("s_node", (Nn, n)), ("sc", (S, L, n)))]
    for arg, t, shape in checks:
        _build.require(name, arg, t, shape, dev)
    if stamps is not None:
        _build.require(name, "stamps", stamps, (8, 20), dev, torch.int64)
    if not (n == sched.nxm and 0 < n <= 16 and nu > 0 and S == len(root_ids)
            and Nn == len(prep.par)):
        raise ValueError(f"{name}: unsupported shapes S={S} n={n} nu={nu} Nn={Nn}")
    chain = lambda w: torch.empty((S, L, w), **f32)
    node = lambda w: torch.empty((Nn, w), **f32)
    out = dict(dcr=node(n), dch=chain(n), lam2_cr=node(n), lam2_ch=chain(n),
               x=chain(n), u=chain(nu), qt=chain(n), rt=chain(nu), xUnc=chain(n),
               uUnc=chain(nu), res2_ch=chain(n), fs=torch.empty((S,), **f32),
               errs=torch.empty((S,), **f32),
               cx=node(n), cu=node(nu), qtilde=node(n), rtilde=node(nu),
               cxUnc=node(n), cuUnc=node(nu), res2_cr=node(n),
               fc=torch.empty((Nn,), **f32), errc=torch.empty((Nn,), **f32),
               dots=torch.empty((S,), **f32), dotc=torch.empty((Nn,), **f32))
    grp = lambda: torch.empty((NpG, G), **f32) if iterate else None
    scratch = [grp(), grp(), grp(), chain(n) if iterate else None,
               chain(n) if iterate else None, node(nz), node(nz),
               torch.empty((4, S, L), **f32), stamps]
    t = iter_sched(prep, root_ids, dev)
    fact_ptrs = ([fact[k] for k in ("Ls", "CUs", "CholW", "CholUt", "s_node", "sc")]
                 if iterate else [None] * 6)
    operands = ([data_ch[k] for k in ck.CHAIN_DATA_KEYS]
                + [data_cr[k] for k in ckr.CROWN_DATA_KEYS]
                + [t[k] for k in ("par", "kid_ptr", "kid_idx")] + fact_ptrs
                + [t[k] for k in ("lev_ptr", "lev_child", "lev_parent", "lev_slot", "g_of",
                                  "slot", "rid", "kidsP", "group_of_node", "slot_of_node")]
                + [lam_cr, lam_ch] + ([res_cr, res_ch] if iterate else [None, None])
                + [out[k] for k in ("dcr", "dch", "lam2_cr", "lam2_ch",
                                    "x", "u", "qt", "rt", "xUnc", "uUnc", "res2_ch", "fs",
                                    "errs", "cx", "cu", "qtilde", "rtilde", "cxUnc", "cuUnc",
                                    "res2_cr", "fc", "errc", "dots", "dotc")]
                + scratch)
    dims = _build.int_array([S, L, n, nu, Nn, NpG, K, sched.n_lev, 0 if iterate else 1])
    return out, _build.ptr_array(operands), dims, operands


def newton_iter(data_ch, data_cr, fact, state, prep, root_ids, mode="iter"):
    """One fused coarse-phase Newton iteration (the tau = 1 trial).

    data_ch / data_cr: ``chain_kernels.chain_eval_data`` /
    ``crown_kernels.crown_eval_data``. fact: dict(Ls, CUs [S, L, n, n],
    CholW [NpG, G, G], CholUt [NpG, n, G], s_node [Nn, n], sc [S, L, n]),
    the stored f32 factors and Jacobi scales of ``_ms_factorize``. state:
    dict(lam_cr [Nn, n] (masked by nrxm), lam_ch [S, L, n], res_cr, res_ch
    of the same shapes, the residuals at lam).

    mode "iter": solve for the Newton direction, step to lam2 = lam + d and
    evaluate there. mode "eval": lam IS the trial point; only the
    evaluation runs, and ``fact`` and the residuals are not read (may be
    None) — the building block of the line search.

    Returns dict(dcr, dch, lam2_cr, lam2_ch; res2_cr, res2_ch the residuals
    at lam2; qt, rt, x, u, xUnc, uUnc of the chains and qtilde, rtilde, cx,
    cu, cxUnc, cuUnc of the crown at lam2; f1p, dotp, errp the (per-chain
    [S], per-node [Nn]) partials of the dual value at lam2, of the
    directional derivative -res' d and of the residual inf-norm). All f32;
    the caller reduces the partials.
    """
    if state["lam_ch"].device.type == "cpu":
        return newton_iter_ref(data_ch, data_cr, fact, state, prep, root_ids, mode)
    out, ptrs, dims, _keep = launch_args(data_ch, data_cr, fact, state, prep, root_ids, mode)
    err = _build.lib().tq_newton_iter(ptrs, dims, _build.stream(state["lam_ch"].device))
    _build.check(err, "newton_iter")
    newton_iter.launches += 1
    out["f1p"] = (out.pop("fs"), out.pop("fc"))
    out["dotp"] = (out.pop("dots"), out.pop("dotc"))
    out["errp"] = (out.pop("errs"), out.pop("errc"))
    return out


newton_iter.launches = 0

"""Whole-system Newton solve for the multistage dual Hessian.

Port of ``ms_sched`` and ``system_solve`` in
``treeqp_tpu/ops/system_kernels.py``: chain backward sweeps -> crown tree
solve -> chain forward sweeps, with the chain factors of
``chain_kernels.chain_blocks_factor`` and the crown factors of
``crown_kernels.crown_blocks_factor``. ``system_solve`` launches the CUDA
kernel of ``csrc/system_solve.cu`` on CUDA tensors and runs the plain
PyTorch twin ``system_solve_ref`` on CPU tensors; both are f32. The
scenario <-> crown-group moves use index lists (``ms_sched``) instead of
the TPU kernel's one-hot injection matrices.

The kernel runs on one cluster of 8 thread blocks (8 SMs), the body of
``newton_iter``'s step 2 (``csrc/tq_system.cuh``): the chain sweeps on lane
groups, 8 or 16 lanes a chain with the factor blocks streamed through a
shared-memory ring, the crown's levels a warp a group (G <= 32; wider
groups one thread a group in block 0), the cluster's barrier between
phases and levels. It is bound by latency, the dependent steps of the
sweeps and of the crown's levels, not by its ~1 MB of operands; it gives
the one-block kernel's results bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from treeqp_tpu_torch.ops import _build
from treeqp_tpu_torch.ops.chain_kernels import chain_forward_ref, chain_solve_bwd_ref
from treeqp_tpu_torch.ops.crown_kernels import _get_sched, crown_solve_ref, crown_supported

__all__ = ["ms_sched", "system_supported", "system_solve", "system_solve_ref"]


def ms_sched(prep, root_ids, device) -> dict:
    """Crown group and kid slot of each chain root (scenario order), as
    int32 tensors on ``device``: chain s injects into / reads from
    ``[g_of[s], slot[s]*n : (slot[s]+1)*n]`` of the group layout.
    Cached on the prep object."""
    cache = prep.__dict__.setdefault("_ms_sys_sched", {})
    key = (tuple(root_ids), torch.device(device))
    hit = cache.get(key)
    if hit is None:
        rid = np.asarray(root_ids)
        hit = {k: torch.as_tensor(v[rid], dtype=torch.int32, device=device)
               for k, v in (("g_of", prep.group_of_node),
                            ("slot", prep.slot_of_node))}
        cache[key] = hit
    return hit


def system_supported(prep, meta, opts) -> bool:
    """The fused system solve applies on top of crown_supported: uniform
    chain/crown state dims (split_multistage guarantees it)."""
    return (crown_supported(prep, opts) and meta.nx == prep.nxm
            and prep.G == prep.K * prep.nxm)


def system_solve_ref(Ls, CUs, CholW, CholUt, rg, rch, prep, root_ids):
    """Plain PyTorch twin of the kernel (see ``system_solve``): the chain
    backward sweeps, the crown solve and the chain forward sweeps of
    ``chain_kernels`` / ``crown_kernels``, joined at the chain roots."""
    sched = _get_sched(prep)
    NpG, K, n = sched.NpG, sched.K, sched.nxm
    ids = {k: v.long() for k, v in ms_sched(prep, root_ids, Ls.device).items()}
    ys, radd = chain_solve_bwd_ref(Ls, CUs, rch.to(Ls.dtype))
    # inject into the crown groups (one chain per (group, slot))
    rv = rg.to(Ls.dtype).clone()
    rv.view(NpG, K, n)[ids["g_of"], ids["slot"]] -= radd
    dg = crown_solve_ref(CholW, CholUt, rv, prep)
    dp = dg.view(NpG, K, n)[ids["g_of"], ids["slot"]]
    return dg, chain_forward_ref(Ls, CUs, ys, dp)


def system_solve(Ls, CUs, CholW, CholUt, rg, rch, prep, root_ids):
    """Solve the full crown+chain Newton system with stored factors.

    Ls/CUs [S, L, n, n] chain factors; CholW [NpG, G, G] / CholUt
    [NpG, n, G] crown factors; rg [NpG, G] crown right-hand side (group
    layout, equilibrated); rch [S, L, n] chain right-hand side
    (equilibrated); root_ids the crown node ids of the chain roots in
    scenario order. The right-hand sides are cast to f32. Returns
    (dg [NpG, G], dch [S, L, n]) in f32.
    """
    if Ls.device.type == "cpu":
        return system_solve_ref(Ls, CUs, CholW, CholUt, rg, rch, prep, root_ids)
    name = "system_solve"
    sched = _get_sched(prep)
    S, L, n, _ = Ls.shape
    NpG, G, K = sched.NpG, sched.G, sched.K
    dev = Ls.device
    rg = rg.to(torch.float32).contiguous()
    rch = rch.to(torch.float32).contiguous()
    for arg, t, shape in (("Ls", Ls, (S, L, n, n)), ("CUs", CUs, (S, L, n, n)),
                          ("CholW", CholW, (NpG, G, G)),
                          ("CholUt", CholUt, (NpG, n, G)),
                          ("rg", rg, (NpG, G)), ("rch", rch, (S, L, n))):
        _build.require(name, arg, t, shape, dev)
    if not (n == sched.nxm and 0 < n <= 16 and S == len(root_ids) and S > 0):
        raise ValueError(f"{name}: unsupported shapes S={S} n={n} nxm={sched.nxm}")
    f32 = dict(dtype=torch.float32, device=dev)
    rv = torch.empty((NpG, G), **f32)
    ycr = torch.empty((NpG, G), **f32)
    dg = torch.empty((NpG, G), **f32)
    dch = torch.empty((S, L, n), **f32)
    t = sched.on(dev)
    ids = ms_sched(prep, root_ids, dev)
    err = _build.lib().tq_system_solve(
        Ls.data_ptr(), CUs.data_ptr(), CholW.data_ptr(), CholUt.data_ptr(),
        rg.data_ptr(), rch.data_ptr(), t["lev_ptr"].data_ptr(),
        t["lev_child"].data_ptr(), t["lev_parent"].data_ptr(),
        t["lev_slot"].data_ptr(), ids["g_of"].data_ptr(),
        ids["slot"].data_ptr(), rv.data_ptr(), ycr.data_ptr(), dg.data_ptr(),
        dch.data_ptr(), S, L, n, NpG, K, sched.n_lev, _build.stream(dev))
    _build.check(err, name)
    system_solve.launches += 1
    return dg, dch


system_solve.launches = 0

"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` (all at once, in
parallel) and linked into ONE shared library with a plain C interface, on
first use, into ``build/treeqp_tpu_torch/`` at the repository root, and
bound with ``ctypes``. No PyTorch header is included, so a build takes
seconds instead of the minutes of ``torch.utils.cpp_extension.load``. The library's file name carries a hash
of the sources and flags: an edited source gets a fresh build, an
unchanged one is loaded as it is.

Each exported function launches one kernel on the CUDA stream it is given
and returns the ``cudaGetLastError()`` code of that launch (0 = launched).
Kernels with many operands take them as one host array of device pointers
(``ptr_array``), in the order their ``extern "C"`` comment lists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["lib", "build", "check", "require", "stream", "ptr_array", "int_array"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "treeqp_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_long
# C signatures: every pointer and the stream as c_void_p, or ctypes would
# pass them as 32-bit ints and cut them
_SIGNATURES = {
    # ABt, ztp, qtc, s_root, Ls, CUs, schur0, sc, S, L, nx, nz, stream
    "tq_chain_blocks_factor": [_P] * 8 + [_I] * 4 + [_P],
    # ABt, qt, rt, ztp_root, s_root, Ls, CUs, schur0, sc, S, L, nx, nz, stream
    "tq_chain_blocks_factor_lanes": [_P] * 9 + [_I] * 4 + [_P],
    # pointers, S, L, nx, nu, stream
    "tq_chain_eval": [_P] + [_I] * 4 + [_P],
    # pointers, Nn, nx, nu, threads, stream
    "tq_crown_eval": [_P] + [_I] * 4 + [_P],
    # pointers, dims, stream
    "tq_newton_iter": [_P] * 3,
    # ABk, ztp, dvals, sW, sUt, Wadd, lev_ptr, lev_child, lev_parent,
    # lev_slot, CholW, CholUt, NpG, K, nxm, nz, n_lev, reg, threads, stream
    "tq_crown_blocks_factor": [_P] * 12 + [_I] * 5 + [_F, _I, _P],
    # Ls, CUs, CholW, CholUt, rg, rch, lev_ptr, lev_child, lev_parent,
    # lev_slot, g_of, slot, rv, ycr, dg, dch, S, L, n, NpG, K, n_lev,
    # threads, stream
    "tq_system_solve": [_P] * 16 + [_I] * 7 + [_P],
    # the f64 kernels of the high-precision phase
    # pointers, S, L, nx, nu, stream
    "tq_chain_eval_df": [_P] + [_I] * 4 + [_P],
    # pointers, Nn, nx, nu, threads, stream
    "tq_crown_eval_df": [_P] + [_I] * 4 + [_P],
    # ABt, qt, rt, d, xl, ul, res, cqr, S, L, nx, nu, stream
    "tq_chain_apply_df": [_P] * 8 + [_I] * 4 + [_P],
    # pointers, Nn, nx, nu, threads, stream
    "tq_crown_apply_df": [_P] + [_I] * 4 + [_P],
    # x, n, m, buf, out, stream
    "tq_df_reduce": [_P, _L, _L, _P, _P, _P],
    # the tree Cholesky of the generic-tree solver
    # Wc, Utc, Ls, CUs, schur0, S, L, n, stream
    "tq_chain_factor": [_P] * 5 + [_I] * 3 + [_P],
    # Ls, CUs, res, ys, radd0, S, L, n, stream
    "tq_chain_solve_bwd": [_P] * 5 + [_I] * 3 + [_P],
    # Ls, CUs, ys, droot, dls, S, L, n, stream
    "tq_chain_forward": [_P] * 5 + [_I] * 3 + [_P],
    # W, Ut, lev_ptr, lev_child, lev_parent, lev_slot, CholW, CholUt, NpG,
    # K, nxm, n_lev, reg, threads, stream
    "tq_crown_factor": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
    # CholW, CholUt, rg, lev_ptr, lev_child, lev_parent, lev_slot, rv, ycr,
    # dg, NpG, K, nxm, n_lev, threads, stream
    "tq_crown_solve": [_P] * 10 + [_I] * 5 + [_P],
    # the general stage QPs' ADMM identification, f32 and f64
    # G, L, rho, lo, hi, h, z0, lm, N, ng, nz, iters, stream
    "tq_admm_identify_f32": [_P] * 8 + [_I] * 4 + [_P],
    "tq_admm_identify_f64": [_P] * 8 + [_I] * 4 + [_P],
    # the IPM's Riccati recursions
    # hbar, AB, P, Lu, K, Mxu, W0, S, L, nx, nz, dense, reg, stream
    "tq_ric_chain_factor": [_P] * 7 + [_I] * 5 + [_F, _P],
    # pointers, S, L, nx, nz, stream
    "tq_ric_chain_bwd": [_P] + [_I] * 4 + [_P],
    "tq_ric_chain_fwd": [_P] + [_I] * 4 + [_P],
    # pointers, Nc, nx, nz, n_lev, reg, threads, stream
    "tq_crown_ric_factor": [_P] + [_I] * 4 + [_F, _I, _P],
    # pointers, Nc, nx, nz, n_lev, threads, stream
    "tq_crown_ric_solve": [_P] + [_I] * 5 + [_P],
    # sdunes: the banded per-scenario solve and the Jay cyclic reduction
    # Ls, CUs, rhs, z, S, L, n, m, stream
    "tq_chain_full_solve_mat": [_P] * 4 + [_I] * 4 + [_P],
    # diag, off, rhs, shift, x, D, C, r, Z1s, Z2s, zrs, P, b, reg_tol, stream
    "tq_jay_cr_solve": [_P] * 11 + [_I] * 2 + [_F, _P],
    # the cyclic-reduction variants of the chain sweeps
    # Ls, CUs, Abwd, Bfwd, S, L, n, stream
    "tq_chain_cr_precompute": [_P] * 4 + [_I] * 3 + [_P],
    # Ls, CUs, Abwd, res, ys, radd0, scratch, S, L, n, stream
    "tq_chain_solve_bwd_cr": [_P] * 7 + [_I] * 3 + [_P],
    # Ls, Bfwd, ys, droot, dls, scratch, S, L, n, stream
    "tq_chain_forward_cr": [_P] * 6 + [_I] * 3 + [_P],
}

_LIB = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels if this source set has no library yet; return
    the library's path. nvcc's ptxas report (registers, spills per kernel)
    is kept beside it as ``<lib>.ptxas.txt``."""
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = _BUILD_DIR / f"libtreeqp_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [_BUILD_DIR / f"{tag}.{p.stem}.o" for p in cus]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-I", str(_CSRC),
                               "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p, o in zip(cus, objs)]
    reports, failed = [], []
    for p, proc in zip(cus, procs):
        report = proc.communicate()[1]
        reports.append(report)
        if proc.returncode != 0:
            failed.append(f"{p.name} ({proc.returncode}):\n{report}")
    tmp = out.with_name(f"{tag}.tmp.so")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        res = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o", str(tmp),
                              *[str(o) for o in objs]], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_name(out.name + ".ptxas.txt").write_text("".join(reports))
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The bound kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require(name: str, arg: str, t, shape, device, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on the CUDA ``device`` — what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {arg} must be a tensor")
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")


def ptr_array(tensors):
    """Host array of the tensors' device pointers (None -> NULL), for the
    kernels that take their operands as one pointer list. Keep it alive
    until the launch returns."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def int_array(values):
    """Host array of C ints."""
    return (ctypes.c_int * len(values))(*values)


def stream(device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream

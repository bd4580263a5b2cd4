"""ctypes bindings for the native host runtime (libtreeqp_host).

Port of ``treeqp_tpu/utils/native.py``. The port keeps its own copy of the
C++ source (``interfaces/cpp/treeqp_host.cpp``); on first use in a process
this module runs that directory's Makefile (target ``host``, which builds
only what is out of date) into ``build/treeqp_tpu_torch/`` at the
repository root and loads the library it built. A file lock around the
build and the load keeps concurrent first uses from loading a library that
another process is still writing. Every entry point returns None when the
library cannot be built or loaded, and its callers fall back to Python, so
the package works without a compiler. The library constructs tree graphs
and packs arrays on the host: no device work.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "build_topology", "multistage_nk", "pack_colmajor"]

_DIR = Path(__file__).resolve().parents[1] / "interfaces" / "cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "treeqp_tpu_torch"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(_BUILD_DIR / ".host.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", str(_DIR), f"BUILD={_BUILD_DIR}", "host"],
                           check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(str(_BUILD_DIR / "libtreeqp_host.so"))
    except (OSError, subprocess.SubprocessError):
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.tqp_build_topology.restype = ctypes.c_int
    lib.tqp_build_topology.argtypes = [i32p, ctypes.c_int32, i32p, i32p, i32p, i32p]
    lib.tqp_multistage_nk.restype = ctypes.c_int64
    lib.tqp_multistage_nk.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int32, i32p]
    lib.tqp_stage_counts.restype = ctypes.c_int32
    lib.tqp_stage_counts.argtypes = [i32p, ctypes.c_int32, i32p, ctypes.c_int32]
    lib.tqp_pack_colmajor.restype = None
    lib.tqp_pack_colmajor.argtypes = [f64p, i64p, i32p, i32p, ctypes.c_int32,
                                      ctypes.c_int32, ctypes.c_int32, f64p]
    lib.tqp_unpack_colmajor.restype = None
    lib.tqp_unpack_colmajor.argtypes = lib.tqp_pack_colmajor.argtypes
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def build_topology(nk) -> tuple:
    """(parent, stage, sib_index, nkids) from children counts; None if the
    native library is unavailable (caller falls back to Python)."""
    lib = _load()
    if lib is None:
        return None
    nk = np.ascontiguousarray(nk, dtype=np.int32)
    nn = len(nk)
    parent = np.empty(nn, np.int32)
    stage = np.empty(nn, np.int32)
    sib = np.empty(nn, np.int32)
    nkids = np.empty(nn, np.int32)
    rc = lib.tqp_build_topology(_ptr(nk, ctypes.c_int32), nn,
                                _ptr(parent, ctypes.c_int32),
                                _ptr(stage, ctypes.c_int32),
                                _ptr(sib, ctypes.c_int32),
                                _ptr(nkids, ctypes.c_int32))
    if rc != 0:
        raise ValueError("inconsistent nk vector")
    return parent, stage, sib, nkids


def multistage_nk(md: int, Nr: int, Nh: int, nn: int):
    """Children counts of the multistage tree (setup_multistage_tree); None
    if the native library is unavailable. ``nn`` is its node count."""
    lib = _load()
    if lib is None:
        return None
    nk = np.empty(nn, np.int32)
    n = lib.tqp_multistage_nk(md, Nr, Nh, _ptr(nk, ctypes.c_int32))
    if n != nn:
        raise ValueError(f"multistage_nk: the tree has {n} nodes, not {nn}")
    return nk


def pack_colmajor(blocks: list, rows, cols, rmax: int, cmax: int):
    """Pack per-node column-major blocks into [nn, rmax, cmax] zero-padded.

    ``blocks`` — list of 1-D f64 arrays (column-major data per node).
    Falls back to None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    nn = len(blocks)
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    sizes = (rows.astype(np.int64) * cols.astype(np.int64))
    if (rows > rmax).any() or (cols > cmax).any():
        raise ValueError("pack_colmajor: a block exceeds (rmax, cmax)")
    offsets = np.zeros(nn, np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    src = (np.concatenate([np.asarray(b, np.float64).reshape(-1) for b in blocks])
           if nn else np.zeros(0))
    src = np.ascontiguousarray(src, np.float64)
    if src.size != int(sizes.sum()):
        raise ValueError("pack_colmajor: block sizes do not match rows * cols")
    dst = np.empty((nn, rmax, cmax), np.float64)
    lib.tqp_pack_colmajor(_ptr(src, ctypes.c_double), _ptr(offsets, ctypes.c_int64),
                          _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
                          nn, rmax, cmax, _ptr(dst, ctypes.c_double))
    return dst

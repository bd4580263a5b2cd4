"""Timing utilities (reference treeqp/utils/timing.{h,c} + info struct).

Port of ``treeqp_tpu/utils/timing.py``. ``SolveInfo`` mirrors
``treeqp_info_t`` (tree_qp_common.h:43-51): iteration count, status, and
the total/solver/interface time split. ``min_time_over`` implements the
reference measurement protocol — minimum wall time over NREP repetitions
(Makefile.rule:78-79, solve_qp_json.cpp:415-430), asserting deterministic
iteration counts across repeats. CUDA work is asynchronous: every device
that holds a tensor of ``fn()``'s output is synchronized before the clock
is read.
"""

from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["SolveInfo", "Timer", "min_time_over", "cuda_devices", "synchronize"]


@dataclasses.dataclass
class SolveInfo:
    """Equivalent of treeqp_info_t."""

    iter: int = 0
    status: int = 0
    total_time: float = 0.0
    solver_time: float = 0.0
    interface_time: float = 0.0


class Timer:
    """tic/toc timer (treeqp_tic/toc, timing.h:31-57)."""

    def __init__(self):
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()
        return self

    def toc(self) -> float:
        return time.perf_counter() - self._t0


def cuda_devices(out, found=None) -> set:
    """The CUDA devices of every tensor in ``out``: tensors, and tensors
    inside tuples, lists, dicts and dataclasses (e.g. a TreeQPOut)."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for v in out:
            cuda_devices(v, found)
    elif isinstance(out, dict):
        for v in out.values():
            cuda_devices(v, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            cuda_devices(getattr(out, f.name), found)
    return found


def synchronize(out):
    """Wait for the work behind ``out``'s CUDA tensors; return ``out``."""
    for dev in cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out


def min_time_over(fn, nrep: int = 5, check_deterministic=None):
    """Run ``fn`` nrep times, wait for its results, return (min_time, last_out).

    ``check_deterministic(out) -> value``: if given, asserts the extracted
    value (e.g. iteration count) is identical across repeats, as the
    reference front-end does (solve_qp_json.cpp:424-428).
    """
    best = float("inf")
    out = None
    ref_val = None
    for i in range(nrep):
        t = Timer().tic()
        out = synchronize(fn())
        best = min(best, t.toc())
        if check_deterministic is not None:
            val = check_deterministic(out)
            if ref_val is None:
                ref_val = val
            else:
                assert val == ref_val, f"non-deterministic solve: {val} != {ref_val}"
    return best, out

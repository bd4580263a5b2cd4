"""Carry problem data and solutions between numpy and the port.

``qp_from_numpy`` / ``ms_from_numpy`` / ``sqp_from_numpy`` build the
port's containers from numpy arrays, and ``qp_arrays`` / ``ms_arrays`` /
``sqp_arrays`` / ``out_to_numpy`` go the other way. Any container whose fields convert with ``np.asarray`` (the
JAX package's, or the port's on the CPU) can be read, so the same data
can be handed to both packages without this module importing either
framework's containers beyond the port's own.
"""

from __future__ import annotations

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import QP_FIELDS, OUT_FIELDS, TreeQPIn
from treeqp_tpu_torch.solvers.sdunes import SQP_FIELDS, ScenarioQP, scenario_meta
from treeqp_tpu_torch.solvers.tdunes_multistage import (
    CHAIN_FIELDS, GENERAL_FIELDS, MultistageQP, _ms_meta)
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["topo_from", "qp_arrays", "qp_from_numpy", "ms_arrays",
           "ms_from_numpy", "sqp_arrays", "sqp_from_numpy", "out_to_numpy"]


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def topo_from(topo) -> TreeStructure:
    """The port's TreeStructure of any topology with ``parent``, ``nx``,
    ``nu`` and ``nc`` sequences (e.g. the JAX package's)."""
    return TreeStructure.from_parent(topo.parent, topo.nx, topo.nu, topo.nc)


def qp_arrays(qp) -> dict:
    """{field: numpy array} of a TreeQPIn (JAX package's or the port's)."""
    return {f: _np(getattr(qp, f)) for f in QP_FIELDS}


def qp_from_numpy(arrays: dict, topo: TreeStructure, device="cuda",
                  dtype=torch.float64) -> TreeQPIn:
    """The port's TreeQPIn from ``qp_arrays``-style numpy arrays, on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    return TreeQPIn(**{f: torch.tensor(np.asarray(arrays[f]), dtype=dtype,
                                       device=device) for f in QP_FIELDS},
                    topo=topo)


def ms_arrays(ms) -> dict:
    """{field: numpy array} of a MultistageQP's chain tensors, plus
    ``"crown"``: the crown's ``qp_arrays``. The general C/D rows (C, D,
    dmin, dmax) are included when the container carries them."""
    out = {f: _np(getattr(ms, f)) for f in CHAIN_FIELDS}
    out.update({f: _np(getattr(ms, f)) for f in GENERAL_FIELDS
                if getattr(ms, f, None) is not None})
    out["crown"] = qp_arrays(ms.crown)
    return out


def ms_from_numpy(arrays: dict, topo: TreeStructure, device="cuda",
                  dtype=torch.float64) -> MultistageQP:
    """The port's MultistageQP from ``ms_arrays``-style numpy arrays of the
    multistage tree with full topology ``topo``, on ``device`` (the card
    unless the caller passes ``device="cpu"``); the general C/D rows when
    ``arrays`` has them."""
    meta = _ms_meta(topo)
    t = lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=device)
    return MultistageQP(
        crown=qp_from_numpy(arrays["crown"], meta.crown_topo, device, dtype),
        meta=meta,
        **{f: t(arrays[f]) for f in CHAIN_FIELDS + GENERAL_FIELDS
           if arrays.get(f) is not None})


def sqp_arrays(sqp) -> dict:
    """{field: numpy array} of a ScenarioQP (JAX package's or the port's)."""
    return {f: _np(getattr(sqp, f)) for f in SQP_FIELDS}


def sqp_from_numpy(arrays: dict, topo: TreeStructure, device="cuda",
                   dtype=torch.float64) -> ScenarioQP:
    """The port's ScenarioQP from ``sqp_arrays``-style numpy arrays of the
    scenario decomposition of the multistage tree ``topo``, on ``device``
    (the card unless the caller passes ``device="cpu"``)."""
    return ScenarioQP(**{f: torch.tensor(np.asarray(arrays[f]), dtype=dtype, device=device)
                         for f in SQP_FIELDS}, meta=scenario_meta(topo))


def out_to_numpy(out) -> dict:
    """{field: numpy array} of a TreeQPOut (JAX package's or the port's)."""
    return {f: _np(getattr(out, f)) for f in OUT_FIELDS}

"""Helpers to extract numeric problem data from reference data files.

Port of ``treeqp_tpu/utils/ref_data.py`` (framework-free; the port keeps
its own copy). The reference ships benchmark *instances* as code-generated
C arrays (``examples/spring_mass_utils/data.c``,
``examples/random_qp_utils/data0*.c``) and txt vectors. These parsers read
the numbers (problem data, not code) so that tests can assert parity on
the exact same instances.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["parse_c_arrays", "read_txt_vector"]

_ARR = re.compile(r"(?:double|int)\s+(\w+)\s*\[[^\]]*\]\s*=\s*\{([^}]*)\}", re.S)
_SCALAR = re.compile(r"(?:int|double)\s+(\w+)\s*=\s*([-+0-9.eE]+)\s*;")


def parse_c_arrays(path: str) -> dict:
    """Parse ``double name[] = {...};`` / ``int name = v;`` declarations."""
    with open(path) as f:
        src = f.read()
    out = {}
    for m in _SCALAR.finditer(src):
        v = float(m.group(2))
        out[m.group(1)] = int(v) if v == int(v) else v
    for m in _ARR.finditer(src):
        vals = [float(x) for x in m.group(2).replace("\n", " ").split(",") if x.strip()]
        out[m.group(1)] = np.asarray(vals)
    return out


def read_txt_vector(path: str) -> np.ndarray:
    """Read a whitespace/newline-separated vector (utils/utils.c txt format)."""
    return np.loadtxt(path).reshape(-1)

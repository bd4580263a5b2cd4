#!/usr/bin/env python3
"""Opcode counts of the kernels of a built kernel library, from its SASS.

    python3 scripts/sass_opcodes.py LIB.so NAME [NAME ...] [--dump FILE]

Runs ``cuobjdump -sass`` (CUDA_HOME/bin, default /usr/local/cuda) on LIB.so
(``build/treeqp_tpu_torch/libtreeqp_kernels_<hash>.so``, or another
checkout's under its own ``build/``) and prints, for every kernel whose
mangled name contains one of the NAMEs, how many FFMA, FMUL, FADD, DFMA,
DMUL, DADD, MUFU, SHFL, LDG, LDS, LDL and STL instructions it holds:
whether a sum's products were contracted into FMAs (FFMA / DFMA, no FMUL /
DMUL) and whether a kernel spills to local memory (LDL / STL). ``--dump``
writes those kernels' SASS to FILE. ``opcode_counts`` gives the same counts
to another script. Needs the CUDA toolkit, not a card; imports nothing of
JAX.
"""

import argparse
import collections
import os
import re
import subprocess
from pathlib import Path

OPS = ("FFMA", "FMUL", "FADD", "DFMA", "DMUL", "DADD", "MUFU", "SHFL", "LDG", "LDS", "LDL",
       "STL")


def opcode_counts(lib, names):
    """{mangled kernel name: ({opcode of OPS: count}, its SASS)} for every
    kernel of the library ``lib`` whose name contains one of ``names``."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if not any(n in name for n in names):
            continue
        ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block))
        out[name] = ({k: ops[k] for k in OPS if ops[k]}, "Function : " + block)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("lib")
    ap.add_argument("names", nargs="+")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    found = opcode_counts(args.lib, args.names)
    for name, (ops, _) in found.items():
        print(name, ops)
    if args.dump:
        Path(args.dump).write_text("\n".join(sass for _, sass in found.values()))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Seconds each kernel source takes to compile, as the port's build runs
them: every ``csrc/*.cu`` by its own ``nvcc`` with ``_build.NVCC_FLAGS``,
all started together (``treeqp_tpu_torch/ops/_build.py``).

    python3 scripts/time_torch_build.py [--csrc DIR ...] [--only a.cu,b.cu]

Each DIR is a ``csrc`` directory (default: this checkout's), for example
the parent commit's from a ``git archive`` under ``build/``; the DIRs are
built one after the other, in the order given, each into a fresh
temporary directory that is removed afterwards (nothing is linked or
kept). ``--only`` compiles just the named files (together). For each
DIR, one line: the wall seconds of the whole set, then each file's
seconds from the common start to its end, slowest first; on the last
line, one JSON object with the same. Needs ``nvcc`` (CUDA_HOME or PATH);
prints the card's name and power limit where ``nvidia-smi`` answers.
Exits non-zero if a compile fails.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from treeqp_tpu_torch.ops import _build  # noqa: E402


def time_set(csrc: Path, only: list[str]) -> dict:
    """{file: seconds from the common start to its nvcc's end} and the
    set's wall seconds, every file of ``csrc`` compiled at once."""
    cus = sorted(csrc.glob("*.cu"))
    if only:
        cus = [p for p in cus if p.name in only]
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR.parent) as tmp:
        t0 = time.perf_counter()
        logs = {p.name: open(Path(tmp) / f"{p.stem}.log", "w") for p in cus}
        procs = {p.name: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-I", str(csrc), "-o",
             str(Path(tmp) / f"{p.stem}.o"), str(p)],
            stdout=subprocess.DEVNULL, stderr=logs[p.name]) for p in cus}
        done, errs = {}, {}
        while len(done) < len(procs):
            for name, proc in procs.items():
                if name not in done and proc.poll() is not None:
                    done[name] = time.perf_counter() - t0
                    logs[name].close()
                    if proc.returncode != 0:
                        errs[name] = (Path(tmp) / f"{Path(name).stem}.log").read_text()[-2000:]
            time.sleep(0.05)
    if errs:
        raise RuntimeError(f"nvcc failed in {csrc}: {errs}")
    return {"csrc": str(csrc), "wall_s": max(done.values()),
            "files": dict(sorted(done.items(), key=lambda kv: -kv[1]))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", type=Path,
                    help="a csrc directory to build (repeatable; default this checkout's)")
    ap.add_argument("--only", default="", help="comma-separated .cu names to compile")
    args = ap.parse_args()
    if shutil.which("nvidia-smi"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip())
    _build._BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    only = [s for s in args.only.split(",") if s]
    runs = []
    for csrc in args.csrc or [_build._CSRC]:
        r = time_set(csrc.resolve(), only)
        runs.append(r)
        print(f"{r['csrc']}: {r['wall_s']:.1f} s; "
              + ", ".join(f"{n} {s:.1f}" for n, s in r["files"].items()), flush=True)
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main()

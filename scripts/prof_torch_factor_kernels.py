#!/usr/bin/env python3
"""The factor kernels ``chain_blocks_factor``, ``chain_blocks_factor_lanes``
(``csrc/chain_blocks_factor.cu``) and ``admm_identify``
(``csrc/admm_identify.cu``) against other checkouts', on one card.

    python3 scripts/prof_torch_factor_kernels.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name; its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build, this checkout's ``_build`` this one's ("package"). The data are
seeded by ``chip_smoke.block_operands`` and ``chip_smoke.admm_operands``.
Shapes: the headlines (the quadcopter's S=256 chains of L=16, nx=6, nz=10;
the general C/D tree's N=4437 stage QPs, ng=10, nz=9, 100 iterations, f32
and f64) and the kernels' edges (``chip_smoke.BLOCK_EDGES``,
``ADMM_EDGES``; the widest in f64 too).

For every library and shape: ms a launch on the card alone (20 launches in
a CUDA graph, ``chip_smoke.graph_ms``) and of one launch timed alone (the
median of REPS, ``chip_smoke.cuda_ms``; the C function called directly,
outputs allocated beforehand); the largest difference from the plain twin
(held to ``chip_smoke.FACTOR_RTOL`` / ``ADMM_RTOL``); and whether each
other library's outputs equal the package's bit for bit (``torch.equal``).
Then, through each checkout's own Python wrappers (the other checkouts' in
a child process that imports their package), one launch timed alone of
``df_reduce_flat`` at n = 26,624 beside ``torch.sum``, of both chain block
factors and of ``admm_identify`` at the headline shapes: the wrappers'
host path. Exits non-zero if a launch fails or a result leaves its
tolerance. Needs CUDA and nvcc; imports nothing of JAX.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the headline shapes: the quadcopter's chains (S, L, nx, nz), the general
# C/D tree's stage QPs (N, ng, nz) and their ADMM iterations; the edges are
# chip_smoke's BLOCK_EDGES and ADMM_EDGES
BLOCK_HEADLINE = (256, 16, 6, 10)
ADMM_HEADLINE = (4437, 10, 9)
ADMM_ITERS = 100
REDUCE_N = 26624


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound
    by that checkout's own ``_build``."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib()


def wrapper_times(parent):
    """One launch timed alone through the wrappers of the package imported
    from ``parent`` (this checkout when None), with torch.sum beside
    df_reduce_flat: printed, one line each."""
    if parent is not None:
        sys.path.insert(0, str(Path(parent).resolve()))
    import numpy as np
    import torch
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import df_reduce as dr
    from treeqp_tpu_torch.ops import qpgen_lanes as ql
    sys.path.insert(0, str(ROOT))
    from chip_smoke import admm_operands, block_operands, cuda_ms
    from prof_common import card
    name = "package" if parent is None else Path(parent).resolve().name
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(18)
    x = torch.tensor(rng.standard_normal(REDUCE_N), dtype=torch.float64, device=dev)
    stacked, lanes = block_operands(torch, *BLOCK_HEADLINE, 1, dev)
    a32 = admm_operands(torch, *ADMM_HEADLINE, torch.float32, 3, dev)
    rows = (("df_reduce_flat", lambda: dr.df_reduce_flat(x)),
            ("torch.sum", lambda: torch.sum(x)),
            ("chain_blocks_factor", lambda: ck.chain_blocks_factor(*stacked)),
            ("chain_blocks_factor_lanes", lambda: ck.chain_blocks_factor_lanes(*lanes)),
            ("admm_identify", lambda: ql.admm_identify(*a32, ADMM_ITERS)))
    for timed_pass in (False, True):  # the first pass warms the card and the host path
        for what, fn in rows:
            t = cuda_ms(torch, fn, 50)
            if timed_pass:
                print(f"wrapper {what} ({name}): one launch timed alone {t:.4f} ms (host path "
                      f"included) on {card()}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", action="append", default=[],
                    help="another checkout of the repository to compare with (repeatable)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--wrappers-of", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.wrappers_of is not None:
        wrapper_times(args.wrappers_of)
        return
    if not args.parent:
        ap.error("--parent DIR is required")

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_factor_kernels: needs a CUDA device")
    from chip_smoke import (ADMM_EDGES, ADMM_RTOL, BLOCK_EDGES, FACTOR_RTOL, admm_operands,
                            block_operands, cuda_ms, graph_ms)
    from prof_common import card as card_name
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import qpgen_lanes as ql
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    libs = {"package": _build.lib(), **{Path(p).name: parent_lib(p) for p in args.parent}}
    st = lambda: _build.stream(dev)  # the current stream: a graph captures on its own
    failed = []

    def check(name, what, got, ref, rtol):
        err = 0.0
        for g, r in zip(got, ref):
            if not bool(torch.isfinite(r).all()):
                sys.exit(f"{what}: the twin's result is not finite")
            e = float((g - r).abs().max())
            if not e <= rtol * max(1.0, float(r.abs().max())):
                sys.exit(f"{name} ({what}): differs from the twin by {e:.3e}")
            err = max(err, e)
        return err

    def timed(fn):
        return graph_ms(torch, fn), cuda_ms(torch, fn, args.reps)

    def compare_libs(what, launch, outputs, ref, rtol):
        """Run ``launch(lib, outs)`` for every library, hold it to the twin
        and the other libraries to the package bit for bit; print times."""
        outs = {}
        for name, lib in libs.items():
            o = outputs()

            def fn():
                _build.check(launch(lib, o), f"{name} {what}")
            fn()
            torch.cuda.synchronize()
            err = check(name, what, o, ref, rtol)
            outs[name] = [t.clone() for t in o]
            t_g, t_a = timed(fn)
            print(f"{what} {name}: {t_g:.4f} ms in a CUDA graph, {t_a:.4f} ms one launch "
                  f"timed alone, max |diff| to the twin {err:.3e} on {card}")
        for name in libs:
            if name != "package":
                same = [torch.equal(a, b) for a, b in zip(outs["package"], outs[name])]
                print(f"{what}: package bit for bit equal to {name}: {all(same)} {same}")
                if not all(same):
                    failed.append(f"{what} vs {name}")

    f32 = dict(dtype=torch.float32, device=dev)
    for k, (S, L, nx, nz) in enumerate((BLOCK_HEADLINE,) + BLOCK_EDGES):
        stacked, lanes = block_operands(torch, S, L, nx, nz, k + 1, dev)

        def outputs():
            return (torch.empty((S, L, nx, nx), **f32), torch.empty((S, L, nx, nx), **f32),
                    torch.empty((S, nx, nx), **f32), torch.empty((S, L, nx), **f32))
        tag = f"(S={S}, L={L}, nx={nx}, nz={nz})"
        compare_libs(f"chain_blocks_factor {tag}", lambda lib, o: lib.tq_chain_blocks_factor(
            *(t.data_ptr() for t in stacked), *(t.data_ptr() for t in o), S, L, nx, nz, st()),
            outputs, ck.chain_blocks_factor_ref(*stacked), FACTOR_RTOL)
        compare_libs(f"chain_blocks_factor_lanes {tag}",
                     lambda lib, o: lib.tq_chain_blocks_factor_lanes(
                         *(t.data_ptr() for t in lanes), *(t.data_ptr() for t in o),
                         S, L, nx, nz, st()),
                     outputs, ck.chain_blocks_factor_lanes_ref(*lanes), FACTOR_RTOL)

    admm_shapes = [(*ADMM_HEADLINE, torch.float32), (*ADMM_HEADLINE, torch.float64)]
    admm_shapes += [(*e, torch.float32) for e in ADMM_EDGES] + [(*ADMM_EDGES[-1], torch.float64)]
    for k, (N, ng, nz, dt) in enumerate(admm_shapes):
        a = admm_operands(torch, N, ng, nz, dt, k + 3, dev)
        entry = "tq_admm_identify_f32" if dt == torch.float32 else "tq_admm_identify_f64"
        compare_libs(f"admm_identify (N={N}, ng={ng}, nz={nz}, {str(dt)[6:]})",
                     lambda lib, o: getattr(lib, entry)(
                         *(t.data_ptr() for t in a), o[0].data_ptr(), N, ng, nz, ADMM_ITERS,
                         st()),
                     lambda: (torch.empty((N, ng), dtype=dt, device=dev),),
                     (ql.admm_identify_ref(*a, ADMM_ITERS),), ADMM_RTOL)

    sys.stdout.flush()
    wrapper_times(None)
    for p in args.parent:
        sys.stdout.flush()
        res = subprocess.run([sys.executable, __file__, "--wrappers-of", p])
        if res.returncode != 0:
            failed.append(f"wrappers of {p}")
    if failed:
        sys.exit(f"prof_torch_factor_kernels: not bit for bit or failed: {failed}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The crown factor kernels ``crown_blocks_factor`` and ``crown_factor``
(``csrc/crown_blocks_factor.cu``, ``csrc/crown_factor.cu``) against other
checkouts', on one card.

    python3 scripts/prof_torch_crown_kernels.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name; its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build, this checkout's ``_build`` this one's ("package"). A library
whose crown factor functions take a thread count (the one-block kernels)
gets one thread a group, as its wrappers gave it. The operands are seeded
by ``chip_smoke.crown_operands`` on these crowns (G = K nxm):
- the multistage crowns of quadcopter(4,4,20) (the headline: 85 groups,
  G = 24), spring_mass_chain(4,4,4,20) (sdunes' bootstrap: G = 32) and
  quadcopter(4,5,20) (341 groups), both kernels;
- the generic solver's crowns, crown_factor only: the split crown of
  quadcopter(4,4,20) pruned to 128 scenarios (81 groups) and of the
  general C/D tree spring_mass_chain(4,4,4,20) (G = 32), and the whole
  asymmetric tree (17 groups, 9 levels of at most 3);
- ``chip_smoke.CROWN_EDGES``, both kernels.

For every library, kernel and shape: ms a launch on the card alone (20
launches in a CUDA graph, ``chip_smoke.graph_ms``) and of one launch timed
alone (the median of REPS, ``chip_smoke.cuda_ms``; the C function called
directly, outputs allocated beforehand); the largest difference from the
plain twin (held to ``chip_smoke.FACTOR_RTOL``); and whether each other
library's CholW and CholUt equal the package's bit for bit
(``torch.equal``). Beside each shape, the library call that computes the
same factor: ``torch.linalg.cholesky_ex`` of the crown as one dense matrix
(``chip_smoke.crown_matrix``), in a graph and alone, with its distance to
the twin's factors. Then, through each checkout's own Python wrappers (the
other checkouts' in a child process that imports their package), one
launch timed alone of both kernels at the headline crown. Exits non-zero if
a launch fails, a result leaves its tolerance or a library differs from the
package in a bit. Needs CUDA and nvcc; imports nothing of JAX.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the multistage crowns (name, (md, Nr, nx), nz): both kernels
MS_SHAPES = (("headline", (4, 4, 6), 10), ("bootstrap", (4, 4, 8), 9),
             ("1024 scenarios", (4, 5, 6), 10))


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound
    by that checkout's own ``_build``, and whether its crown factor
    functions take (warps, warp floats) rather than a thread count."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib(), len(mod._SIGNATURES["tq_crown_factor"]) == 16


def one_block_threads(sched):
    """The one-block kernels' threads: one a group up to 1024."""
    return min(1024, max(32, -(-max(sched.NpG, sched.width) // 32) * 32))


def wrapper_times(parent):
    """One launch timed alone through the wrappers of the package imported
    from ``parent`` (this checkout when None), both kernels at the headline
    crown: printed, one line each."""
    if parent is not None:
        sys.path.insert(0, str(Path(parent).resolve()))
    import torch
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    sys.path.insert(0, str(ROOT))
    from chip_smoke import CROWN_REG, crown_operands, crown_prep, cuda_ms
    from prof_common import card
    name = "package" if parent is None else Path(parent).resolve().name
    dev = torch.device("cuda", 0)
    _, (md, Nr, nx), nz = MS_SHAPES[0]
    prep = crown_prep(md, Nr, nx)
    args, (W, Ut) = crown_operands(torch, ckr._get_sched(prep), nz, 1, dev)
    rows = (("crown_blocks_factor", lambda: ckr.crown_blocks_factor(*args, prep, reg=CROWN_REG)),
            ("crown_factor", lambda: ckr.crown_factor(W, Ut, prep, reg=CROWN_REG)))
    for timed_pass in (False, True):  # the first pass warms the card and the host path
        for what, fn in rows:
            t = cuda_ms(torch, fn, 50)
            if timed_pass:
                print(f"wrapper {what} ({name}): one launch timed alone {t:.4f} ms (host path "
                      f"included) on {card()}", flush=True)


def generic_crowns():
    """(name, prep, levels) of the generic solver's crowns: the split
    crowns of the pruned and the general C/D trees, the asymmetric tree."""
    from treeqp_tpu_torch.models import asym_tree, general_cd, pruned, quadcopter
    from treeqp_tpu_torch.solvers import tdunes as td
    out = []
    for name, q in (("pruned split crown", pruned(quadcopter(4, 4, 20, device="cpu").qp, 128)),
                    ("general C/D split crown", general_cd("qpgen", device="cpu")),
                    ("asymmetric", asym_tree(device="cpu"))):
        p = td._get_prep(q.topo)
        split = td._split_sched(p)
        out.append((name, p, None if split is None else td._split_index(p, split, "cpu")["crown"]))
    return out


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
        sys.exit("prof_torch_crown_kernels: needs a CUDA device")
    from chip_smoke import (CROWN_EDGES, CROWN_REG, FACTOR_RTOL, crown_matrix, crown_operands,
                            crown_prep, cuda_ms, graph_ms)
    from prof_common import card as card_name
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    libs = {"package": (_build.lib(), True),
            **{Path(p).name: parent_lib(p) for p in args.parent}}
    st = lambda: _build.stream(dev)  # the current stream: a graph captures on its own
    failed = []

    def check(name, what, got, ref):
        err = 0.0
        for g, r in zip(got, ref):
            if not bool(torch.isfinite(r).all()):
                sys.exit(f"{what}: the twin's result is not finite")
            e = float((g - r).abs().max())
            if not e <= FACTOR_RTOL * max(1.0, float(r.abs().max())):
                print(f"{name} ({what}): differs from the twin by {e:.3e}")
                failed.append(f"{what} {name} vs the twin")
            err = max(err, e)
        return err

    def compare_libs(what, launch, sched, ref):
        """Run ``launch(lib, new_form, outs)`` for every library, hold it to
        the twin and the other libraries to the package bit for bit; print
        times."""
        outs = {}
        for name, (lib, new_form) in libs.items():
            o = (torch.empty((sched.NpG, sched.G, sched.G), dtype=torch.float32, device=dev),
                 torch.empty((sched.NpG, sched.nxm, sched.G), dtype=torch.float32, device=dev))

            def fn():
                _build.check(launch(lib, new_form, o), f"{name} {what}")
            fn()
            torch.cuda.synchronize()
            err = check(name, what, o, ref)
            outs[name] = [t.clone() for t in o]
            t_g, t_a = graph_ms(torch, fn), cuda_ms(torch, fn, args.reps)
            print(f"{what} {name}: {t_g:.4f} ms in a CUDA graph, {t_a:.4f} ms one launch "
                  f"timed alone, max |diff| to the twin {err:.3e} on {card}", flush=True)
        for name in libs:
            if name != "package":
                same = [torch.equal(a, b) for a, b in zip(outs["package"], outs[name])]
                print(f"{what}: package bit for bit equal to {name}: {all(same)} {same}")
                if not all(same):
                    failed.append(f"{what} vs {name}")

    def library_call(what, W, Ut, sched, reg, ref):
        """cholesky_ex of the crown as one dense matrix: times and its
        distance to the twin's factors."""
        M = crown_matrix(torch, W, Ut, sched, reg=reg)
        chol = lambda: torch.linalg.cholesky_ex(M).L
        Lf, info = torch.linalg.cholesky_ex(M)
        err = float((Lf - crown_matrix(torch, *ref, sched, factor=True)).abs().max())
        print(f"{what} cholesky_ex [{M.shape[0]}, {M.shape[1]}]: {graph_ms(torch, chol):.4f} ms "
              f"in a CUDA graph, {cuda_ms(torch, chol, args.reps):.4f} ms alone, |diff| to the "
              f"twin's factors {err:.3e} (info {int(info)}) on {card}", flush=True)

    def factor_launch(sched, nz, new_form):
        return ckr._factor_launch(sched, nz) if new_form else (one_block_threads(sched),)

    def both(what, prep, levels, nz, reg, seed, zero=False, blocks=True):
        sched = ckr._get_sched(prep, levels)
        t = sched.on(dev)
        lev = [t[k].data_ptr() for k in ("lev_ptr", "lev_child", "lev_parent", "lev_slot")]
        bargs, (W, Ut) = crown_operands(torch, sched, nz, seed, dev, zero=zero)
        tag = f"({what}: NpG={sched.NpG}, G={sched.G}, {sched.n_lev} levels, reg={reg:g})"
        ref = ckr.crown_factor_ref(W, Ut, prep, reg=reg, levels=levels)
        compare_libs(f"crown_factor {tag}", lambda lib, new, o: lib.tq_crown_factor(
            W.data_ptr(), Ut.data_ptr(), *lev, o[0].data_ptr(), o[1].data_ptr(), sched.NpG,
            sched.K, sched.nxm, sched.n_lev, float(reg), *factor_launch(sched, 0, new), st()),
            sched, ref)
        if blocks:
            bref = ckr.crown_blocks_factor_ref(*bargs, prep, reg=reg)
            compare_libs(f"crown_blocks_factor {tag}", lambda lib, new, o:
                         lib.tq_crown_blocks_factor(
                             *(a.data_ptr() for a in bargs), *lev, o[0].data_ptr(),
                             o[1].data_ptr(), sched.NpG, sched.K, sched.nxm, nz, sched.n_lev,
                             float(reg), *factor_launch(sched, nz, new), st()),
                         sched, bref)
        if not zero:
            library_call(f"crown {tag}", W, Ut, sched, reg, ref)

    for k, (what, (md, Nr, nx), nz) in enumerate(MS_SHAPES):
        both(what, crown_prep(md, Nr, nx), None, nz, CROWN_REG, k)
    for k, (what, prep, levels) in enumerate(generic_crowns()):
        both(what, prep, levels, prep.nxm + 2, CROWN_REG, 10 + k, blocks=False)
    for k, (md, Nr, nx, reg, zero) in enumerate(CROWN_EDGES):
        both(f"edge md={md}, Nr={Nr}, nx={nx}" + (", a zero block" if zero else ""),
             crown_prep(md, Nr, nx), None, nx + 2, reg, 20 + k, zero=zero)

    sys.stdout.flush()
    wrapper_times(None)
    for p in args.parent:
        sys.stdout.flush()
        res = subprocess.run([sys.executable, __file__, "--wrappers-of", p])
        if res.returncode != 0:
            failed.append(f"wrappers of {p}")
    if failed:
        sys.exit(f"prof_torch_crown_kernels: not bit for bit or failed: {failed}")


if __name__ == "__main__":
    main()

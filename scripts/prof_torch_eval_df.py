#!/usr/bin/env python3
"""The high-precision phase's chain kernels ``chain_eval_df`` and
``chain_apply_df`` (``csrc/chain_eval_df.cu``, ``csrc/chain_apply_df.cu``)
against other checkouts', on one card.

    python3 scripts/prof_torch_eval_df.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name; its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build, this checkout's ``_build`` this one's ("package"). A library
whose chain kernels take no (chains, staged) pair runs them as its wrapper
did (one thread a chain). The operands:
- every call of both kernels in a cold solve of the quadcopter headline
  (quadcopter(4,4,20): S = 256 chains of L = 16, nx = 6, nu = 4) at
  ``chip_smoke.BENCH_OPTS`` (bench.py's path: its high-precision phase's
  trial points and refinement directions), captured from the wrappers;
- the first call of each in a cold solve of quadcopter(4,5,20) (S = 1024,
  L = 15);
- seeded ones (``chip_smoke.eval_df_operands``) at
  ``chip_smoke.EVAL_DF_EDGES``.

For every shape: the package's launch (``df_eval_kernels.chain_df_launch``)
and every form of the sweep, 1, 2, 4 and 8 chains a block, each with the
block's tiles staged in shared memory (where they fit) and read from
global memory; whether every form's and every other library's outputs equal
the package's launch bit for bit (``torch.equal``, every output), and the
package's launch against the plain twin (chain_eval_df bit for bit,
chain_apply_df to ``chip_smoke.DF_RTOL``). At the bench path's first point
and quadcopter(4,5,20)'s, every form and library is timed in a CUDA graph
(20 launches, ``chip_smoke.graph_ms``) and one C call alone (the median of
REPS, ``chip_smoke.cuda_ms``; outputs allocated beforehand). Also: both
kernels' launches in a cold and a warm bench solve; the FP64 opcodes of
each library's kernels (``scripts/sass_opcodes.py``: the package's must
hold no DFMA); and, through each checkout's own Python wrappers (the other
checkouts' in a child process that imports their package), one call of each
kernel timed alone and in a graph on seeded operands at S = 256, L = 16 and
S = 1024, L = 15. Exits non-zero if a launch fails, a result leaves its
tolerance, a bit differs or the package's SASS holds a DFMA. Needs CUDA and
nvcc; imports nothing of JAX.
"""

import argparse
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SWEEP = (1, 2, 4, 8)
# the wrappers' seeded shapes (S, L, nx, nu): the bench path's, quadcopter(4,5,20)'s
WRAPPER_SHAPES = ((256, 16, 6, 4), (1024, 15, 6, 4))
EVAL_KEYS = ("x", "u", "qt", "rt", "xUnc", "uUnc", "res_part", "fch", "cqr")
APPLY_KEYS = ("xl", "ul", "res_part", "cqr")
KERNEL_NAMES = ("chain_eval_df_kernel", "chain_apply_df_kernel", "chain_eval_kernelId")


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound by
    that checkout's own ``_build``; whether its chain kernels take (chains,
    staged); the library's path."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib(), len(mod._SIGNATURES["tq_chain_eval_df"]) == 8, mod.build()


def wrapper_times(parent):
    """One call of each kernel through the wrappers of the package imported
    from ``parent`` (this checkout when None), timed alone and in a CUDA
    graph on seeded operands at WRAPPER_SHAPES; printed, one line each."""
    if parent is not None:
        sys.path.insert(0, str(Path(parent).resolve()))
    import torch
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import cuda_ms, eval_df_operands, graph_ms
    from prof_common import card
    name = "package" if parent is None else Path(parent).resolve().name
    dev = torch.device("cuda", 0)
    rows = []
    for S, L, nx, nu in WRAPPER_SHAPES:
        data, lam, d = eval_df_operands(torch, S, L, nx, nu, 3, dev)
        ev = dek.chain_eval_df_ref(data, lam)
        rows += [(f"chain_eval_df (S={S}, L={L})", lambda a=(data, lam): dek.chain_eval_df(*a)),
                 (f"chain_apply_df (S={S}, L={L})",
                  lambda a=(data, ev["qt"], ev["rt"], d): dek.chain_apply_df(*a))]
    for timed_pass in (False, True):  # the first pass warms the card and the host path
        for what, fn in rows:
            t, g = cuda_ms(torch, fn, 50), graph_ms(torch, fn)
            if timed_pass:
                print(f"wrapper {what} ({name}): one call timed alone {t:.4f} ms (host path "
                      f"included), {g:.4f} ms in a CUDA graph on {card()}", flush=True)


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
        sys.exit("prof_torch_eval_df: needs a CUDA device")
    from chip_smoke import (BENCH_OPTS, DF_RTOL, EVAL_DF_EDGES, cuda_ms, eval_df_operands,
                            graph_ms)
    from prof_common import capture, card as card_name
    from sass_opcodes import opcode_counts
    import treeqp_tpu_torch  # noqa: F401  (pins full-precision f32)
    from treeqp_tpu_torch.models import quadcopter
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    libs = {"package": (_build.lib(), True, _build.build()),
            **{Path(p).name: parent_lib(p) for p in args.parent}}
    st = lambda: _build.stream(dev)  # the current stream: a graph captures on its own
    f64 = dict(dtype=torch.float64, device=dev)
    failed = []

    def forms(S, L, nx, nu, apply):
        """(name, lib, launch ints) of every library's launch, then the
        package's sweep: each chain count of SWEEP, staged (where the tiles
        fit) and direct."""
        out = []
        for name, (lib, new, _) in libs.items():
            C, _, _, staged, _ = dek.chain_df_launch(S, L, nx, nu, apply)
            out.append((name, lib, (C, int(staged)) if new else ()))
        pk = libs["package"][0]
        for chains in SWEEP:
            for staged in (True, False):
                C, _, _, _, smem = dek.chain_df_launch(S, L, nx, nu, apply, chains, staged)
                if C == chains and smem <= dek._BLOCK_SMEM:
                    out.append((f"package C={C} {'staged' if staged else 'direct'}", pk,
                                (C, int(staged))))
        return out

    def eval_makes(data, lam):
        S, L, nx, nz = data["ABt"].shape

        def make_with(lib, launch):
            def make():
                o = {k: torch.empty(sh, **f64) for k, sh in (
                    ("x", (S, L, nx)), ("u", (S, L, nz - nx)), ("qt", (S, L, nx)),
                    ("rt", (S, L, nz - nx)), ("xUnc", (S, L, nx)), ("uUnc", (S, L, nz - nx)),
                    ("res_part", (S, L, nx)), ("fch", (S,)), ("cqr", (S, nz)))}
                ptrs = _build.ptr_array([data[k] for k in ck.CHAIN_DATA_KEYS] + [lam]
                                        + [o[k] for k in EVAL_KEYS[:-1]] + [None, o["cqr"]])
                fn = lambda: _build.check(lib.tq_chain_eval_df(
                    ptrs, S, L, nx, nz - nx, *launch, st()), "tq_chain_eval_df")
                fn.keep = ptrs
                return fn, [o[k] for k in EVAL_KEYS]
            return make
        return {name: make_with(lib, launch)
                for name, lib, launch in forms(S, L, nx, nz - nx, False)}

    def apply_makes(data, qt, rt, d):
        S, L, nx, nz = data["ABt"].shape

        def make_with(lib, launch):
            def make():
                o = [torch.empty(sh, **f64) for sh in ((S, L, nx), (S, L, nz - nx),
                                                        (S, L, nx), (S, nz))]
                fn = lambda: _build.check(lib.tq_chain_apply_df(
                    data["ABt"].data_ptr(), qt.data_ptr(), rt.data_ptr(), d.data_ptr(),
                    *(t.data_ptr() for t in o), S, L, nx, nz - nx, *launch, st()),
                    "tq_chain_apply_df")
                return fn, o
            return make
        return {name: make_with(lib, launch)
                for name, lib, launch in forms(S, L, nx, nz - nx, True)}

    def compare_forms(what, makes, ref, rtol, timed):
        """Run every form of ``makes``; each bit for bit the package's
        launch, the package's launch within rtol * max(1, max|ref|) of the
        twin ``ref`` (rtol 0: bit for bit); time every form where
        ``timed``."""
        outs, fns = {}, {}
        for name, make in makes.items():
            fn, o = make()
            fn()
            torch.cuda.synchronize()
            outs[name], fns[name] = [t.clone() for t in o], fn
        err = 0.0
        for g, r in zip(outs["package"], ref):
            e = float((g - r).abs().max()) if g.numel() else 0.0
            bad = (not bool(torch.isfinite(g).all())
                   or e > rtol * max(1.0, float(r.abs().max()) if r.numel() else 0.0)
                   or (rtol == 0.0 and not torch.equal(g, r)))
            if bad:
                print(f"{what}: differs from the twin by {e:.3e}")
                failed.append(f"{what} vs the twin")
            err = max(err, e)
        differ = [name for name in makes if name != "package"
                  and not all(torch.equal(a, b) for a, b in zip(outs["package"], outs[name]))]
        failed.extend(f"{what}: {name}" for name in differ)
        print(f"{what}: package max |diff| to the twin {err:.3e}; {len(makes) - 1} other forms "
              f"and libraries bit for bit: {'all' if not differ else 'NOT ' + ', '.join(differ)}",
              flush=True)
        if timed:
            for name, fn in fns.items():
                g, a = graph_ms(torch, fn), cuda_ms(torch, fn, args.reps)
                print(f"{what} {name}: {g:.4f} ms in a CUDA graph, {a:.4f} ms one C call "
                      f"timed alone on {card}", flush=True)

    def case(what, data, lam, d, timed, qt_rt=None):
        """Both kernels: chain_eval_df at ``lam``, chain_apply_df on the
        direction ``d`` with the masked inverses qt_rt (default: the eval
        twin's)."""
        S, L, nx, nz = data["ABt"].shape
        tag = (f"({what}: S={S}, L={L}, nx={nx}, nu={nz - nx}; launch "
               f"{dek.chain_df_launch(S, L, nx, nz - nx)[:4]})")
        if lam is not None:
            ev = dek.chain_eval_df_ref(data, lam)
            compare_forms(f"chain_eval_df {tag}", eval_makes(data, lam),
                          [ev[k] for k in EVAL_KEYS], 0.0, timed)
            qt_rt = qt_rt or (ev["qt"], ev["rt"])
        if d is not None:
            ap_ref = dek.chain_apply_df_ref(data, *qt_rt, d)
            compare_forms(f"chain_apply_df {tag}", apply_makes(data, *qt_rt, d),
                          [ap_ref[k] for k in APPLY_KEYS], DF_RTOL, timed)

    # ---- every call of a cold bench solve, and the launches of a warm one
    opts = td.TdunesOpts(**BENCH_OPTS)
    names = ("chain_eval_df", "chain_apply_df")
    qp = quadcopter(4, 4, 20, device=dev).qp
    ms = tm.split_multistage(qp)
    got, (cro, cho, info) = capture(dek, names, lambda: tm.tdunes_ms_solve(ms, None, None, opts))
    xmin, xmax = ms.crown.xmin.clone(), ms.crown.xmax.clone()
    xmin[0] *= 1.01
    xmax[0] *= 1.01
    ms_p = dataclasses.replace(ms, crown=ms.crown.replace(xmin=xmin, xmax=xmax))
    got_w, (_, _, info_w) = capture(dek, names,
                                    lambda: tm.tdunes_ms_solve(ms_p, cro["lam"], cho["lam"], opts))
    print(f"bench path (quadcopter(4,4,20), bench options): cold solve {info['iter']} iterations "
          f"({info['iter_f32']} coarse): chain_eval_df x{len(got['chain_eval_df'])}, "
          f"chain_apply_df x{len(got['chain_apply_df'])}; warm solve (x0 scaled by 1.01) "
          f"{info_w['iter']} ({info_w['iter_f32']} coarse): chain_eval_df "
          f"x{len(got_w['chain_eval_df'])}, chain_apply_df x{len(got_w['chain_apply_df'])}",
          flush=True)
    for k, ((data, lam), _) in enumerate(got["chain_eval_df"]):
        case(f"bench path eval {k}", data, lam.double().contiguous(), None, k == 0)
    for k, ((data, qt, rt, d), _) in enumerate(got["chain_apply_df"]):
        case(f"bench path apply {k}", data, None, d.contiguous(), k == 0, (qt, rt))
    # ---- quadcopter(4,5,20)'s first f64 point
    ms5 = tm.split_multistage(quadcopter(4, 5, 20, device=dev).qp)
    got5, _ = capture(dek, names, lambda: tm.tdunes_ms_solve(ms5, None, None, opts))
    (data, lam), _ = got5["chain_eval_df"][0]
    case("quadcopter(4,5,20) eval 0", data, lam.double().contiguous(), None, True)
    (data, qt, rt, d), _ = got5["chain_apply_df"][0]
    case("quadcopter(4,5,20) apply 0", data, None, d.contiguous(), True, (qt, rt))
    # ---- the smoke's edges
    for k, (S, L, nx, nu) in enumerate(EVAL_DF_EDGES):
        data, lam, d = eval_df_operands(torch, S, L, nx, nu, 40 + k, dev)
        case("edge", data, lam, d, False)

    # ---- SASS: no DFMA in the package's two kernels
    for name, (_, _, path) in libs.items():
        for kernel, (ops, _) in opcode_counts(path, KERNEL_NAMES).items():
            print(f"SASS {name} {kernel}: {ops}")
            if name == "package" and "df_kernel" in kernel and ops.get("DFMA", 0):
                failed.append(f"DFMA in the package's {kernel}")

    sys.stdout.flush()
    wrapper_times(None)
    for p in args.parent:
        sys.stdout.flush()
        res = subprocess.run([sys.executable, __file__, "--wrappers-of", p])
        if res.returncode != 0:
            failed.append(f"wrappers of {p}")
    if failed:
        sys.exit(f"prof_torch_eval_df: not bit for bit or failed: {failed}")
    print("prof_torch_eval_df: every form and library bit for bit the package's at every shape")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The evaluation kernels ``chain_eval`` and ``crown_eval`` (f32),
``chain_eval_df``, ``chain_apply_df``, ``crown_eval_df`` and
``crown_apply_df`` (``csrc/chain_eval.cu``, ``csrc/crown_eval.cu``,
``csrc/chain_eval_df.cu``, ``csrc/chain_apply_df.cu``,
``csrc/crown_eval_df.cu``, ``csrc/crown_apply_df.cu``) against other
checkouts', on one card.

    python3 scripts/prof_torch_eval_df.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name; its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build, this checkout's ``_build`` this one's ("package"). A library
whose chain kernels take no (chains, staged) pair runs them as its wrapper
did (one thread a chain), one whose crown kernels take a thread count as
its wrapper did (one block, a thread a node: ``one_block_threads``). The
operands:
- chain_eval_df and chain_apply_df: every call of both in a cold solve of
  the quadcopter headline (quadcopter(4,4,20): S = 256 chains of L = 16,
  nx = 6, nu = 4) at ``chip_smoke.BENCH_OPTS`` (bench.py's path: its
  high-precision phase's trial points and refinement directions), captured
  from the wrappers; the first call of each in a cold solve of
  quadcopter(4,5,20) (S = 1024, L = 15); seeded ones
  (``chip_smoke.eval_df_operands``) at ``chip_smoke.EVAL_DF_EDGES``;
- chain_eval (f32): the first call of the coarse loop's per-kernel path
  on the two-norm path (quadcopter(4,4,20) at TWO_PHASE_OPTS with
  two-norm termination), on tdunes_ms_f32 (the box-only
  spring_mass_chain(4,4,4,20) in f32: S = 256, L = 16, nx = 8, nu = 1)
  and on the 1024-scenario path's two-norm solve; the seeded
  ``EVAL_DF_EDGES`` operands in f32;
- crown_eval_df and crown_apply_df: every call of both in the cold bench
  solve (the 341-node crown) and the first in quadcopter(4,5,20)'s (1365
  nodes), captured; seeded crowns (``chip_smoke.crown_eval_operands``,
  ``chip_smoke.crown_apply_operands``) at ``chip_smoke.CROWN_EVAL_EDGES``;
- crown_eval (f32): every call on the two-norm path, tdunes_ms_f32 (the
  341-node crown with nx = 8, nu = 1) and the 1024-scenario two-norm path,
  captured; the seeded ``CROWN_EVAL_EDGES`` crowns in f32.

For every shape: the package's launch (``chain_kernels.chain_node_launch``,
``crown_kernels._crown_eval_launch``) and every form of the sweep (the
chain kernels 1, 2, 4 and 8 chains a block, each with the block's tiles
staged in shared memory, where they fit, and read from global memory;
the crown kernels on one block, one cluster of 8 and one of 16); whether
every form's and every other library's outputs equal the package's launch
bit for bit (``torch.equal``, every output), and the package's launch
against the plain twin (the f64 evaluations and crown_apply_df bit for
bit, the f32 ones to ``chip_smoke.EVAL_RTOL``, chain_apply_df to
``chip_smoke.DF_RTOL``; whether each is bit for bit the twin is printed).
At the first captured point of each path every form and library is timed
in a CUDA graph (20 launches, ``chip_smoke.graph_ms``) and one C call
alone (the median of REPS, ``chip_smoke.cuda_ms``; outputs allocated
beforehand). Also: the kernels' launches in a cold and a warm bench solve
and in the f32 paths' solves; the FP32 / FP64 opcodes of each library's
evaluation kernels (``scripts/sass_opcodes.py``: the package's may hold no
DFMA, and its f32 ones no FFMA); and, through each checkout's own Python
wrappers (the other
checkouts' in a child process that imports their package), one call of
each kernel timed alone and in a graph on seeded operands. Exits non-zero
if a launch fails, a result leaves its tolerance, a bit differs or the
package's SASS holds an FFMA or DFMA. Needs CUDA and nvcc; imports nothing
of JAX.
"""

import argparse
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SWEEP = (1, 2, 4, 8)
TEAMS = (1, 8, 16)
# the wrappers' seeded shapes: the chain kernels' (S, L, nx, nu) in f64
# (the bench path's, quadcopter(4,5,20)'s) and in f32 (those and
# tdunes_ms_f32's), crown_eval_df's crowns (md, Nr, nx, nu)
WRAPPER_SHAPES = ((256, 16, 6, 4), (1024, 15, 6, 4))
WRAPPER_SHAPES_F32 = ((256, 16, 6, 4), (256, 16, 8, 1), (1024, 15, 6, 4))
WRAPPER_CROWNS = ((4, 4, 6, 4), (4, 5, 6, 4))
WRAPPER_CROWNS_F32 = ((4, 4, 6, 4), (4, 4, 8, 1), (4, 5, 6, 4))
EVAL_KEYS = ("x", "u", "qt", "rt", "xUnc", "uUnc", "res_part", "fch", "cqr")
APPLY_KEYS = ("xl", "ul", "res_part", "cqr")
CROWN_KEYS = ("x", "u", "qtilde", "rtilde", "xUnc", "uUnc", "res", "fcr")
CROWN_APPLY_KEYS = ("xl", "ul", "res")
# the evaluation kernels of either checkout: the package's chain_eval_nodes
# and crown_eval_lanes_kernel (f32 and f64) and crown_apply_df_kernel; the
# parents' chain_eval_kernel (f32), chain_eval_df_kernel, crown_eval_df_kernel,
# crown_eval_kernel (f32, f64) and crown_apply_df_kernel; chain_apply_df_kernel
KERNEL_NAMES = ("chain_eval_nodes", "crown_eval_lanes_kernel", "crown_eval_df_kernel",
                "chain_eval_kernelIf", "chain_eval_df_kernel", "crown_eval_kernelI",
                "chain_apply_df_kernel", "crown_apply_df_kernel")
# the package's kernels whose SASS may hold no FFMA (the f32 ones)
F32_KERNELS = ("chain_eval_nodesIf", "crown_eval_lanes_kernelIf")


def one_block_threads(Nn):
    """The one-block crown kernels' threads: one a node up to 1024."""
    return min(1024, max(32, -(-Nn // 32) * 32))


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound by
    that checkout's own ``_build``; which of its entries take the new
    launch ints ({entry: bool}); the library's path."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sig = mod._SIGNATURES
    new = {"tq_chain_eval": len(sig["tq_chain_eval"]) == 8,
           "tq_chain_eval_df": len(sig["tq_chain_eval_df"]) == 8,
           "tq_chain_apply_df": len(sig["tq_chain_apply_df"]) == 15,
           "tq_crown_eval_df": len(sig["tq_crown_eval_df"]) == 7,
           "tq_crown_eval": len(sig["tq_crown_eval"]) == 7,
           "tq_crown_apply_df": len(sig["tq_crown_apply_df"]) == 7}
    return mod.lib(), new, mod.build()


def wrapper_times(parent):
    """One call of each kernel through the wrappers of the package imported
    from ``parent`` (this checkout when None), timed alone and in a CUDA
    graph on seeded operands at WRAPPER_SHAPES, WRAPPER_SHAPES_F32 and
    WRAPPER_CROWNS; printed, one line each."""
    if parent is not None:
        sys.path.insert(0, str(Path(parent).resolve()))
    import torch
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import (crown_apply_operands, crown_eval_operands, cuda_ms,
                            eval_df_operands, graph_ms)
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
    for S, L, nx, nu in WRAPPER_SHAPES_F32:
        data, lam, _ = eval_df_operands(torch, S, L, nx, nu, 3, dev)
        a = ({k: v.float() for k, v in data.items()}, lam.float())
        rows.append((f"chain_eval (S={S}, L={L}, nx={nx}, nu={nu})",
                     lambda a=a: ck.chain_eval(*a)))
    for md, Nr, nx, nu in WRAPPER_CROWNS:
        a = crown_eval_operands(torch, md, Nr, nx, nu, 3, dev)
        rows.append((f"crown_eval_df ({a[0]['ABt'].shape[0]} nodes)",
                     lambda a=a: dek.crown_eval_df(*a)))
        a = crown_apply_operands(torch, md, Nr, nx, nu, 3, dev)
        rows.append((f"crown_apply_df ({a[0]['ABt'].shape[0]} nodes)",
                     lambda a=a: dek.crown_apply_df(*a)))
    for md, Nr, nx, nu in WRAPPER_CROWNS_F32:
        data, lam, extra, prep = crown_eval_operands(torch, md, Nr, nx, nu, 3, dev)
        a = ({k: v.float() for k, v in data.items()}, lam.float(), extra.float(), prep)
        rows.append((f"crown_eval ({data['ABt'].shape[0]} nodes, nx={nx}, nu={nu})",
                     lambda a=a: ckr.crown_eval(*a)))
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
    from chip_smoke import (BENCH_OPTS, CROWN_EVAL_EDGES, DF_RTOL, EVAL_DF_EDGES, EVAL_RTOL,
                            TWO_PHASE_OPTS, crown_apply_operands, crown_eval_operands,
                            cuda_ms, eval_df_operands, graph_ms)
    from prof_common import capture, card as card_name
    from sass_opcodes import opcode_counts
    import treeqp_tpu_torch  # noqa: F401  (pins full-precision f32)
    from treeqp_tpu_torch.models import SDUNES_BOOT_OPTS, quadcopter, spring_mass_chain
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    every = dict.fromkeys(("tq_chain_eval", "tq_chain_eval_df", "tq_chain_apply_df",
                           "tq_crown_eval_df", "tq_crown_eval", "tq_crown_apply_df"), True)
    libs = {"package": (_build.lib(), every, _build.build()),
            **{Path(p).name: parent_lib(p) for p in args.parent}}
    st = lambda: _build.stream(dev)  # the current stream: a graph captures on its own
    failed = []

    def chain_forms(entry, S, L, nx, nu, elem, apply):
        """(name, lib, launch ints) of every library's launch, then the
        package's sweep: each chain count of SWEEP, staged (where the tiles
        fit) and direct."""
        out = []
        for name, (lib, new, _) in libs.items():
            C, _, _, staged, _ = ck.chain_node_launch(S, L, nx, nu, elem, apply)
            out.append((name, lib, (C, int(staged)) if new[entry] else ()))
        pk = libs["package"][0]
        for chains in SWEEP:
            for staged in (True, False):
                C, _, _, _, smem = ck.chain_node_launch(S, L, nx, nu, elem, apply, chains, staged)
                if C == chains and smem <= ck._BLOCK_SMEM:
                    out.append((f"package C={C} {'staged' if staged else 'direct'}", pk,
                                (C, int(staged))))
        return out

    def eval_makes(data, lam):
        """chain_eval (f32 data) or chain_eval_df (f64) of every form."""
        S, L, nx, nz = data["ABt"].shape
        dt = data["ABt"].dtype
        entry = "tq_chain_eval" if dt == torch.float32 else "tq_chain_eval_df"
        kw = dict(dtype=dt, device=dev)

        def make_with(lib, launch):
            def make():
                o = {k: torch.empty(sh, **kw) for k, sh in (
                    ("x", (S, L, nx)), ("u", (S, L, nz - nx)), ("qt", (S, L, nx)),
                    ("rt", (S, L, nz - nx)), ("xUnc", (S, L, nx)), ("uUnc", (S, L, nz - nx)),
                    ("res_part", (S, L, nx)), ("fch", (S,)), ("cqr", (S, nz)))}
                ptrs = _build.ptr_array([data[k] for k in ck.CHAIN_DATA_KEYS] + [lam]
                                        + [o[k] for k in EVAL_KEYS[:-1]] + [None, o["cqr"]])
                fn = lambda: _build.check(getattr(lib, entry)(
                    ptrs, S, L, nx, nz - nx, *launch, st()), entry)
                fn.keep = (ptrs, o)  # the launch's outputs live as long as it
                return fn, [o[k] for k in EVAL_KEYS]
            return make
        return {name: make_with(lib, launch) for name, lib, launch in
                chain_forms(entry, S, L, nx, nz - nx, dt.itemsize, False)}

    def apply_makes(data, qt, rt, d):
        S, L, nx, nz = data["ABt"].shape
        f64 = dict(dtype=torch.float64, device=dev)

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
        return {name: make_with(lib, launch) for name, lib, launch in
                chain_forms("tq_chain_apply_df", S, L, nx, nz - nx, 8, True)}

    def crown_forms(entry, Nn, nx, nu):
        """(name, lib, launch ints) of every library's launch of the crown
        kernel ``entry``, then the package's teams of TEAMS."""
        forms = []
        for name, (lib, new, _) in libs.items():
            blocks, _, threads = ckr._crown_eval_launch(Nn, nx, nu)
            forms.append((name, lib, (blocks, threads) if new[entry]
                          else (one_block_threads(Nn),)))
        for blocks in TEAMS:
            _, _, threads = ckr._crown_eval_launch(Nn, nx, nu, blocks)
            forms.append((f"package {blocks} block{'s' if blocks > 1 else ''}",
                          libs["package"][0], (blocks, threads)))
        return forms

    def crown_makes(data, lam, extra, prep):
        """crown_eval (f32 data) or crown_eval_df (f64) of every form."""
        Nn, nx, nz = data["ABt"].shape
        dt = data["ABt"].dtype
        entry = "tq_crown_eval" if dt == torch.float32 else "tq_crown_eval_df"
        kw = dict(dtype=dt, device=dev)
        t = ckr.eval_sched(prep, dev)

        def make_with(lib, launch):
            def make():
                o = {k: torch.empty(sh, **kw) for k, sh in (
                    ("x", (Nn, nx)), ("u", (Nn, nz - nx)), ("qtilde", (Nn, nx)),
                    ("rtilde", (Nn, nz - nx)), ("xUnc", (Nn, nx)), ("uUnc", (Nn, nz - nx)),
                    ("res", (Nn, nx)), ("fcr", (Nn,)))}
                atb = torch.empty((Nn, nz), **kw)
                ptrs = _build.ptr_array(
                    [data[k] for k in ckr.CROWN_DATA_KEYS]
                    + [t["par"], t["kid_ptr"], t["kid_idx"], lam, extra, atb]
                    + [o[k] for k in CROWN_KEYS] + [None])
                fn = lambda: _build.check(getattr(lib, entry)(
                    ptrs, Nn, nx, nz - nx, *launch, st()), entry)
                fn.keep = (ptrs, atb, o)
                return fn, [o[k] for k in CROWN_KEYS]
            return make
        return {name: make_with(lib, launch)
                for name, lib, launch in crown_forms(entry, Nn, nx, nz - nx)}

    def crown_apply_makes(data, qt, rt, d, extra, prep):
        """crown_apply_df of every form."""
        Nn, nx, nz = data["ABt"].shape
        f64 = dict(dtype=torch.float64, device=dev)
        t = ckr.eval_sched(prep, dev)

        def make_with(lib, launch):
            def make():
                o = {k: torch.empty(sh, **f64) for k, sh in (
                    ("xl", (Nn, nx)), ("ul", (Nn, nz - nx)), ("res", (Nn, nx)))}
                atb = torch.empty((Nn, nz), **f64)
                ptrs = _build.ptr_array(
                    [data[k] for k in ckr.CROWN_DATA_KEYS]
                    + [t["par"], t["kid_ptr"], t["kid_idx"], qt, rt, d, extra, atb]
                    + [o[k] for k in CROWN_APPLY_KEYS])
                fn = lambda: _build.check(lib.tq_crown_apply_df(
                    ptrs, Nn, nx, nz - nx, *launch, st()), "tq_crown_apply_df")
                fn.keep = (ptrs, atb, o)
                return fn, [o[k] for k in CROWN_APPLY_KEYS]
            return make
        return {name: make_with(lib, launch) for name, lib, launch in
                crown_forms("tq_crown_apply_df", Nn, nx, nz - nx)}

    def compare_forms(what, makes, ref, rtol, timed):
        """Run every form of ``makes``; each bit for bit the package's
        launch, the package's launch within rtol * max(1, max|ref|) of the
        twin ``ref`` (rtol 0: bit for bit); time every form where
        ``timed``."""
        outs, fns = {}, {}
        for name, make in makes.items():
            fn, o = make()
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"{what} {name}: FAILED to launch: {e}")
                failed.append(f"{what}: {name} launch")
                continue
            outs[name], fns[name] = [t.clone() for t in o], fn
        if "package" not in outs:
            return
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
        differ = [name for name in outs if name != "package"
                  and not all(torch.equal(a, b) for a, b in zip(outs["package"], outs[name]))]
        failed.extend(f"{what}: {name}" for name in differ)
        twin_bits = all(torch.equal(g, r) for g, r in zip(outs["package"], ref))
        print(f"{what}: package max |diff| to the twin {err:.3e} (bit for bit the twin: "
              f"{'yes' if twin_bits else 'no'}); {len(outs) - 1} other forms and libraries bit "
              f"for bit: {'all' if not differ else 'NOT ' + ', '.join(differ)}", flush=True)
        if timed:
            for name, fn in fns.items():
                g, a = graph_ms(torch, fn), cuda_ms(torch, fn, args.reps)
                print(f"{what} {name}: {g:.4f} ms in a CUDA graph, {a:.4f} ms one C call "
                      f"timed alone on {card}", flush=True)

    def case(what, data, lam, d, timed, qt_rt=None):
        """The chain kernels: chain_eval (f32 data) or chain_eval_df at
        ``lam``, chain_apply_df on the direction ``d`` with the masked
        inverses qt_rt (default: the eval twin's)."""
        S, L, nx, nz = data["ABt"].shape
        elem = data["ABt"].dtype.itemsize
        kernel = "chain_eval" if elem == 4 else "chain_eval_df"
        tag = (f"({what}: S={S}, L={L}, nx={nx}, nu={nz - nx}; launch "
               f"{ck.chain_node_launch(S, L, nx, nz - nx, elem)[:4]})")
        if lam is not None:
            ev = ck.chain_eval_ref(data, lam)
            compare_forms(f"{kernel} {tag}", eval_makes(data, lam),
                          [ev[k] for k in EVAL_KEYS], 0.0, timed)
            qt_rt = qt_rt or (ev["qt"], ev["rt"])
        if d is not None:
            ap_ref = dek.chain_apply_df_ref(data, *qt_rt, d)
            compare_forms(f"chain_apply_df {tag}", apply_makes(data, *qt_rt, d),
                          [ap_ref[k] for k in APPLY_KEYS], DF_RTOL, timed)

    def crown_case(what, data, lam, extra, prep, timed):
        """crown_eval (f32 data, to EVAL_RTOL of the twin) or crown_eval_df
        (f64, bit for bit the twin) at ``lam``."""
        Nn, nx, nz = data["ABt"].shape
        f32 = data["ABt"].dtype == torch.float32
        ref = ckr.crown_eval_ref(data, lam, extra, prep)
        compare_forms(f"{'crown_eval' if f32 else 'crown_eval_df'} ({what}: {Nn} nodes, "
                      f"nx={nx}, nu={nz - nx}; launch {ckr._crown_eval_launch(Nn, nx, nz - nx)})",
                      crown_makes(data, lam, extra, prep), [ref[k] for k in CROWN_KEYS],
                      EVAL_RTOL if f32 else 0.0, timed)

    def crown_apply_case(what, data, qt, rt, d, extra, prep, timed):
        Nn, nx, nz = data["ABt"].shape
        ref = dek.crown_apply_df_ref(data, qt, rt, d, extra, prep)
        compare_forms(f"crown_apply_df ({what}: {Nn} nodes, nx={nx}, nu={nz - nx}; launch "
                      f"{ckr._crown_eval_launch(Nn, nx, nz - nx)})",
                      crown_apply_makes(data, qt, rt, d, extra, prep),
                      [ref[k] for k in CROWN_APPLY_KEYS], 0.0, timed)

    # ---- every call of a cold bench solve, and the launches of a warm one
    opts = td.TdunesOpts(**BENCH_OPTS)
    names = ("chain_eval_df", "chain_apply_df", "crown_eval_df", "crown_apply_df")
    qp = quadcopter(4, 4, 20, device=dev).qp
    ms = tm.split_multistage(qp)
    got, (cro, cho, info) = capture(dek, names, lambda: tm.tdunes_ms_solve(ms, None, None, opts))
    xmin, xmax = ms.crown.xmin.clone(), ms.crown.xmax.clone()
    xmin[0] *= 1.01
    xmax[0] *= 1.01
    ms_p = dataclasses.replace(ms, crown=ms.crown.replace(xmin=xmin, xmax=xmax))
    got_w, (_, _, info_w) = capture(dek, names,
                                    lambda: tm.tdunes_ms_solve(ms_p, cro["lam"], cho["lam"], opts))
    counts = lambda g: ", ".join(f"{n} x{len(g[n])}" for n in names)
    print(f"bench path (quadcopter(4,4,20), bench options): cold solve {info['iter']} iterations "
          f"({info['iter_f32']} coarse): {counts(got)}; warm solve (x0 scaled by 1.01) "
          f"{info_w['iter']} ({info_w['iter_f32']} coarse): {counts(got_w)}", flush=True)
    for k, ((data, lam), _) in enumerate(got["chain_eval_df"]):
        case(f"bench path eval {k}", data, lam.double().contiguous(), None, k == 0)
    for k, ((data, qt, rt, d), _) in enumerate(got["chain_apply_df"]):
        case(f"bench path apply {k}", data, None, d.contiguous(), k == 0, (qt, rt))
    for k, ((data, lam, extra, prep), _) in enumerate(got["crown_eval_df"]):
        crown_case(f"bench path {k}", data, lam.double().contiguous(),
                   extra.double().contiguous(), prep, k == 0)
    for k, ((data, qt, rt, d, extra, prep), _) in enumerate(got["crown_apply_df"]):
        crown_apply_case(f"bench path apply {k}", data, qt, rt, d.contiguous(), extra, prep,
                         k == 0)
    # ---- quadcopter(4,5,20)'s first f64 point
    ms5 = tm.split_multistage(quadcopter(4, 5, 20, device=dev).qp)
    got5, _ = capture(dek, names, lambda: tm.tdunes_ms_solve(ms5, None, None, opts))
    (data, lam), _ = got5["chain_eval_df"][0]
    case("quadcopter(4,5,20) eval 0", data, lam.double().contiguous(), None, True)
    (data, qt, rt, d), _ = got5["chain_apply_df"][0]
    case("quadcopter(4,5,20) apply 0", data, None, d.contiguous(), True, (qt, rt))
    (data, lam, extra, prep), _ = got5["crown_eval_df"][0]
    crown_case("quadcopter(4,5,20) 0", data, lam.double().contiguous(),
               extra.double().contiguous(), prep, True)
    (data, qt, rt, d, extra, prep), _ = got5["crown_apply_df"][0]
    crown_apply_case("quadcopter(4,5,20) apply 0", data, qt, rt, d.contiguous(), extra, prep,
                     True)
    # ---- chain_eval and crown_eval (f32): the coarse per-kernel loop's points
    opts2n = td.TdunesOpts(**{**TWO_PHASE_OPTS, "termination": "twonorm"})
    opts_ms_f32 = dataclasses.replace(td.TdunesOpts(**SDUNES_BOOT_OPTS), tol=1e-3, max_iter=80,
                                      f32_phase_tol=0.0, df64_phase=False, refine_steps=0)
    ms_sm32 = tm.split_multistage(spring_mass_chain(4, 4, 4, 20, device=dev)[0]).to(
        dtype=torch.float32)
    for what, ms_c, o in (("two-norm path", ms, opts2n), ("tdunes_ms_f32", ms_sm32, opts_ms_f32),
                          ("1024-scenario two-norm", ms5, opts2n)):
        g32, (g11, (_, _, info_c)) = capture(ck, ("chain_eval",), lambda: capture(
            ckr, ("crown_eval",), lambda: tm.tdunes_ms_solve(ms_c, None, None, o)))
        print(f"{what}: cold solve {info_c['iter']} iterations ({info_c['iter_f32']} coarse), "
              f"chain_eval x{len(g32['chain_eval'])}, crown_eval x{len(g11['crown_eval'])}",
              flush=True)
        (data, lam), _ = g32["chain_eval"][0]
        case(f"{what} eval 0", data, lam.float().contiguous(), None, True)
        for k, ((data, lam, extra, prep), _) in enumerate(g11["crown_eval"]):
            crown_case(f"{what} {k}", data, lam.float().contiguous(),
                       extra.float().contiguous(), prep, k == 0)
    # ---- the smoke's edges
    for k, (S, L, nx, nu) in enumerate(EVAL_DF_EDGES):
        data, lam, d = eval_df_operands(torch, S, L, nx, nu, 40 + k, dev)
        case("edge", data, lam, d, False)
        case("edge", {key: v.float() for key, v in data.items()}, lam.float(), None, False)
    for k, edge in enumerate(CROWN_EVAL_EDGES):
        what = f"edge (md, Nr, nx, nu) = {edge}"
        data, lam, extra, prep = crown_eval_operands(torch, *edge, 50 + k, dev)
        crown_case(what, data, lam, extra, prep, False)
        crown_case(what, {key: v.float() for key, v in data.items()}, lam.float(),
                   extra.float(), prep, False)
        crown_apply_case(what, *crown_apply_operands(torch, *edge, 50 + k, dev), False)

    # ---- SASS: no DFMA in the package's evaluation kernels, no FFMA in its
    # f32 ones
    for name, (_, _, path) in libs.items():
        for kernel, (ops, _) in opcode_counts(path, KERNEL_NAMES).items():
            print(f"SASS {name} {kernel}: {ops}")
            if name == "package" and (ops.get("DFMA", 0) or (
                    any(k in kernel for k in F32_KERNELS) and ops.get("FFMA", 0))):
                failed.append(f"FFMA / DFMA in the package's {kernel}")

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

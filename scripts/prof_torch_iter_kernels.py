#!/usr/bin/env python3
"""The fused coarse-phase iteration ``newton_iter`` (``csrc/newton_iter.cu``)
and the IPM's ``ric_chain_factor`` (``csrc/ric_chain.cu``) against other
checkouts', on one card.

    python3 scripts/prof_torch_iter_kernels.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name; its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build, this checkout's ``_build`` this one's ("package").

Shapes. newton_iter in both modes at the coarse phase's first iteration
(``chip_smoke.iter_operands``) of the quadcopter headline (S=256 chains of
L=16, n=6, nu=4; 341 crown nodes), of the 1024-scenario tree
quadcopter(4,5,20) and of ``chip_smoke.ITER_EDGES``; ric_chain_factor on
seeded operands (``chip_smoke.ric_operands``) at IPM path A's shape (S=256,
L=16, nx=8, nz=9) and at ``chip_smoke.RIC_EDGES``, each with diagonal and
dense hbar.

For every library and shape: ms a launch on the card alone (20 launches in
a CUDA graph, ``chip_smoke.graph_ms``) and of one launch timed alone (the
median of REPS, ``chip_smoke.cuda_ms``; the C function called directly,
outputs allocated beforehand); the largest difference from the plain twin
(newton_iter's eval mode to ``EVAL_RTOL``, its iter mode to ``SOLVE_RTOL``,
ric_chain_factor to ``FACTOR_RTOL``); and whether each other library's
outputs equal the package's bit for bit (``torch.equal``, every output).
Both libraries take the same pointer list; the one-block newton_iter of
earlier checkouts reads a thread count from dims[9], which this one does
not read. Then the package's newton_iter phases at the headline (iter
mode, the medians of REPS launches of the kernel's global-timer reads
around each cluster barrier: each phase's time, how far apart the blocks
reach the barrier after it and how long it takes to release them, and the
crown solve's three parts), and, through each checkout's own wrappers
(the other checkouts' in a child process that imports their package), one
launch timed alone of newton_iter in both modes and of ric_chain_factor at
the headlines (the wrappers' host path), and chain_eval, crown_eval,
chain_eval_df and crown_eval_df in a CUDA graph at the headline's duals 0
(their node sums are newton_iter's). Exits non-zero if a launch fails,
a result leaves its tolerance or a library differs from the package. Needs
CUDA and nvcc; imports nothing of JAX.
"""

import argparse
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RIC_HEADLINE = (256, 16, 8, 9)
RIC_REG = 1e-8
ITER_HEADLINE = ("quadcopter", (4, 4, 20))
ITER_BIG = ("quadcopter", (4, 5, 20))
PHASES = ("right-hand sides", "chain backward sweeps", "crown solve and direction",
          "chain forward sweeps", "chain clips, crown [A B]' lam", "residual rows, crown clips",
          "crown residuals, per-chain sums")


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
    from ``parent`` (this checkout when None): printed, one line each."""
    if parent is not None:
        sys.path.insert(0, str(Path(parent).resolve()))
    import torch
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    from treeqp_tpu_torch.ops import iter_kernel as ik
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    from treeqp_tpu_torch.solvers import ms_df64 as md
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import cuda_ms, graph_ms, iter_edge_qp, iter_operands, ric_operands
    from prof_common import card
    name = "package" if parent is None else Path(parent).resolve().name
    dev = torch.device("cuda", 0)
    qp = iter_edge_qp(*ITER_HEADLINE)
    ev, it = iter_operands(torch, qp, dev)
    # the evaluation kernels that share tq_eval.cuh's node sums, on the card
    # alone (CUDA graph): f32 at the coarse phase's first point, f64 there too
    data_ch, data_cr, _, st0, prep = ev[:5]
    ms = tm.split_multistage(qp).to(dev)
    dd = md.make_dd(ms, prep)
    extra = torch.zeros_like(data_cr["ABt"][:, 0])
    evals = (("chain_eval", lambda: ck.chain_eval(data_ch, st0["lam_ch"])),
             ("crown_eval", lambda: ckr.crown_eval(data_cr, st0["lam_cr"], extra, prep)),
             ("chain_eval_df", lambda: dek.chain_eval_df(dd["ch"], st0["lam_ch"].double())),
             ("crown_eval_df", lambda: dek.crown_eval_df(dd["cr"], st0["lam_cr"].double(),
                                                         extra.double(), prep)))
    for what, fn in evals:
        print(f"graph {what} ({name}): {graph_ms(torch, fn):.4f} ms in a CUDA graph at the "
              f"headline on {card()}", flush=True)
    hd = ric_operands(torch, *RIC_HEADLINE, True, 0, dev)
    hg = ric_operands(torch, *RIC_HEADLINE, False, 0, dev)
    rows = (("newton_iter(iter)", lambda: ik.newton_iter(*it, mode="iter")),
            ("newton_iter(eval)", lambda: ik.newton_iter(*ev, mode="eval")),
            ("ric_chain_factor(dense)", lambda: rk.ric_chain_factor(*hd, reg=RIC_REG)),
            ("ric_chain_factor(diagonal)", lambda: rk.ric_chain_factor(*hg, reg=RIC_REG)))
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
        sys.exit("prof_torch_iter_kernels: needs a CUDA device")
    import treeqp_tpu_torch  # noqa: F401  (pins full-precision f32)
    from chip_smoke import (EVAL_RTOL, FACTOR_RTOL, ITER_EDGES, RIC_EDGES, SOLVE_RTOL,
                            cuda_ms, graph_ms, iter_edge_qp, iter_operands, ric_operands)
    from prof_common import card as card_name
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import iter_kernel as ik
    from treeqp_tpu_torch.ops import riccati_kernels as rk
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

    def compare_libs(what, launch, outputs, ref, rtol):
        """Run ``launch(lib, outs)`` for every library, hold it to the twin
        and the other libraries to the package bit for bit; print times.
        Returns {library: (graph ms, one launch alone ms)}."""
        outs, times = {}, {}
        for name, lib in libs.items():
            o = outputs()

            def fn():
                _build.check(launch(lib, o), f"{name} {what}")
            fn()
            torch.cuda.synchronize()
            err = check(name, what, o["check"], ref, rtol)
            outs[name] = [t.clone() for t in o["all"]]
            times[name] = (graph_ms(torch, fn), cuda_ms(torch, fn, args.reps))
            print(f"{what} {name}: {times[name][0]:.4f} ms in a CUDA graph, "
                  f"{times[name][1]:.4f} ms one launch timed alone, max |diff| to the twin "
                  f"{err:.3e} on {card}")
        for name in libs:
            if name != "package":
                same = [torch.equal(a, b) for a, b in zip(outs["package"], outs[name])]
                print(f"{what}: package bit for bit equal to {name}: {all(same)} "
                      f"({sum(same)} of {len(same)} outputs)")
                if not all(same):
                    failed.append(f"{what} vs {name}")
        return times

    # ---- newton_iter
    iter_keys = ("dcr", "dch", "lam2_cr", "lam2_ch", "res2_cr", "res2_ch", "x", "u", "cx",
                 "cu", "xUnc", "uUnc", "cxUnc", "cuUnc", "fs", "errs", "fc", "errc", "dots",
                 "dotc")
    shapes = [ITER_HEADLINE, ITER_BIG] + list(ITER_EDGES)
    headline_times = {}
    for k, (model, margs) in enumerate(shapes):
        ev, it = iter_operands(torch, iter_edge_qp(model, margs), dev)
        S, L, n, _ = ev[0]["ABt"].shape
        Nn = ev[1]["ABt"].shape[0]
        sched = ckr._get_sched(ev[4])
        # the thread count the one-block kernel of earlier checkouts reads
        threads = min(1024, max(32, -(-max(S, Nn, sched.width) // 32) * 32))
        for mode, a in (("iter", it), ("eval", ev)):
            r = ik.newton_iter_ref(*a, mode=mode)
            ref = dict(r, fs=r["f1p"][0], fc=r["f1p"][1], dots=r["dotp"][0],
                       dotc=r["dotp"][1], errs=r["errp"][0], errc=r["errp"][1])

            def outputs(a=a, mode=mode):
                out, ptrs, dims, keep = ik.launch_args(*a, mode=mode)
                dims10 = _build.int_array(list(dims) + [threads])
                return dict(ptrs=ptrs, dims=dims10, keep=keep,
                            check=[out[q] for q in iter_keys],
                            all=[out[q] for q in iter_keys] + [
                                out[q] for q in ("qt", "rt", "qtilde", "rtilde")])
            what = (f"newton_iter({mode}) {model}{margs} (S={S}, L={L}, n={n}, "
                    f"crown {Nn} nodes)")
            times = compare_libs(
                what, lambda lib, o: lib.tq_newton_iter(o["ptrs"], o["dims"], st()), outputs,
                [ref[q] for q in iter_keys], SOLVE_RTOL if mode == "iter" else EVAL_RTOL)
            if k == 0:
                headline_times[mode] = times
    for name in libs:
        t_i, t_e = headline_times["iter"][name], headline_times["eval"][name]
        print(f"newton_iter headline {name}: iter - eval (the solve's share) "
              f"{t_i[0] - t_e[0]:.4f} ms in a graph of {t_i[0]:.4f}, {t_i[1] - t_e[1]:.4f} ms "
              f"alone of {t_i[1]:.4f} on {card}")

    # the package's phases at the headline, from the kernel's timer reads
    ev, it = iter_operands(torch, iter_edge_qp(*ITER_HEADLINE), dev)
    stamps = torch.zeros((8, 20), dtype=torch.int64, device=dev)
    spans, waits, lats, crown = [], [], [], []
    for rep in range(args.reps + 1):
        out, ptrs, dims, keep = ik.launch_args(*it, mode="iter", stamps=stamps)
        _build.check(libs["package"].tq_newton_iter(ptrs, dims, st()), "newton_iter stamps")
        torch.cuda.synchronize()
        if rep:
            t = stamps.tolist()
            # phase q runs from barrier q-1's release (the start) to barrier q's
            ends = [t[0][0]] + [t[0][2 + 2 * q] for q in range(7)]
            spans.append([(ends[q + 1] - ends[q]) / 1e6 for q in range(7)])
            before = [[t[b][1 + 2 * q] for b in range(8)] for q in range(7)]
            after = [[t[b][2 + 2 * q] for b in range(8)] for q in range(7)]
            waits.append([(max(x) - min(x)) / 1e6 for x in before])
            lats.append([(min(y) - max(x)) / 1e6 for x, y in zip(before, after)])
            crown.append([(t[0][15] - t[0][4]) / 1e6, (t[0][16] - t[0][15]) / 1e6,
                          (t[0][17] - t[0][16]) / 1e6, (t[0][6] - t[0][17]) / 1e6])
    med = lambda rows: [statistics.median(col) for col in zip(*rows)]
    sp, wt, lt = med(spans), med(waits), med(lats)
    print(f"newton_iter headline phases (package, iter mode, median of {args.reps} launches "
          f"of the kernel's %globaltimer reads; total {sum(sp):.4f} ms) on {card}:")
    for what, v, w, l_ in zip(PHASES, sp, wt, lt):
        print(f"  {v:.4f} ms  {100 * v / sum(sp):5.1f}%  {what} (then the blocks reach the "
              f"barrier over {w:.4f} ms; it releases {l_:.4f} ms after the last)")
    cb, cr, cf, cd = med(crown)
    print(f"  crown solve (G <= 32: the cluster's warps): backward levels {cb:.4f} ms, root "
          f"{cr:.4f} ms, forward levels {cf:.4f} ms, then the crown's direction {cd:.4f} ms")

    # ---- ric_chain_factor
    f32 = dict(dtype=torch.float32, device=dev)
    for k, (S, L, nx, nz) in enumerate((RIC_HEADLINE,) + RIC_EDGES):
        for dense in (True, False):
            hbar, AB = ric_operands(torch, S, L, nx, nz, dense, k, dev)
            nu = nz - nx
            fact, W0 = rk.ric_chain_factor_ref(hbar, AB, reg=RIC_REG)
            ref = [fact[q] for q in ("P", "Luu", "K", "Mxu")] + [W0]

            def outputs(S=S, L=L, nx=nx, nu=nu, nz=nz):
                o = [torch.empty((S, L, nx, nx), **f32), torch.empty((S, L, nu, nu), **f32),
                     torch.empty((S, L, nu, nx), **f32), torch.empty((S, L, nx, nu), **f32),
                     torch.empty((S, nz, nz), **f32)]
                return dict(out=o, check=o, all=o)
            compare_libs(
                f"ric_chain_factor (S={S}, L={L}, nx={nx}, nz={nz}, "
                f"{'dense' if dense else 'diagonal'} hbar)",
                lambda lib, o, hbar=hbar, AB=AB, S=S, L=L, nx=nx, nz=nz, dense=dense:
                lib.tq_ric_chain_factor(hbar.data_ptr(), AB.data_ptr(),
                                        *(t.data_ptr() for t in o["out"]), S, L, nx, nz,
                                        int(dense), RIC_REG, st()),
                outputs, ref, FACTOR_RTOL)

    sys.stdout.flush()
    wrapper_times(None)
    for p in args.parent:
        sys.stdout.flush()
        res = subprocess.run([sys.executable, __file__, "--wrappers-of", p])
        if res.returncode != 0:
            failed.append(f"wrappers of {p}")
    if failed:
        sys.exit(f"prof_torch_iter_kernels: not bit for bit or failed: {failed}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The generic solver's crown solve ``crown_solve`` (``csrc/crown_solve.cu``)
and the IPM chains' forward sweep ``ric_chain_fwd`` (``csrc/ric_chain.cu``)
against other checkouts', on one card; and ``system_solve`` and
``newton_iter``, which share the crown solve (``csrc/tq_crown.cuh``).

    python3 scripts/prof_torch_fwd_solves.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name; its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build, this checkout's ``_build`` this one's ("package"). A library
whose crown solve takes a thread count (the one-block kernel) gets one
thread a group, as its wrapper gave it. The operands:
- crown_solve: the first Newton solve's of ``tdunes_solve`` (captured) on
  the generic solver's four crowns: quadcopter(4,4,20) pruned to 128
  scenarios and unpruned (split crowns), the asymmetric tree (the whole
  tree) at ``models.GENERIC_SPEED_OPTS``, and the general C/D tree
  ``general_cd("qpgen")`` at ``models.GENERAL_CD_OPTS`` (split crown, G =
  32); seeded factors (``chip_smoke.crown_operands`` through the twin's
  factor) and right-hand sides (``chip_smoke.crown_rhs``) at the
  multistage crowns of quadcopter(4,4,20) (the headline), spring_mass_chain
  (4,4,4,20) (G = 32) and quadcopter(4,5,20) (341 groups), and at
  ``chip_smoke.CROWN_EDGES``, and at the multistage crowns of WIDTHS (widest
  levels of 4 to 36 groups, nx = 6);
- ric_chain_fwd: the first f32 iteration's of IPM paths A (``ipm_ms_solve``
  on ``general_cd("qpgen")``) and B (that tree box-only) at
  ``models.IPM_OPTS`` (captured), and seeded factors and right-hand sides
  at ``chip_smoke.RIC_EDGES`` with both hbar forms;
- system_solve at ``chip_smoke.SYSTEM_SHAPES`` (``system_operands``) and
  newton_iter in both modes at the headline and ``chip_smoke.ITER_EDGES``
  (``iter_operands``).

For every library and shape: whether its outputs equal the package's bit
for bit (``torch.equal``) and the package's largest difference from the
plain twin (``chip_smoke.SOLVE_RTOL``, newton_iter's eval mode
``EVAL_RTOL``); at the captured, multistage and headline shapes ms a launch
on the card alone (20 launches in a CUDA graph, ``chip_smoke.graph_ms``)
and of one C call timed alone (the median of REPS, ``chip_smoke.cuda_ms``;
outputs allocated beforehand). crown_solve runs in both of the package's
forms at every shape with G <= 32, one cluster and one block (each bit for
bit the package's launch), timed where the package is; beside it
``torch.cholesky_solve`` with the twin's factors as one dense lower factor
(``chip_smoke.crown_matrix``) at the four generic crowns, in a graph and
alone; beside ric_chain_fwd ``torch.linalg.ldl_solve`` of each chain's KKT
matrix at path A (``chip_smoke.ric_chain_ldl``, bwd + fwd together, alone:
cuSOLVER's sytrf fails under capture). Then, through each checkout's own
Python wrappers (the other checkouts' in a child process that imports
their package), one call timed alone of both kernels on seeded operands at
the pruned crown and at path A's shape. Exits non-zero if a launch fails,
a result leaves its tolerance or a library differs from the package in a
bit. Needs CUDA and nvcc; imports nothing of JAX.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the multistage crowns (name, (md, Nr, nx), nz of the seeded blocks)
MS_CROWNS = (("headline", (4, 4, 6), 10), ("bootstrap", (4, 4, 8), 9),
             ("1024 scenarios", (4, 5, 6), 10))
# multistage crowns (md, Nr, nx) whose widest levels (4 .. 36 groups) place
# _solve_launch's choice between one block and one cluster
WIDTHS = ((2, 3, 6), (3, 3, 6), (4, 3, 6), (5, 3, 6), (6, 3, 6), (2, 5, 6), (3, 4, 6))
ITER_HEADLINE = ("quadcopter", (4, 4, 20))
RIC_PATH_A = (256, 16, 8, 9)  # (S, L, nx, nz) of the wrappers' seeded ric_chain_fwd


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound by
    that checkout's own ``_build``, and whether its crown solve takes
    (blocks, warps) rather than a thread count."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib(), len(mod._SIGNATURES["tq_crown_solve"]) == 17


def one_block_threads(sched):
    """The one-block kernel's threads: one a group up to 1024."""
    return min(1024, max(32, -(-max(sched.NpG, sched.width) // 32) * 32))


def pruned_crown():
    """(prep, levels) of the split crown of quadcopter(4,4,20) pruned to
    128 scenarios."""
    from treeqp_tpu_torch.models import pruned, quadcopter
    from treeqp_tpu_torch.solvers import tdunes as td
    p = td._get_prep(pruned(quadcopter(4, 4, 20, device="cpu").qp, 128).topo)
    return p, td._split_index(p, td._split_sched(p), "cpu")["crown"]


def wrapper_times(parent):
    """One call timed alone through the wrappers of the package imported
    from ``parent`` (this checkout when None): crown_solve at the pruned
    crown and ric_chain_fwd at path A's shape, on seeded operands; printed,
    one line each."""
    if parent is not None:
        sys.path.insert(0, str(Path(parent).resolve()))
    import torch
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import CROWN_REG, RIC_REG, crown_operands, cuda_ms, ric_operands, ric_rhs
    from prof_common import card
    name = "package" if parent is None else Path(parent).resolve().name
    dev = torch.device("cuda", 0)
    prep, levels = pruned_crown()
    sched = ckr._get_sched(prep, levels)
    _, (W, Ut) = crown_operands(torch, sched, sched.nxm + 2, 1, dev)
    CholW, CholUt = ckr.crown_factor_ref(W, Ut, prep, reg=CROWN_REG, levels=levels)
    rg = torch.randn((sched.NpG, sched.G), generator=torch.Generator().manual_seed(2)).to(dev)
    S, L, nx, nz = RIC_PATH_A
    hbar, AB = ric_operands(torch, S, L, nx, nz, True, 2, dev)
    rgr, rb, zr = ric_rhs(torch, S, L, nx, nz, 3, dev)
    fact = rk.ric_chain_factor_ref(hbar, AB, RIC_REG)[0]
    p, k, _ = rk.ric_chain_bwd_ref(fact, rgr, rb)
    rows = ((f"crown_solve (pruned crown: NpG={sched.NpG}, G={sched.G})",
             lambda: ckr.crown_solve(CholW, CholUt, rg, prep, levels=levels)),
            (f"ric_chain_fwd (S={S}, L={L}, nx={nx}, nz={nz})",
             lambda: rk.ric_chain_fwd(fact, p, k, rb, zr)))
    for timed_pass in (False, True):  # the first pass warms the card and the host path
        for what, fn in rows:
            t = cuda_ms(torch, fn, 50)
            if timed_pass:
                print(f"wrapper {what} ({name}): one call timed alone {t:.4f} ms (host path "
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
        sys.exit("prof_torch_fwd_solves: needs a CUDA device")
    from chip_smoke import (CROWN_EDGES, CROWN_REG, EVAL_RTOL, ITER_EDGES, RIC_EDGES, RIC_REG,
                            SOLVE_RTOL, SYSTEM_SHAPES, crown_matrix, crown_operands,
                            crown_prep, crown_rhs, crown_vector, cuda_ms, graph_ms,
                            iter_edge_qp, iter_operands, ric_chain_ldl, ric_operands, ric_rhs,
                            system_operands)
    from prof_common import capture, card as card_name
    import treeqp_tpu_torch  # noqa: F401  (pins full-precision f32)
    from treeqp_tpu_torch.models import (GENERAL_CD_OPTS, GENERIC_SPEED_OPTS, IPM_OPTS,
                                         asym_tree, general_cd, pruned, quadcopter,
                                         spring_mass_chain)
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import iter_kernel as ik
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    from treeqp_tpu_torch.ops import system_kernels as sk
    from treeqp_tpu_torch.solvers import ipm
    from treeqp_tpu_torch.solvers import ipm_multistage as ims
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    libs = {"package": (_build.lib(), True),
            **{Path(p).name: parent_lib(p) for p in args.parent}}
    st = lambda: _build.stream(dev)  # the current stream: a graph captures on its own
    f32 = dict(dtype=torch.float32, device=dev)
    failed = []

    def twin_err(what, got, ref, rtol=SOLVE_RTOL):
        err = 0.0
        for g, r in zip(got, ref):
            e = float((g - r).abs().max())
            if not (bool(torch.isfinite(g).all())
                    and e <= rtol * max(1.0, float(r.abs().max()))):
                print(f"{what}: differs from the twin by {e:.3e}")
                failed.append(f"{what} vs the twin")
            err = max(err, e)
        return err

    def compare_libs(what, makes, timed, ref, rtol=SOLVE_RTOL):
        """For every (name, make) of ``makes``: fn, outs = make(); run,
        check against the package bit for bit and the package against the
        twin ``ref``; time where ``timed``. Returns {name: (graph ms, alone
        ms)} where timed."""
        outs, fns, line, times = {}, {}, [], {}
        for name, make in makes.items():
            fn, o = make()
            fn()
            torch.cuda.synchronize()
            outs[name], fns[name] = [t.clone() for t in o], fn
        err = twin_err(what, outs["package"], ref, rtol)
        for name in makes:
            if name != "package":
                same = [torch.equal(a, b) for a, b in zip(outs["package"], outs[name])]
                line.append(f"bit for bit {name}: {all(same)}")
                if not all(same):
                    failed.append(f"{what} vs {name}")
        if timed:
            for name, fn in fns.items():
                times[name] = (graph_ms(torch, fn), cuda_ms(torch, fn, args.reps))
                print(f"{what} {name}: {times[name][0]:.4f} ms in a CUDA graph, "
                      f"{times[name][1]:.4f} ms one C call timed alone on {card}", flush=True)
        print(f"{what}: package max |diff| to the twin {err:.3e}; {', '.join(line)}", flush=True)
        return times

    def library(what, fn, note, graph=True):
        """A library call's time, in a graph where it captures, and alone."""
        g = f"{graph_ms(torch, fn):.4f} ms in a CUDA graph, " if graph else ""
        print(f"{what}: {g}{cuda_ms(torch, fn, min(args.reps, 10)):.4f} ms alone ({note}) "
              f"on {card}", flush=True)

    # ---- crown_solve
    def crown_makes(CholW, CholUt, rg, sched):
        """make() of every library's crown solve and of the package's two
        forms (G <= 32)."""
        t = sched.on(dev)
        lev = [t[k].data_ptr() for k in ("lev_ptr", "lev_child", "lev_parent", "lev_slot")]

        def make_with(lib, launch):
            def make():
                o = [torch.empty((sched.NpG, sched.G), **f32) for _ in range(3)]
                fn = lambda: _build.check(lib.tq_crown_solve(
                    CholW.data_ptr(), CholUt.data_ptr(), rg.data_ptr(), *lev,
                    *(a.data_ptr() for a in o), sched.NpG, sched.K, sched.nxm, sched.n_lev,
                    *launch, st()), "tq_crown_solve")
                return fn, (o[2],)
            return make
        makes = {name: make_with(lib, ckr._solve_launch(sched) if new
                                 else (one_block_threads(sched),))
                 for name, (lib, new) in libs.items()}
        if sched.G <= 32:
            pk = libs["package"][0]
            w = sched.width
            makes["package one block"] = make_with(pk, (1, min(ckr._SOLVE_WARPS, w)))
            makes["package cluster"] = make_with(
                pk, (ckr._CLUSTER, min(ckr._SOLVE_WARPS, -(-w // ckr._CLUSTER))))
        return makes

    def crown_case(what, CholW, CholUt, rg, prep, levels, timed, lib_call=False):
        sched = ckr._get_sched(prep, levels)
        tag = (f"crown_solve ({what}: NpG={sched.NpG}, G={sched.G}, {sched.n_lev} levels, "
               f"widest {sched.width}; launch {ckr._solve_launch(sched)})")
        ref = [ckr.crown_solve_ref(CholW, CholUt, rg, prep, levels=levels)]
        compare_libs(tag, crown_makes(CholW, CholUt, rg, sched), timed, ref)
        if lib_call:
            F = crown_matrix(torch, CholW, CholUt, sched, factor=True)
            v = crown_vector(torch, rg, sched)
            fn = lambda: torch.cholesky_solve(v, F)
            err = twin_err(f"{tag} cholesky_solve",
                           [crown_vector(torch, fn().view(-1), sched, back=True)], ref)
            library(f"{tag} cholesky_solve", fn,
                    f"the twin's factors as one [{F.shape[0]}]^2 lower factor, |diff| to the "
                    f"twin {err:.3e}")

    q = quadcopter(4, 4, 20, device="cpu").qp
    generic = (("pruned split crown", pruned(q, 128), GENERIC_SPEED_OPTS),
               ("unpruned split crown", q, GENERIC_SPEED_OPTS),
               ("asymmetric tree", asym_tree(device="cpu"), GENERIC_SPEED_OPTS),
               ("general C/D split crown", general_cd("qpgen", device="cpu"), GENERAL_CD_OPTS))
    for what, qq, opts in generic:
        o = td.TdunesOpts(**{**opts, "max_iter": 1})
        got, _ = capture(ckr, ("crown_solve",), lambda: td.tdunes_solve(qq.to(dev), None, o))
        (CholW, CholUt, rg, prep), kw = got["crown_solve"][0]
        crown_case(what, CholW, CholUt, rg, prep, kw.get("levels"), True, lib_call=True)
    for k, (what, tree, nz) in enumerate(MS_CROWNS):
        prep = crown_prep(*tree)
        sched = ckr._get_sched(prep)
        _, (W, Ut) = crown_operands(torch, sched, nz, k, dev)
        CholW, CholUt = ckr.crown_factor_ref(W, Ut, prep, reg=CROWN_REG)
        crown_case(what, CholW, CholUt, crown_rhs(torch, sched, 40 + k, dev), prep, None, True)
    for k, (md, Nr, nx) in enumerate(WIDTHS):
        prep = crown_prep(md, Nr, nx)
        sched = ckr._get_sched(prep)
        _, (W, Ut) = crown_operands(torch, sched, nx + 2, 70 + k, dev)
        CholW, CholUt = ckr.crown_factor_ref(W, Ut, prep, reg=CROWN_REG)
        crown_case(f"multistage md={md}, Nr={Nr}, nx={nx}", CholW, CholUt,
                   crown_rhs(torch, sched, 80 + k, dev), prep, None, True)
    for k, (md, Nr, nx, reg, zero) in enumerate(CROWN_EDGES):
        prep = crown_prep(md, Nr, nx)
        sched = ckr._get_sched(prep)
        _, (W, Ut) = crown_operands(torch, sched, nx + 2, 20 + k, dev, zero=zero)
        CholW, CholUt = ckr.crown_factor_ref(W, Ut, prep, reg=reg)
        crown_case(f"edge md={md}, Nr={Nr}, nx={nx}" + (", a zero block" if zero else ""),
                   CholW, CholUt, crown_rhs(torch, sched, 50 + k, dev), prep, None, False)

    # ---- ric_chain_fwd
    def fwd_makes(fact, p, k, rb, zr):
        S, L, nx, nz = fact["AB"].shape
        ins = [fact["P"], fact["K"], fact["AB"], rb, p, k, zr]

        def make_with(lib):
            def make():
                o = [torch.empty(sh, **f32) for sh in ((S, L, nz), (S, L, nx))]
                ptrs = _build.ptr_array(ins + o)  # kept alive by the closure
                fn = lambda: _build.check(lib.tq_ric_chain_fwd(ptrs, S, L, nx, nz, st()),
                                          "tq_ric_chain_fwd")
                return fn, o
            return make
        return {name: make_with(lib) for name, (lib, _) in libs.items()}

    def one_iteration(fn, key):
        """ric_chain_factor's, ric_chain_bwd's and ric_chain_fwd's first
        calls in the solve fn(opts) of path ``key`` cut to one iteration."""
        o = ipm.IpmOpts(**{**IPM_OPTS[key], "max_iter": 1})
        got, _ = capture(rk, ("ric_chain_factor", "ric_chain_bwd", "ric_chain_fwd"),
                         lambda: fn(o))
        return {n: c[0] for n, c in got.items()}

    qa = general_cd("qpgen", device=dev)
    qb = spring_mass_chain(4, 4, 4, 20, device=dev)[0]
    paths = {"A": one_iteration(lambda o: ims.ipm_ms_solve(tm.split_multistage(qa), o), "cd"),
             "B": one_iteration(lambda o: ims.ipm_ms_solve(tm.split_multistage(qb), o), "box")}
    for path, got in paths.items():
        (fact, p, k, rb, zr), _ = got["ric_chain_fwd"]
        rb, zr = rb.float().contiguous(), zr.float().contiguous()
        S, L, nx, nz = fact["AB"].shape
        compare_libs(f"ric_chain_fwd (path {path}: S={S}, L={L}, nx={nx}, nz={nz})",
                     fwd_makes(fact, p, k, rb, zr), True,
                     rk.ric_chain_fwd_ref(fact, p, k, rb, zr))
    for k, (S, L, nx, nz) in enumerate(RIC_EDGES):
        for dense in (False, True):
            hbar, AB = ric_operands(torch, S, L, nx, nz, dense, k, dev)
            rg, rb, zr = ric_rhs(torch, S, L, nx, nz, 50 + k, dev)
            fact = rk.ric_chain_factor_ref(hbar, AB, reg=RIC_REG)[0]
            p, kk, _ = rk.ric_chain_bwd_ref(fact, rg, rb)
            compare_libs(f"ric_chain_fwd (S={S}, L={L}, nx={nx}, nz={nz}, "
                         f"{'dense' if dense else 'diagonal'} hbar)",
                         fwd_makes(fact, p, kk, rb, zr), False,
                         rk.ric_chain_fwd_ref(fact, p, kk, rb, zr))
    (hbar, AB), kw = paths["A"]["ric_chain_factor"]
    (_, rg, rb), _ = paths["A"]["ric_chain_bwd"]
    _, lib_sol, _, err_l = ric_chain_ldl(
        torch, hbar, AB, kw.get("reg", 0.0), rg.float().contiguous(), rb.float().contiguous(),
        paths["A"]["ric_chain_fwd"][0][4].float().contiguous())
    library("ric_chain_bwd + ric_chain_fwd (path A) ldl_solve", lib_sol,
            f"for bwd + fwd, |diff| to ric_chain_fwd_ref(ric_chain_bwd_ref) {err_l:.3e}",
            graph=False)
    del lib_sol

    # ---- system_solve and newton_iter, whose crown solve moved
    for seed, (what, shape) in enumerate(SYSTEM_SHAPES):
        Ls, CUs, CholW, CholUt, rg, rch, prep, rid = system_operands(torch, *shape, seed, dev)
        sched = ckr._get_sched(prep)
        S, L, n, _ = Ls.shape
        t = sched.on(dev)
        ids = sk.ms_sched(prep, rid, dev)
        ptrs = [a.data_ptr() for a in (Ls, CUs, CholW, CholUt, rg, rch)] + [
            t[key].data_ptr() for key in ("lev_ptr", "lev_child", "lev_parent", "lev_slot")] + [
            ids["g_of"].data_ptr(), ids["slot"].data_ptr()]

        def sys_make(lib):
            def make():
                o = [torch.empty((sched.NpG, sched.G), **f32) for _ in range(3)] + [
                    torch.empty((S, L, n), **f32)]
                fn = lambda: _build.check(lib.tq_system_solve(
                    *ptrs, *(a.data_ptr() for a in o), S, L, n, sched.NpG, sched.K,
                    sched.n_lev, st()), "tq_system_solve")
                return fn, (o[2], o[3])
            return make
        compare_libs(f"system_solve ({what}: S={S}, L={L}, n={n}, NpG={sched.NpG}, "
                     f"G={sched.G})", {name: sys_make(lib) for name, (lib, _) in libs.items()},
                     seed == 0, sk.system_solve_ref(Ls, CUs, CholW, CholUt, rg, rch, prep, rid))
    iter_keys = ("dcr", "dch", "lam2_cr", "lam2_ch", "res2_cr", "res2_ch", "x", "u", "cx",
                 "cu", "xUnc", "uUnc", "cxUnc", "cuUnc", "fs", "errs", "fc", "errc", "dots",
                 "dotc")
    for k, (model, margs) in enumerate([ITER_HEADLINE] + list(ITER_EDGES)):
        ev, it = iter_operands(torch, iter_edge_qp(model, margs), dev)
        S, L, n, _ = ev[0]["ABt"].shape
        for mode, a in (("iter", it), ("eval", ev)):
            r = ik.newton_iter_ref(*a, mode=mode)
            ref = dict(r, fs=r["f1p"][0], fc=r["f1p"][1], dots=r["dotp"][0],
                       dotc=r["dotp"][1], errs=r["errp"][0], errc=r["errp"][1])

            def iter_make(lib, a=a, mode=mode):
                def make():
                    out, ptrs, dims, keep = ik.launch_args(*a, mode=mode)
                    fn = lambda: _build.check(lib.tq_newton_iter(ptrs, dims, st()),
                                              "tq_newton_iter")
                    fn.keep = (ptrs, dims, keep)
                    return fn, [out[q] for q in iter_keys]
                return make
            compare_libs(f"newton_iter({mode}) {model}{margs} (S={S}, L={L}, n={n})",
                         {name: iter_make(lib) for name, (lib, _) in libs.items()},
                         k == 0 and mode == "iter", [ref[q] for q in iter_keys],
                         SOLVE_RTOL if mode == "iter" else EVAL_RTOL)

    sys.stdout.flush()
    wrapper_times(None)
    for p in args.parent:
        sys.stdout.flush()
        res = subprocess.run([sys.executable, __file__, "--wrappers-of", p])
        if res.returncode != 0:
            failed.append(f"wrappers of {p}")
    if failed:
        sys.exit(f"prof_torch_fwd_solves: not bit for bit or failed: {failed}")
    print("prof_torch_fwd_solves: every library bit for bit the package's at every shape")


if __name__ == "__main__":
    main()

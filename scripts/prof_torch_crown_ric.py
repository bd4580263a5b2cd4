#!/usr/bin/env python3
"""The IPM crown's tree Riccati kernels ``crown_ric_factor`` and
``crown_ric_solve`` (``csrc/crown_ric.cu``) against other checkouts', on one
card; and ``ric_chain_factor`` (``csrc/ric_chain.cu``), whose stage they
share (``csrc/tq_riccati.cuh``).

    python3 scripts/prof_torch_crown_ric.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name; its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build, this checkout's ``_build`` this one's ("package"). A library
whose crown kernels take a thread count (the one-block kernels) gets one
thread a node of the widest level, as its wrapper gave it. The operands:
- both crown kernels: the first f32 iteration's of IPM path B
  (``ipm_ms_solve`` on the box-only spring_mass_chain(4,4,4,20): its
  341-node crown) and of path C (``ipm_solve`` on that tree whole, 4437
  nodes, and on spring_mass_chain(4,4,3,7), 341 nodes) at
  ``models.IPM_OPTS`` (captured from one-iteration solves); seeded ones
  (``chip_smoke.ric_crown_operands``) at ``chip_smoke.CROWN_RIC_EDGES`` and
  at WIDTHS (widest phases of 9 to 256 runs, nz = 9), the solve on the
  twin's factors;
- ric_chain_factor: the first f32 iteration's of IPM path A
  (``ipm_ms_solve`` on ``general_cd("qpgen")``, captured), and seeded ones
  at ``chip_smoke.RIC_EDGES`` with both hbar forms.

For every library and shape: whether its outputs equal the package's bit
for bit (``torch.equal``: the factor's P, Luu, K, Mxu; the solve's dz, dlam,
p, k; ric_chain_factor's factors and W0) and the package's largest
difference from the plain twin (``chip_smoke.FACTOR_RTOL`` /
``SOLVE_RTOL``). The crown kernels run in the package's three team sizes
at every shape, one block and one cluster of 8 or of 16 blocks (each bit
for bit the package's launch); at the captured shapes and WIDTHS every
form and library is timed in a CUDA graph (20 launches,
``chip_smoke.graph_ms``) and one C call alone
(the median of REPS, ``chip_smoke.cuda_ms``; outputs allocated
beforehand), ric_chain_factor at path A. Then, through each checkout's own
Python wrappers (the other checkouts' in a child process that imports
their package), one call of both crown kernels timed alone on seeded
operands at the shapes of paths B, C4437 and C341. Exits non-zero if a launch fails, a result
leaves its tolerance or a library differs from the package in a bit.
Needs CUDA and nvcc; imports nothing of JAX.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# seeded whole multistage trees (md, Nr, Nh, nx, nu) whose widest phases
# (9 to 256 runs) place _ric_launch's choice of one block or one cluster of
# 8 or 16 blocks
WIDTHS = ((3, 2, 4, 8, 1), (4, 2, 4, 8, 1), (3, 3, 5, 8, 1), (2, 5, 6, 8, 1),
          (4, 3, 5, 8, 1), (5, 3, 4, 8, 1), (4, 4, 5, 8, 1))
# the wrappers' seeded trees: IPM path B's crown, path C's two trees
WRAPPER_TREES = (("B", (4, 4, 4, 8, 1)), ("C4437", (4, 4, 20, 8, 1)), ("C341", (4, 3, 7, 8, 1)))


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound by
    that checkout's own ``_build``, and whether its crown Riccati kernels
    take (blocks, warps) rather than a thread count."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib(), len(mod._SIGNATURES["tq_crown_ric_factor"]) == 9


def one_block_threads(sched):
    """The one-block kernels' threads: one a node of the widest level (or
    its parents), up to 1024."""
    return min(1024, max(32, -(-sched.width // 32) * 32))


def wrapper_times(parent):
    """One call of each crown kernel timed alone through the wrappers of
    the package imported from ``parent`` (this checkout when None), on
    seeded operands at the shapes of IPM paths B, C4437 and C341
    (WRAPPER_TREES); printed, one line each."""
    if parent is not None:
        sys.path.insert(0, str(Path(parent).resolve()))
    import torch
    from treeqp_tpu_torch.ops import crown_riccati as crk
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import cuda_ms, ric_crown_operands
    from prof_common import card
    name = "package" if parent is None else Path(parent).resolve().name
    dev = torch.device("cuda", 0)
    rows = []
    for path, (md, Nr, Nh, nx, nu) in WRAPPER_TREES:
        hbar, AB, W0, rg, rb, w0, prep = ric_crown_operands(torch, md, Nr, Nh, nx, nu, 5, dev)
        fact = crk.crown_ric_factor_ref(hbar, AB, W0, prep, nx)
        shape = f"path {path}'s shape: Nc={hbar.shape[0]}, nx={nx}, nz={nx + nu}"
        rows += [(f"crown_ric_factor ({shape})",
                  lambda a=(hbar, AB, W0, prep, nx): crk.crown_ric_factor(*a)),
                 (f"crown_ric_solve ({shape})",
                  lambda a=(fact, rg, rb, w0, prep): crk.crown_ric_solve(*a))]
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
        sys.exit("prof_torch_crown_ric: needs a CUDA device")
    from chip_smoke import (CROWN_RIC_EDGES, FACTOR_RTOL, RIC_EDGES, RIC_REG, SOLVE_RTOL,
                            cuda_ms, graph_ms, ric_crown_operands, ric_operands)
    from prof_common import capture, card as card_name
    import treeqp_tpu_torch  # noqa: F401  (pins full-precision f32)
    from treeqp_tpu_torch.models import IPM_OPTS, general_cd, spring_mass_chain
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import crown_riccati as crk
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    from treeqp_tpu_torch.solvers import ipm
    from treeqp_tpu_torch.solvers import ipm_multistage as ims
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    libs = {"package": (_build.lib(), True),
            **{Path(p).name: parent_lib(p) for p in args.parent}}
    st = lambda: _build.stream(dev)  # the current stream: a graph captures on its own
    f32 = dict(dtype=torch.float32, device=dev)
    failed = []

    def twin_err(what, got, ref, rtol):
        err = 0.0
        for g, r in zip(got, ref):
            e = float((g - r).abs().max())
            if not (bool(torch.isfinite(g).all())
                    and e <= rtol * max(1.0, float(r.abs().max()))):
                print(f"{what}: differs from the twin by {e:.3e}")
                failed.append(f"{what} vs the twin")
            err = max(err, e)
        return err

    def compare_libs(what, makes, timed, ref, rtol):
        """For every (name, make) of ``makes``: fn, outs = make(); run,
        check against the package bit for bit and the package against the
        twin ``ref``; time where ``timed``."""
        outs, fns, line = {}, {}, []
        for name, make in makes.items():
            fn, o = make()
            fn()
            torch.cuda.synchronize()
            outs[name], fns[name] = [t.clone() for t in o], fn
        err = twin_err(what, outs["package"][:len(ref)], ref, rtol)
        for name in makes:
            if name != "package":
                same = all(torch.equal(a, b) for a, b in zip(outs["package"], outs[name]))
                line.append(f"bit for bit {name}: {same}")
                if not same:
                    failed.append(f"{what} vs {name}")
        if timed:
            for name, fn in fns.items():
                g, a = graph_ms(torch, fn), cuda_ms(torch, fn, args.reps)
                print(f"{what} {name}: {g:.4f} ms in a CUDA graph, {a:.4f} ms one C call "
                      f"timed alone on {card}", flush=True)
        print(f"{what}: package max |diff| to the twin {err:.3e}; {', '.join(line)}", flush=True)

    # ---- crown_ric_factor and crown_ric_solve
    def forms(sched, nz):
        """Every library's launch of the crown kernels, and the package's
        two forms: (name, lib, launch, new)."""
        out = [(name, lib, crk._ric_launch(sched, nz) if new else (one_block_threads(sched),),
                new) for name, (lib, new) in libs.items()]
        pk = libs["package"][0]
        per_warp = 32 // crk._ric_lanes(nz)
        cap = min(crk._ric_warps(nz), crk._BLOCK_SMEM // (4 * crk._ric_floats(nz) * per_warp))
        w = sched.run_width
        for blocks in (1, 8, 16):
            out.append((f"package {blocks} block{'s' if blocks > 1 else ''}", pk,
                        (blocks, min(cap, -(-w // (per_warp * blocks)))), True))
        return out

    def factor_makes(hbar, AB, W0, prep, nx, reg):
        sched = crk._get_sched(prep)
        Nc, nz = hbar.shape
        nu = nz - nx
        t = sched.on(dev)
        lev = [t[k] for k in ("lev_ptr", "lev_node", "acc_ptr", "acc_node", "kid_ptr",
                              "kid_idx")]
        runs = [t[k] for k in ("ph_ptr", "run_ptr", "run_node")]

        def make_with(lib, launch, new):
            def make():
                o = [torch.empty(sh, **f32) for sh in ((Nc, nx, nx), (Nc, nu, nu), (Nc, nu, nx),
                                                       (Nc, nx, nu), (Nc, nz, nz), (Nc, nz, nz))]
                ptrs = _build.ptr_array([hbar, AB, W0] + lev + o + (runs if new else []))
                n = sched.n_ph if new else sched.n_lev
                fn = lambda: _build.check(lib.tq_crown_ric_factor(
                    ptrs, Nc, nx, nz, n, float(reg), *launch, st()), "tq_crown_ric_factor")
                fn.keep = ptrs
                return fn, o[:4]
            return make
        return {name: make_with(lib, launch, new) for name, lib, launch, new in forms(sched, nz)}

    def solve_makes(fact, rg, rb, w0, prep):
        sched = crk._get_sched(prep)
        Nc, nx, nz = fact["AB"].shape
        nu = nz - nx
        t = sched.on(dev)
        lev = [t[k] for k in ("lev_ptr", "lev_node", "acc_ptr", "acc_node", "kid_ptr",
                              "kid_idx", "par")]
        runs = [t[k] for k in ("ph_ptr", "run_ptr", "run_node")]
        ins = [fact[k] for k in ("P", "Luu", "K", "Mxu", "AB")] + [rg, rb, w0]

        def make_with(lib, launch, new):
            def make():
                p, k = torch.empty((Nc, nx), **f32), torch.empty((Nc, nu), **f32)
                ws, wv = torch.empty((Nc, nz), **f32), torch.empty((Nc, nz), **f32)
                dz, dl = torch.empty((Nc, nz), **f32), torch.empty((Nc, nx), **f32)
                ptrs = _build.ptr_array(ins + lev + [p, k, ws, wv, dz, dl]
                                        + (runs if new else []))
                n = sched.n_ph if new else sched.n_lev
                fn = lambda: _build.check(lib.tq_crown_ric_solve(
                    ptrs, Nc, nx, nz, n, *launch, st()), "tq_crown_ric_solve")
                fn.keep = ptrs
                return fn, (dz, dl, p, k)
            return make
        return {name: make_with(lib, launch, new) for name, lib, launch, new in forms(sched, nz)}

    def crown_case(what, factor_args, solve_args, timed):
        """Both crown kernels: the factor on ``factor_args`` (hbar, AB, W0,
        prep, nx, reg), the solve on ``solve_args`` (fact, rg, rb, w0,
        prep)."""
        hbar, AB, W0, prep, nx, reg = factor_args
        sched = crk._get_sched(prep)
        nz = hbar.shape[1]
        tag = (f"({what}: Nc={hbar.shape[0]}, nx={nx}, nz={nz}, {sched.n_lev} levels, "
               f"{sched.n_ph} phases, widest {sched.run_width} runs; launch "
               f"{crk._ric_launch(sched, nz)})")
        ref = crk.crown_ric_factor_ref(hbar, AB, W0, prep, nx, reg)
        compare_libs(f"crown_ric_factor {tag}", factor_makes(*factor_args), timed,
                     [ref[k] for k in ("P", "Luu", "K", "Mxu")], FACTOR_RTOL)
        compare_libs(f"crown_ric_solve {tag}", solve_makes(*solve_args), timed,
                     list(crk.crown_ric_solve_ref(*solve_args)), SOLVE_RTOL)

    def first_iteration(fn, key, mod, names):
        """The first call of each kernel ``names`` of ``mod`` in the solve
        fn(opts) of path ``key`` cut to one iteration."""
        o = ipm.IpmOpts(**{**IPM_OPTS[key], "max_iter": 1})
        got, _ = capture(mod, names, lambda: fn(o))
        return {n: c[0] for n, c in got.items()}

    qb = spring_mass_chain(4, 4, 4, 20, device=dev)[0]
    qc2 = spring_mass_chain(4, 4, 3, 7, device=dev)[0]
    crown_names = ("crown_ric_factor", "crown_ric_solve")
    paths = {"B": first_iteration(lambda o: ims.ipm_ms_solve(tm.split_multistage(qb), o), "box",
                                  crk, crown_names),
             f"C{qb.topo.Nn}": first_iteration(lambda o: ipm.ipm_solve(qb, o), "cd", crk,
                                               crown_names),
             f"C{qc2.topo.Nn}": first_iteration(lambda o: ipm.ipm_solve(qc2, o), "cd", crk,
                                                crown_names)}
    for path, got in paths.items():
        (hbar, AB, W0, prep, nx), kw = got["crown_ric_factor"]
        (fact, rg, rb, w0, _), _ = got["crown_ric_solve"]
        rg, rb, w0 = (v.float().contiguous() for v in (rg, rb, w0))
        crown_case(f"path {path}", (hbar, AB, W0, prep, nx, kw.get("reg", 0.0)),
                   (fact, rg, rb, w0, prep), True)
    for k, tree in enumerate(WIDTHS):
        md, Nr, Nh, nx, nu = tree
        hbar, AB, W0, rg, rb, w0, prep = ric_crown_operands(torch, *tree, 90 + k, dev)
        fact = crk.crown_ric_factor_ref(hbar, AB, W0, prep, nx)
        crown_case(f"seeded md={md}, Nr={Nr}, Nh={Nh}", (hbar, AB, W0, prep, nx, 0.0),
                   (fact, rg, rb, w0, prep), True)
    for k, (md, Nr, Nh, nx, nu, reg) in enumerate(CROWN_RIC_EDGES):
        hbar, AB, W0, rg, rb, w0, prep = ric_crown_operands(torch, md, Nr, Nh, nx, nu, 60 + k,
                                                            dev)
        fact = crk.crown_ric_factor_ref(hbar, AB, W0, prep, nx, reg)
        crown_case(f"edge md={md}, Nr={Nr}, Nh={Nh}, reg={reg}",
                   (hbar, AB, W0, prep, nx, reg), (fact, rg, rb, w0, prep), False)

    # ---- ric_chain_factor, whose stage moved into tq_riccati.cuh
    def chain_makes(hbar, AB, reg, dense):
        S, L, nx, nz = AB.shape
        nu = nz - nx

        def make_with(lib):
            def make():
                o = [torch.empty(sh, **f32) for sh in ((S, L, nx, nx), (S, L, nu, nu),
                                                       (S, L, nu, nx), (S, L, nx, nu),
                                                       (S, nz, nz))]
                fn = lambda: _build.check(lib.tq_ric_chain_factor(
                    hbar.data_ptr(), AB.data_ptr(), *(t.data_ptr() for t in o), S, L, nx, nz,
                    int(dense), float(reg), st()), "tq_ric_chain_factor")
                return fn, o
            return make
        return {name: make_with(lib) for name, (lib, _) in libs.items()}

    def chain_case(what, hbar, AB, reg, timed):
        dense = hbar.dim() == 4
        fact, W0 = rk.ric_chain_factor_ref(hbar, AB, reg=reg)
        S, L, nx, nz = AB.shape
        compare_libs(f"ric_chain_factor ({what}: S={S}, L={L}, nx={nx}, nz={nz}, "
                     f"{'dense' if dense else 'diagonal'} hbar)",
                     chain_makes(hbar, AB, reg, dense), timed,
                     [fact[q] for q in ("P", "Luu", "K", "Mxu")] + [W0], FACTOR_RTOL)

    qa = general_cd("qpgen", device=dev)
    got = first_iteration(lambda o: ims.ipm_ms_solve(tm.split_multistage(qa), o), "cd", rk,
                          ("ric_chain_factor",))
    (hbar, AB), kw = got["ric_chain_factor"]
    chain_case("path A", hbar, AB, kw.get("reg", 0.0), True)
    for k, (S, L, nx, nz) in enumerate(RIC_EDGES):
        for dense in (False, True):
            hbar, AB = ric_operands(torch, S, L, nx, nz, dense, k, dev)
            chain_case("edge", hbar, AB, RIC_REG, False)

    sys.stdout.flush()
    wrapper_times(None)
    for p in args.parent:
        sys.stdout.flush()
        res = subprocess.run([sys.executable, __file__, "--wrappers-of", p])
        if res.returncode != 0:
            failed.append(f"wrappers of {p}")
    if failed:
        sys.exit(f"prof_torch_crown_ric: not bit for bit or failed: {failed}")
    print("prof_torch_crown_ric: every library bit for bit the package's at every shape")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The Newton-system and Jay solve kernels ``system_solve`` and
``jay_cr_solve`` (``csrc/system_solve.cu``, ``csrc/jay_cr.cu``) against other
checkouts', on one card.

    python3 scripts/prof_torch_solve_kernels.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name; its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build, this checkout's ``_build`` this one's ("package"). A library
whose system_solve takes a thread count (the one-block kernel) gets one
thread a chain or group, as its wrapper gave it; one whose jay_cr_solve
takes six scratch arrays gets them. The operands:
- system_solve: ``chip_smoke.system_operands`` at ``chip_smoke.SYSTEM_SHAPES``
  (the quadcopter headline, sdunes' bootstrap crown with G = 32, 1024
  scenarios, crown groups of 48 rows, three chains of one node);
- jay_cr_solve: ``chip_smoke.jay_operands`` at every P of
  ``chip_smoke.JAY_PS``, b of ``JAY_BS`` and shift mode of ``JAY_MODES``,
  the same with the exactly singular block, and the operands of the cold
  sdunes solve of spring_mass_chain(4,4,4,20) (``models.SDUNES_OPTS``) at
  its first iteration and its first final-phase iteration (captured).

For every library and shape: whether its outputs equal the package's bit
for bit (``torch.equal``) and the package's largest difference from the
plain twin (held to ``chip_smoke.SOLVE_RTOL`` where the system is not
singular); at the timed shapes (system_solve's five, jay_cr_solve's P =
255, b = 4 always and P = 1023, b = 16 on the fly with the singular block,
and the captured ones) ms a launch on the card alone (20 launches in a
CUDA graph, ``chip_smoke.graph_ms``) and of one C call timed alone (the
median of REPS, ``chip_smoke.cuda_ms``; outputs allocated beforehand);
beside the headline shapes the library call that computes the same
solve: ``torch.cholesky_solve`` with the whole tree's factor as one dense
lower matrix (``chip_smoke.system_matrix``) and ``torch.linalg.solve_ex``
of the dense Jay matrix (``chip_smoke.jay_matrix``), in a graph and alone,
with their distances to the twin. Then, through each checkout's own Python
wrappers (the other checkouts' in a child process that imports their
package), one call timed alone of both kernels at their headlines. Exits
non-zero if a launch fails, a result leaves its tolerance or a library
differs from the package in a bit. Needs CUDA and nvcc; imports nothing of
JAX.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAY_TIMED = ((255, 4, -1.0, False), (1023, 16, 1e-6, True))


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound
    by that checkout's own ``_build``, and its forms: (lib, system_solve
    without a thread count, jay_cr_solve with one scratch)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sig = mod._SIGNATURES
    return mod.lib(), len(sig["tq_system_solve"]) == 23, "tq_jay_cr_scratch" in sig


def wrapper_times(parent):
    """One call timed alone through the wrappers of the package imported
    from ``parent`` (this checkout when None): system_solve at the headline
    and jay_cr_solve at P = 255, b = 4 (shift always) and P = 1023, b = 16;
    printed, one line each."""
    if parent is not None:
        sys.path.insert(0, str(Path(parent).resolve()))
    import torch
    from treeqp_tpu_torch.ops import jay_kernel as jk
    from treeqp_tpu_torch.ops import system_kernels as sk
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import SYSTEM_SHAPES, cuda_ms, jay_operands, system_operands
    from prof_common import card
    name = "package" if parent is None else Path(parent).resolve().name
    dev = torch.device("cuda", 0)
    sargs = system_operands(torch, *SYSTEM_SHAPES[0][1], 1, dev)
    rows = [("system_solve (headline)", lambda: sk.system_solve(*sargs))]
    for P, b, tol, sing in JAY_TIMED:
        j = jay_operands(torch, P, b, 2, dev, singular=sing)
        rows.append((f"jay_cr_solve (P={P}, b={b})",
                     lambda j=j, tol=tol: jk.jay_cr_solve(*j, tol)))
    for timed_pass in (False, True):  # the first pass warms the card and the host path
        for what, fn in rows:
            t = cuda_ms(torch, fn, 50)
            if timed_pass:
                print(f"wrapper {what} ({name}): one call timed alone {t:.4f} ms (host path "
                      f"included) on {card()}", flush=True)


def sdunes_operands(torch, dev):
    """jay_cr_solve's operands at the first iteration and the first
    final-phase iteration of the cold sdunes solve of
    spring_mass_chain(4,4,4,20) at models.SDUNES_OPTS."""
    from treeqp_tpu_torch.models import SDUNES_OPTS, spring_mass_chain
    from treeqp_tpu_torch.ops import jay_kernel as jk
    from treeqp_tpu_torch.solvers import sdunes as sd
    sqp = sd.scenario_data(spring_mass_chain(4, 4, 4, 20, device=dev)[0])
    calls, orig = [], jk.jay_cr_solve

    def stand_in(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)
    stand_in.launches = 0  # the wrapper counts through its module's name
    jk.jay_cr_solve = stand_in
    try:
        _, _, _, info = sd.sdunes_solve(sqp, None, None, sd.SdunesOpts(**SDUNES_OPTS))
    finally:
        jk.jay_cr_solve = orig
    (d0, o0, r0), k0 = calls[0]
    (d1, o1, r1), k1 = calls[info["iter_f32"]]
    return {"sdunes cold start": (d0, o0, r0, k0["shift"], k0["reg_tol"]),
            "sdunes first final-phase iteration": (d1, o1, r1, k1["shift"], k1["reg_tol"])}


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
        sys.exit("prof_torch_solve_kernels: needs a CUDA device")
    from chip_smoke import (JAY_BS, JAY_MODES, JAY_PS, SOLVE_RTOL, SYSTEM_SHAPES, cuda_ms,
                            graph_ms, jay_matrix, jay_operands, system_matrix,
                            system_operands, system_vector)
    from prof_common import card as card_name
    import treeqp_tpu_torch  # noqa: F401  (pins full-precision f32)
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import jay_kernel as jk
    from treeqp_tpu_torch.ops import system_kernels as sk
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    libs = {"package": (_build.lib(), True, True),
            **{Path(p).name: parent_lib(p) for p in args.parent}}
    st = lambda: _build.stream(dev)  # the current stream: a graph captures on its own
    f32 = dict(dtype=torch.float32, device=dev)
    failed = []

    def twin_err(what, got, ref, hold=True):
        err = 0.0
        for g, r in zip(got, ref):
            e = float((g - r).abs().max())
            if hold and not (bool(torch.isfinite(g).all())
                             and e <= SOLVE_RTOL * max(1.0, float(r.abs().max()))):
                print(f"{what}: differs from the twin by {e:.3e}")
                failed.append(f"{what} vs the twin")
            err = max(err, e)
        return err

    def compare_libs(what, make, timed, ref, hold=True):
        """For every library: fn, outs = make(lib, forms); run, check
        against the package bit for bit and the package against the twin
        ``ref``; time where ``timed``. Returns the package's fn."""
        outs, fns, line = {}, {}, []
        for name, (lib, *forms) in libs.items():
            fn, o = make(lib, *forms)
            fn()
            torch.cuda.synchronize()
            outs[name], fns[name] = [t.clone() for t in o], fn
        err = twin_err(what, outs["package"], ref, hold)
        for name in libs:
            if name != "package":
                same = [torch.equal(a, b) for a, b in zip(outs["package"], outs[name])]
                line.append(f"bit for bit {name}: {all(same)}")
                if not all(same):
                    failed.append(f"{what} vs {name}")
        if timed:
            for name, fn in fns.items():
                print(f"{what} {name}: {graph_ms(torch, fn):.4f} ms in a CUDA graph, "
                      f"{cuda_ms(torch, fn, args.reps):.4f} ms one C call timed alone on {card}",
                      flush=True)
        print(f"{what}: package max |diff| to the twin {err:.3e}; {', '.join(line)}", flush=True)
        return fns["package"]

    # ---- system_solve
    for seed, (what, shape) in enumerate(SYSTEM_SHAPES):
        Ls, CUs, CholW, CholUt, rg, rch, prep, rid = system_operands(torch, *shape, seed, dev)
        sched = ckr._get_sched(prep)
        S, L, n, _ = Ls.shape
        t = sched.on(dev)
        ids = sk.ms_sched(prep, rid, dev)
        ptrs = [a.data_ptr() for a in (Ls, CUs, CholW, CholUt, rg, rch)] + [
            t[key].data_ptr() for key in ("lev_ptr", "lev_child", "lev_parent", "lev_slot")] + [
            ids["g_of"].data_ptr(), ids["slot"].data_ptr()]
        threads = min(1024, max(32, -(-max(S, sched.width) // 32) * 32))

        def make(lib, no_threads, _jay):
            o = [torch.empty((sched.NpG, sched.G), **f32) for _ in range(3)] + [
                torch.empty((S, L, n), **f32)]
            tail = () if no_threads else (threads,)
            fn = lambda: _build.check(lib.tq_system_solve(
                *ptrs, *(a.data_ptr() for a in o), S, L, n, sched.NpG, sched.K, sched.n_lev,
                *tail, st()), "tq_system_solve")
            return fn, (o[2], o[3])
        tag = f"system_solve ({what}: S={S}, L={L}, n={n}, NpG={sched.NpG}, G={sched.G})"
        ref = sk.system_solve_ref(Ls, CUs, CholW, CholUt, rg, rch, prep, rid)
        compare_libs(tag, make, True, ref)
        if seed == 0:
            F = system_matrix(torch, Ls, CUs, CholW, CholUt, prep, rid)
            v = system_vector(torch, rg, rch, prep)
            lib_fn = lambda: torch.cholesky_solve(v, F)
            lib_err = twin_err(f"{tag} cholesky_solve", system_vector(torch, rg, rch, prep,
                                                                        x=lib_fn()), ref)
            print(f"{tag} cholesky_solve [{F.shape[0]}]^2 dense factor: "
                  f"{graph_ms(torch, lib_fn):.4f} ms in a CUDA graph, "
                  f"{cuda_ms(torch, lib_fn, args.reps):.4f} ms alone, |diff| to the twin "
                  f"{lib_err:.3e} on {card}", flush=True)
            del F

    # ---- jay_cr_solve
    def jay_make(j, tol):
        diag, off, rhs, shift = j
        P, b = rhs.shape
        ins = [a.data_ptr() for a in (diag, off, rhs)] + [
            None if shift is None else shift.data_ptr()]
        n_scr = int(libs["package"][0].tq_jay_cr_scratch(P, b))

        def make(lib, _sys, one_scratch):
            x = torch.empty((P, b), **f32)
            if one_scratch:
                scr = [torch.empty((n_scr,), **f32) if n_scr else None]
            else:  # D, C, r, Z1s, Z2s, zrs
                scr = [torch.empty(sh, **f32) for sh in ((P, b, b), (P, b, b), (P, b),
                                                           (P, b, b), (P, b, b), (P, b))]
            fn = lambda: _build.check(lib.tq_jay_cr_solve(
                *ins, x.data_ptr(), *(None if a is None else a.data_ptr() for a in scr), P, b,
                float(tol), st()), "tq_jay_cr_solve")
            return fn, (x,)
        return make

    modes = {None: "none", -1.0: "always", 1e-6: "on the fly"}
    k = 0
    for P in JAY_PS:
        for b in JAY_BS:
            for sing in (False, True):
                for tol in JAY_MODES:
                    k += 1
                    if sing and (tol is None or P < 2):
                        continue  # singular without a shift: no solution to hold
                    j = jay_operands(torch, P, b, 100 + k, dev, singular=sing)
                    if tol is None:
                        j[3] = None
                    use = -1.0 if tol is None else tol
                    timed = (P, b, tol, sing) in JAY_TIMED
                    tag = (f"jay_cr_solve (P={P}, b={b}, shift {modes[tol]}"
                           + (", a singular block" if sing else "") + ")")
                    ref = [jk.jay_cr_solve_ref(*j, use)]
                    fn = compare_libs(tag, jay_make(j, use), timed, ref)
                    if timed:
                        M = jay_matrix(torch, j[0], j[1], j[3], use)
                        rv = j[2].reshape(-1, 1)
                        lib_fn = lambda: torch.linalg.solve_ex(M, rv)[0]
                        lib_err = twin_err(f"{tag} linalg.solve",
                                           [lib_fn().reshape(P, b)], ref)
                        print(f"{tag} linalg.solve_ex [{M.shape[0]}]^2: "
                              f"{graph_ms(torch, lib_fn):.4f} ms in a CUDA graph, "
                              f"{cuda_ms(torch, lib_fn, args.reps):.4f} ms alone, |diff| to "
                              f"the twin {lib_err:.3e} on {card}", flush=True)
                        del M
    # the sdunes solve's operands: its first final-phase system is near
    # singular, so the twin's distance is printed there, not held
    for what, (d, o, r, sh, tol) in sdunes_operands(torch, dev).items():
        j = [d, o, r, sh]
        ref = [jk.jay_cr_solve_ref(*j, tol)]
        compare_libs(f"jay_cr_solve ({what}, P={d.shape[0]}, b={d.shape[-1]})",
                     jay_make(j, tol), True, ref, hold="cold" in what)

    sys.stdout.flush()
    wrapper_times(None)
    for p in args.parent:
        sys.stdout.flush()
        res = subprocess.run([sys.executable, __file__, "--wrappers-of", p])
        if res.returncode != 0:
            failed.append(f"wrappers of {p}")
    if failed:
        sys.exit(f"prof_torch_solve_kernels: not bit for bit or failed: {failed}")


if __name__ == "__main__":
    main()

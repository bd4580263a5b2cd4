#!/usr/bin/env python3
"""The right-hand-side sweep kernels ``chain_full_solve_mat`` and
``ric_chain_bwd`` (``csrc/chain_full_solve.cu``, ``csrc/ric_chain.cu``)
against other checkouts', on one card.

    python3 scripts/prof_torch_rhs_sweeps.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name; its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build, this checkout's ``_build`` this one's ("package"). The operands:
- chain_full_solve_mat: the cold sdunes solve's (spring_mass_chain(4,4,4,20)
  at ``models.SDUNES_OPTS``) at its first final-phase iteration, m = 5 and
  m = 1 (captured), and ``chip_smoke.full_operands`` at every shape of
  ``chip_smoke.FULL_EDGES`` (n 1, 8, 9, 16; L 1, 2, 20, 40; m 1, 5, 17;
  S = 5);
- ric_chain_bwd: the first f32 iteration's of IPM paths A (``ipm_ms_solve``
  on ``general_cd("qpgen")``: dense hbar) and B (the same tree box-only:
  diagonal hbar) at ``models.IPM_OPTS`` (captured), and
  ``chip_smoke.ric_operands`` / ``ric_rhs`` at every shape of
  ``chip_smoke.RIC_EDGES`` with both hbar forms, on the twin's factors.

For every library and shape: whether its outputs equal the package's bit
for bit (``torch.equal``) and the package's largest difference from the
plain twin (held to ``chip_smoke.SOLVE_RTOL``); at the captured shapes ms
a launch on the card alone (20 launches in a CUDA graph,
``chip_smoke.graph_ms``) and of one C call timed alone (the median of
REPS, ``chip_smoke.cuda_ms``; outputs allocated beforehand); beside them
the library calls that compute the same function: ``torch.cholesky_solve``
with each chain's factor as one lower matrix
(``chip_smoke.chain_factor_matrix``) at m = 5, and at path A
``torch.linalg.ldl_factor_ex`` of each chain's KKT matrix
(``chip_smoke.ric_chain_matrix``, the yardstick of ric_chain_factor) and
``ldl_solve`` with its factors (of ric_chain_bwd and ric_chain_fwd
together, beside the package's two kernels' sum), alone (neither runs
under CUDA graph capture: MAGMA's batched potrs aborts, cuSOLVER's sytrf
fails), with their distances to the twins. Then, through each checkout's own
Python wrappers (the other checkouts' in a child process that imports
their package), one call timed alone of both kernels on seeded operands
of the captured shapes. Exits non-zero if a launch fails, a result leaves
its tolerance or a library differs from the package in a bit. Needs CUDA
and nvcc; imports nothing of JAX.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# seeded stand-ins of the captured shapes for the wrappers' times:
# chain_full_solve_mat (S, L, n, m) and ric_chain_bwd (S, L, nx, nz, dense)
WRAPPER_FULL = ((256, 20, 8, 5), (256, 20, 8, 1))
WRAPPER_RIC = ((256, 16, 8, 9, True), (256, 16, 8, 9, False))


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound by
    that checkout's own ``_build``."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib()


def wrapper_times(parent):
    """One call timed alone through the wrappers of the package imported
    from ``parent`` (this checkout when None) at WRAPPER_FULL and
    WRAPPER_RIC; printed, one line each."""
    if parent is not None:
        sys.path.insert(0, str(Path(parent).resolve()))
    import torch
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import cuda_ms, full_operands, ric_operands, ric_rhs
    from prof_common import card
    name = "package" if parent is None else Path(parent).resolve().name
    dev = torch.device("cuda", 0)
    rows = []
    for S, L, n, m in WRAPPER_FULL:
        Ls, CUs, rhs = full_operands(torch, S, L, n, m, 1, dev)
        rows.append((f"chain_full_solve_mat (S={S}, L={L}, n={n}, m={m})",
                     lambda a=(Ls, CUs, rhs): ck.chain_full_solve_mat(*a)))
    for S, L, nx, nz, dense in WRAPPER_RIC:
        hbar, AB = ric_operands(torch, S, L, nx, nz, dense, 2, dev)
        rg, rb, _ = ric_rhs(torch, S, L, nx, nz, 3, dev)
        fact = rk.ric_chain_factor_ref(hbar, AB, 1e-6)[0]
        rows.append((f"ric_chain_bwd (S={S}, L={L}, nx={nx}, nz={nz}, "
                     f"{'dense' if dense else 'diagonal'} hbar)",
                     lambda a=(fact, rg, rb): rk.ric_chain_bwd(*a)))
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
        sys.exit("prof_torch_rhs_sweeps: needs a CUDA device")
    from chip_smoke import (FULL_EDGES, RIC_EDGES, RIC_REG, SOLVE_RTOL, chain_factor_matrix,
                            cuda_ms, full_operands, graph_ms, ric_chain_ldl, ric_operands,
                            ric_rhs)
    from prof_common import capture, card as card_name
    import treeqp_tpu_torch  # noqa: F401  (pins full-precision f32)
    from treeqp_tpu_torch.models import (IPM_OPTS, SDUNES_OPTS, general_cd,
                                         spring_mass_chain)
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    from treeqp_tpu_torch.solvers import ipm
    from treeqp_tpu_torch.solvers import ipm_multistage as ims
    from treeqp_tpu_torch.solvers import sdunes as sd
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    libs = {"package": _build.lib(), **{Path(p).name: parent_lib(p) for p in args.parent}}
    st = lambda: _build.stream(dev)  # the current stream: a graph captures on its own
    f32 = dict(dtype=torch.float32, device=dev)
    failed = []

    def twin_err(what, got, ref):
        err = 0.0
        for g, r in zip(got, ref):
            e = float((g - r).abs().max())
            if not (bool(torch.isfinite(g).all())
                    and e <= SOLVE_RTOL * max(1.0, float(r.abs().max()))):
                print(f"{what}: differs from the twin by {e:.3e}")
                failed.append(f"{what} vs the twin")
            err = max(err, e)
        return err

    def compare_libs(what, make, timed, ref):
        """For every library: fn, outs = make(lib); run, check against the
        package bit for bit and the package against the twin ``ref``; time
        where ``timed``. Returns the package's (graph ms, alone ms) where
        timed."""
        outs, fns, line, times = {}, {}, [], None
        for name, lib in libs.items():
            fn, o = make(lib)
            fn()
            torch.cuda.synchronize()
            outs[name], fns[name] = [t.clone() for t in o], fn
        err = twin_err(what, outs["package"], ref)
        for name in libs:
            if name != "package":
                same = [torch.equal(a, b) for a, b in zip(outs["package"], outs[name])]
                line.append(f"bit for bit {name}: {all(same)}")
                if not all(same):
                    failed.append(f"{what} vs {name}")
        if timed:
            for name, fn in fns.items():
                g, a = graph_ms(torch, fn), cuda_ms(torch, fn, args.reps)
                if name == "package":
                    times = (g, a)
                print(f"{what} {name}: {g:.4f} ms in a CUDA graph, {a:.4f} ms one C call "
                      f"timed alone on {card}", flush=True)
        print(f"{what}: package max |diff| to the twin {err:.3e}; {', '.join(line)}", flush=True)
        return times

    def library(what, fn, note):
        """A library call's time alone. Not in a CUDA graph: batched
        cholesky_solve runs MAGMA, which aborts the process under capture,
        and cuSOLVER's sytrf fails under capture."""
        a = cuda_ms(torch, fn, min(args.reps, 10))
        print(f"{what}: {a:.4f} ms alone ({note}) on {card}", flush=True)
        return a

    # ---- chain_full_solve_mat
    def full_make(Ls, CUs, rhs):
        S, L, n, m = rhs.shape

        def make(lib):
            z = torch.empty((S, L, n, m), **f32)
            fn = lambda: _build.check(lib.tq_chain_full_solve_mat(
                Ls.data_ptr(), CUs.data_ptr(), rhs.data_ptr(), z.data_ptr(), S, L, n, m, st()),
                "tq_chain_full_solve_mat")
            return fn, (z,)
        return make

    sqp = sd.scenario_data(spring_mass_chain(4, 4, 4, 20, device=dev)[0])
    calls, (_, _, _, info) = capture(ck, ("chain_full_solve_mat",), lambda: sd.sdunes_solve(
        sqp, None, None, sd.SdunesOpts(**SDUNES_OPTS)))
    c0 = info["iter_f32"]
    for k, ((Ls, CUs, rhs), _) in enumerate(calls["chain_full_solve_mat"][c0:c0 + 2]):
        S, L, n, m = rhs.shape
        tag = (f"chain_full_solve_mat (sdunes first final-phase iteration, solve {k + 1}: "
               f"S={S}, L={L}, n={n}, m={m})")
        compare_libs(tag, full_make(Ls, CUs, rhs), True,
                     [ck.chain_full_solve_mat_ref(Ls, CUs, rhs)])
        if k == 0:
            F = chain_factor_matrix(torch, Ls, CUs)
            B = torch.flip(rhs, (1,)).reshape(S, L * n, m).contiguous()
            lib_fn = lambda: torch.cholesky_solve(B, F)
            lib_err = twin_err(f"{tag} cholesky_solve", [torch.flip(
                lib_fn().reshape(rhs.shape), (1,))], [ck.chain_full_solve_mat_ref(Ls, CUs, rhs)])
            library(f"{tag} cholesky_solve", lib_fn,
                    f"[{L * n}]^2 lower factor a chain, |diff| to the twin {lib_err:.3e}")
    for k, (S, L, n, m) in enumerate(FULL_EDGES):
        Ls, CUs, rhs = full_operands(torch, S, L, n, m, 60 + k, dev)
        compare_libs(f"chain_full_solve_mat (S={S}, L={L}, n={n}, m={m})",
                     full_make(Ls, CUs, rhs), False, [ck.chain_full_solve_mat_ref(Ls, CUs, rhs)])

    # ---- ric_chain_bwd
    def bwd_make(fact, rg, rb):
        S, L, nx, nz = fact["AB"].shape
        ins = [fact["P"], fact["Luu"], fact["Mxu"], fact["AB"], rg, rb]

        def make(lib):
            o = [torch.empty(sh, **f32) for sh in ((S, L, nx), (S, L, nz - nx), (S, nz))]
            ptrs = _build.ptr_array(ins + o)  # kept alive by the closure
            fn = lambda: _build.check(lib.tq_ric_chain_bwd(ptrs, S, L, nx, nz, st()),
                                      "tq_ric_chain_bwd")
            return fn, o
        return make

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
        (fact, rg, rb), _ = got["ric_chain_bwd"]
        rg, rb = rg.float().contiguous(), rb.float().contiguous()
        S, L, nx, nz = fact["AB"].shape
        tag = f"ric_chain_bwd (path {path}: S={S}, L={L}, nx={nx}, nz={nz})"
        times = compare_libs(tag, bwd_make(fact, rg, rb), True,
                             rk.ric_chain_bwd_ref(fact, rg, rb))
        (_, p_, k_, _, zr), _ = got["ric_chain_fwd"]
        zr = zr.float().contiguous()
        fwd = lambda a=(fact, p_, k_, rb, zr): rk.ric_chain_fwd(*a)
        print(f"ric_chain_bwd + ric_chain_fwd (path {path}, package): "
              f"{times[0] + graph_ms(torch, fwd):.4f} ms in a CUDA graph, "
              f"{times[1] + cuda_ms(torch, fwd, args.reps):.4f} ms alone (the fwd through its "
              f"wrapper) on {card}", flush=True)
    for k, (S, L, nx, nz) in enumerate(RIC_EDGES):
        for dense in (False, True):
            hbar, AB = ric_operands(torch, S, L, nx, nz, dense, k, dev)
            rg, rb, _ = ric_rhs(torch, S, L, nx, nz, 50 + k, dev)
            fact = rk.ric_chain_factor_ref(hbar, AB, reg=RIC_REG)[0]
            compare_libs(f"ric_chain_bwd (S={S}, L={L}, nx={nx}, nz={nz}, "
                         f"{'dense' if dense else 'diagonal'} hbar)", bwd_make(fact, rg, rb),
                         False, rk.ric_chain_bwd_ref(fact, rg, rb))

    # the library calls at path A: ldl_factor_ex of each chain's KKT matrix
    # and ldl_solve with its factors (for ric_chain_bwd + ric_chain_fwd)
    (hbar, AB), kw = paths["A"]["ric_chain_factor"]
    (_, rg, rb), _ = paths["A"]["ric_chain_bwd"]
    lib_fac, lib_sol, info_c, err_l = ric_chain_ldl(
        torch, hbar, AB, kw.get("reg", 0.0), rg.float().contiguous(), rb.float().contiguous(),
        paths["A"]["ric_chain_fwd"][0][4].float().contiguous())
    library("ric_chain_factor (path A) ldl_factor_ex", lib_fac,
            f"{AB.shape[0]} [{AB.shape[1] * (AB.shape[2] + AB.shape[3])}]^2 KKT matrices, info "
            f"max {info_c}")
    library("ric_chain_bwd + ric_chain_fwd (path A) ldl_solve", lib_sol,
            f"for bwd + fwd, |diff| to ric_chain_fwd_ref(ric_chain_bwd_ref) {err_l:.3e}")
    del lib_fac, lib_sol

    sys.stdout.flush()
    wrapper_times(None)
    for p in args.parent:
        sys.stdout.flush()
        res = subprocess.run([sys.executable, __file__, "--wrappers-of", p])
        if res.returncode != 0:
            failed.append(f"wrappers of {p}")
    if failed:
        sys.exit(f"prof_torch_rhs_sweeps: not bit for bit or failed: {failed}")


if __name__ == "__main__":
    main()

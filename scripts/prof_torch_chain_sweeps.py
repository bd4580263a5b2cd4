#!/usr/bin/env python3
"""The serial chain kernels (``chain_factor``, ``csrc/chain_factor.cu``;
the sweeps ``chain_solve_bwd`` and ``chain_forward``,
``csrc/chain_sweeps.cu``), the cyclic-reduction kernels
(``chain_cr_precompute``, ``chain_solve_bwd_cr`` and ``chain_forward_cr``,
``csrc/chain_cr.cu``)
and ``df_reduce_flat`` (``csrc/df_reduce.cu``) against other checkouts',
on one card.

    python3 scripts/prof_torch_chain_sweeps.py --parent DIR [--parent DIR2 ...] [--reps 50]

Each DIR is another checkout of the repository (for example a ``git
archive`` of the parent commit), named by its directory's name. Its own
``treeqp_tpu_torch/ops/_build.py`` builds its kernel library into
DIR/build; this checkout's ``_build`` builds this one's ("package").
Chain shapes: ``scripts/prof_torch_chain_cr.py``'s three (random S=256,
L=16, n=8; the pruned quadcopter's first chain factors, S=128, L=16, n=6;
sdunes' S=256, L=20, n=8), a long chain of the widest blocks (S=4, L=130,
n=16) and an odd one (S=5, L=17, n=5: the 4-byte copies); chain_factor
runs on the blocks those factors were made from.

For every library and chain shape: chain_factor's and the two sweeps' ms a
launch on the card alone (20 launches captured in a CUDA graph, by
``chip_smoke.graph_ms``) and of one launch timed alone (the median of
REPS, host launch included, by ``chip_smoke.cuda_ms``; the C function
called directly, outputs allocated beforehand), their largest difference
from the plain twins (held to ``chip_smoke.FACTOR_RTOL`` /
``SOLVE_RTOL``), and whether each library's outputs (Ls, CUs, schur0; ys,
radd0, dls) equal the package's bit for bit (``torch.equal``); per shape
also ``torch.linalg.cholesky_ex``'s ms on each chain as one matrix
(``chip_smoke.chain_blocks_matrix``), alone and in a graph. Then
``chain_cr_precompute`` at those five shapes and at ``chip_smoke.CR_EDGES``
(``cr_operands``): each library's ms alone and in a graph, each held to
the twin (``FACTOR_RTOL``) and
its Abwd, Bfwd to the package's bit for bit, beside two batched
``torch.linalg.solve_triangular`` calls (A's and B's: a reference, since
two calls are no library yardstick). Then the CR sweeps on the package's
precompute operands at the same shapes: each library's ms alone and in a
graph (the scratch as each library's own rule sizes it:
``tq_chain_cr_sweep_launch`` where the library has it, else double
buffers of 2 L (n^2 + n) floats a chain past 227 KB), the largest
difference from the twins (``SOLVE_RTOL``) and whether ys, radd0 and dls
equal the package's bit for bit, beside batched
``torch.linalg.solve_triangular`` on each chain's factor as one matrix
(``chip_smoke.chain_factor_matrix``); and each library's SASS opcode
counts of the three CR kernels (``sass_opcodes.opcode_counts``: FFMA /
FMUL / FADD, LDL / STL) and the precompute's ptxas registers and spills.
Then df_reduce_flat at n = 26,624 (the bench path's directional derivative) and
n = 2^20 + 3, seeded: each library's ms alone and in a graph beside
``torch.sum``'s, each result held bit for bit to the twin. Exits non-zero
if a launch fails or a result leaves its tolerance. Needs CUDA and nvcc;
imports nothing of JAX.
"""

import argparse
import ctypes
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import (CR_EDGES, CR_SEED, FACTOR_RTOL, SOLVE_RTOL,  # noqa: E402
                        chain_blocks_matrix, chain_factor_matrix, cr_operands, cuda_ms,
                        graph_ms)
from prof_common import card as card_name  # noqa: E402
from sass_opcodes import opcode_counts  # noqa: E402

REDUCE_SIZES = (26624, 2 ** 20 + 3)


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound
    by that checkout's own ``_build``, and its path."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib(), mod.build()


def cr_scratch(lib, L, n):
    """Floats of global scratch a chain that ``lib``'s CR sweeps take at
    (L, n), by the library's own rule; 0 for none."""
    if hasattr(lib, "tq_chain_cr_sweep_launch"):
        out = (ctypes.c_int * 2)()
        lib.tq_chain_cr_sweep_launch(L, n, out)
        return L * (n * n + n) if out[1] > 227 * 1024 else 0
    floats = 2 * (L * n * n + L * n)
    return floats if floats * 4 > 227 * 1024 else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, action="append",
                    help="another checkout of the repository to compare with (repeatable)")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_chain_sweeps: needs a CUDA device")
    from prof_torch_chain_cr import capture_calls
    from prof_torch_chain_cr import shapes as cr_shapes
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import chain_cr as ccr
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import df_reduce as dr
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    built = {"package": (_build.lib(), _build.build()),
             **{Path(p).name: parent_lib(p) for p in args.parent}}
    libs = {name: lib for name, (lib, _) in built.items()}
    st = lambda: _build.stream(dev)  # the current stream: a graph captures on its own

    def check(name, what, got, ref, rtol):
        err = 0.0
        for g, r in zip(got, ref):
            e = float((g - r).abs().max())
            if not e <= rtol * max(1.0, float(r.abs().max())):
                sys.exit(f"{name} ({what}): differs from the twin by {e:.3e}")
            err = max(err, e)
        return err

    # the factors, each with the blocks chain_factor made it from
    ops = {}
    calls = capture_calls(ck, ("chain_factor",),
                          lambda: ops.update(cr_shapes(torch, dev)))["chain_factor"]
    blocks = {tag: next(a for a, out in calls if out[0] is ops[tag][0]) for tag in ops}
    rng = np.random.default_rng(2)
    for tag, (S, L, n) in (("long", (4, 130, 16)), ("odd", (5, 17, 5))):
        A = rng.standard_normal((S, L, n, n))
        Wc = torch.tensor(A @ A.transpose(0, 1, 3, 2) + 3.0 * np.eye(n), **f32)
        Utc = torch.tensor(0.3 * rng.standard_normal((S, L, n, n)), **f32)
        blocks[tag] = (Wc, Utc)
        Ls, CUs, _ = ck.chain_factor_ref(Wc, Utc)
        ops[tag] = (Ls, CUs, torch.tensor(rng.standard_normal((S, L, n)), **f32),
                    torch.tensor(rng.standard_normal((S, n)), **f32))

    def timed(fn):
        return graph_ms(torch, fn), cuda_ms(torch, fn, args.reps)

    for tag, (Ls, CUs, res, droot) in ops.items():
        S, L, n, _ = Ls.shape
        Wc, Utc = blocks[tag]
        f_ref = ck.chain_factor_ref(Wc, Utc)
        ys_r, radd_r = ck.chain_solve_bwd_ref(Ls, CUs, res)
        dls_r = ck.chain_forward_ref(Ls, CUs, ys_r, droot)
        outs = {}
        for name, lib in libs.items():
            fac = (torch.empty((S, L, n, n), **f32), torch.empty((S, L, n, n), **f32),
                   torch.empty((S, n, n), **f32))
            ys = torch.empty((S, L, n), **f32)
            radd = torch.empty((S, n), **f32)
            dls = torch.empty((S, L, n), **f32)

            def factor():
                _build.check(lib.tq_chain_factor(
                    Wc.data_ptr(), Utc.data_ptr(), *(t.data_ptr() for t in fac), S, L, n, st()),
                    f"{name} factor")

            def bwd():
                _build.check(lib.tq_chain_solve_bwd(
                    Ls.data_ptr(), CUs.data_ptr(), res.data_ptr(), ys.data_ptr(),
                    radd.data_ptr(), S, L, n, st()), f"{name} bwd")

            def fwd():
                _build.check(lib.tq_chain_forward(
                    Ls.data_ptr(), CUs.data_ptr(), ys_r.data_ptr(), droot.data_ptr(),
                    dls.data_ptr(), S, L, n, st()), f"{name} fwd")
            factor()
            bwd()
            fwd()
            torch.cuda.synchronize()
            e_f = check(name, f"{tag} factor", fac, f_ref, FACTOR_RTOL)
            e_s = check(name, f"{tag} sweeps", (ys, radd, dls), (ys_r, radd_r, dls_r), SOLVE_RTOL)
            outs[name] = [t.clone() for t in (*fac, ys, radd, dls)]
            t_c, t_b, t_f = timed(factor), timed(bwd), timed(fwd)
            print(f"{tag} (S={S}, L={L}, n={n}) {name}: chain_factor {t_c[0]:.4f} ms, bwd "
                  f"{t_b[0]:.4f} ms, fwd {t_f[0]:.4f} ms in a CUDA graph (one launch timed "
                  f"alone: {t_c[1]:.4f} / {t_b[1]:.4f} / {t_f[1]:.4f} ms), max |diff| to the "
                  f"twins {e_f:.3e} (factor) / {e_s:.3e} (sweeps) on {card}")
        M = chain_blocks_matrix(torch, Wc, Utc)
        t_l = timed(lambda: torch.linalg.cholesky_ex(M).L)
        print(f"{tag} (S={S}, L={L}, n={n}) cholesky_ex of each chain's [L n, L n] matrix: "
              f"{t_l[0]:.4f} ms in a CUDA graph, {t_l[1]:.4f} ms alone on {card}")
        for name in libs:
            if name != "package":
                same = [torch.equal(a, b) for a, b in zip(outs["package"], outs[name])]
                print(f"{tag}: package bit for bit equal to {name}: chain_factor "
                      f"{all(same[:3])} (Ls, CUs, schur0 {same[:3]}), sweeps {all(same[3:])}")

    # chain_cr_precompute at the five shapes and CR_EDGES
    cr_ops = dict(ops)
    for k, (S, L, n) in enumerate(CR_EDGES):
        cr_ops[f"edge S={S} L={L} n={n}"] = cr_operands(torch, S, L, n, CR_SEED + k, dev)
    pre_equal = True
    for tag, (Ls, CUs, _, _) in cr_ops.items():
        S, L, n, _ = Ls.shape
        ref = ccr.chain_cr_precompute_ref(Ls, CUs)
        threads, smem = ccr.precompute_launch(n)
        outs, line = {}, []
        for name, lib in libs.items():
            Ab, Bf = torch.empty((S, L, n, n), **f32), torch.empty((S, L, n, n), **f32)

            def pre(lib=lib, Ab=Ab, Bf=Bf, name=name):
                _build.check(lib.tq_chain_cr_precompute(
                    Ls.data_ptr(), CUs.data_ptr(), Ab.data_ptr(), Bf.data_ptr(), S, L, n,
                    st()), f"{name} precompute")
            pre()
            torch.cuda.synchronize()
            e = check(name, f"{tag} precompute", (Ab, Bf), ref, FACTOR_RTOL)
            outs[name] = (Ab, Bf)
            t = timed(pre)
            line.append(f"{name} {t[0]:.4f} ms in a graph, {t[1]:.4f} alone (|diff| {e:.3e})")
        Lh, Cn = Ls[:, :-1].contiguous(), CUs[:, 1:].contiguous()
        LT, CT = Ls.mT.contiguous(), CUs.mT.contiguous()
        t_l = timed(lambda: (torch.linalg.solve_triangular(Lh, Cn, upper=False) if L > 1
                             else None, torch.linalg.solve_triangular(LT, CT, upper=True)))
        same = {name: torch.equal(outs[name][0], outs["package"][0])
                and torch.equal(outs[name][1], outs["package"][1]) for name in outs}
        pre_equal = pre_equal and all(same.values())
        print(f"{tag} (S={S}, L={L}, n={n}) chain_cr_precompute (package launch: {threads} "
              f"threads, {smem} B): "
              + "; ".join(line) + f"; two batched solve_triangular (A, B) {t_l[0]:.4f} ms in "
              f"a graph, {t_l[1]:.4f} alone on {card}")
        print(f"{tag}: Abwd, Bfwd bit for bit the package's: {same}")
    print(f"chain_cr_precompute: package bit for bit equal to every other library at every "
          f"shape: {pre_equal}")

    # the CR sweeps at the five shapes and CR_EDGES
    all_equal = True
    for tag, (Ls, CUs, res, droot) in cr_ops.items():
        S, L, n, _ = Ls.shape
        Ab, Bf = ccr.chain_cr_precompute(Ls, CUs)
        ys_r, radd_r = ccr.chain_solve_bwd_cr_ref(Ls, CUs, Ab, res)
        dls_r = ccr.chain_forward_cr_ref(Ls, CUs, Bf, ys_r, droot)
        outs = {}
        for name, lib in libs.items():
            ys = torch.empty((S, L, n), **f32)
            radd = torch.empty((S, n), **f32)
            dls = torch.empty((S, L, n), **f32)
            floats = cr_scratch(lib, L, n)
            scratch = torch.empty((S, floats), **f32) if floats else None
            sp = None if scratch is None else scratch.data_ptr()

            def bwd():
                _build.check(lib.tq_chain_solve_bwd_cr(
                    Ls.data_ptr(), CUs.data_ptr(), Ab.data_ptr(), res.data_ptr(), ys.data_ptr(),
                    radd.data_ptr(), sp, S, L, n, st()), f"{name} bwd_cr")

            def fwd():
                _build.check(lib.tq_chain_forward_cr(
                    Ls.data_ptr(), Bf.data_ptr(), ys_r.data_ptr(), droot.data_ptr(),
                    dls.data_ptr(), sp, S, L, n, st()), f"{name} fwd_cr")
            bwd()
            fwd()
            torch.cuda.synchronize()
            e_s = check(name, f"{tag} CR sweeps", (ys, radd, dls), (ys_r, radd_r, dls_r),
                        SOLVE_RTOL)
            outs[name] = [t.clone() for t in (ys, radd, dls)]
            t_b, t_f = timed(bwd), timed(fwd)
            print(f"{tag} (S={S}, L={L}, n={n}) {name}: chain_solve_bwd_cr {t_b[0]:.4f} ms, "
                  f"chain_forward_cr {t_f[0]:.4f} ms in a CUDA graph (one launch timed alone: "
                  f"{t_b[1]:.4f} / {t_f[1]:.4f} ms; scratch {'yes' if floats else 'no'}), max "
                  f"|diff| to the twins {e_s:.3e} on {card}")
        T = chain_factor_matrix(torch, Ls, CUs)
        Tt = T.mT.contiguous()
        rhs = res.flip(1).reshape(S, -1, 1).contiguous()
        t_l = timed(lambda: torch.linalg.solve_triangular(T, rhs, upper=False))
        t_u = timed(lambda: torch.linalg.solve_triangular(Tt, rhs, upper=True))
        print(f"{tag} (S={S}, L={L}, n={n}) solve_triangular on each chain's [L n, L n] "
              f"factor / its transpose: {t_l[0]:.4f} / {t_u[0]:.4f} ms in a CUDA graph, "
              f"{t_l[1]:.4f} / {t_u[1]:.4f} ms alone on {card}")
        for name in libs:
            if name != "package":
                same = [torch.equal(a, b) for a, b in zip(outs["package"], outs[name])]
                all_equal = all_equal and all(same)
                print(f"{tag}: package CR sweeps bit for bit equal to {name}: {all(same)} "
                      f"(ys, radd0, dls {same})")
    print(f"CR sweeps: package bit for bit equal to every other library at every shape: "
          f"{all_equal}")
    for name, (_, path) in built.items():
        for kernel, (counts, _) in opcode_counts(path, ("chain_cr_precompute",
                                                        "chain_solve_bwd_cr",
                                                        "chain_forward_cr")).items():
            print(f"SASS {name} {kernel}: {counts}")
        report = Path(str(path) + ".ptxas.txt")
        if report.exists():
            lines = report.read_text().splitlines()
            for i, text in enumerate(lines):
                if "chain_cr_precompute" in text and "Compiling entry" in text:
                    notes = [u.split(":", 1)[-1].strip() for u in lines[i + 1:i + 6]
                             if "spill" in u or "Used" in u][:2]
                    print(f"ptxas {name} {text.split(chr(39))[1]}: {'; '.join(notes)}")

    rng = np.random.default_rng(18)
    for n in REDUCE_SIZES:
        x = torch.tensor(rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n),
                         dtype=torch.float64, device=dev)
        m = dr._padded_size(n)
        ref = dr.df_reduce_flat_ref(x)
        for name, lib in libs.items():
            # an older library takes a zero scratch of m / 2 values before out
            out = torch.empty((), dtype=torch.float64, device=dev)
            c_args = [x.data_ptr(), n, m, out.data_ptr()]
            if len(lib.tq_df_reduce.argtypes) == 6:
                buf = torch.zeros((m // 2,), dtype=torch.float64, device=dev)
                c_args.insert(3, buf.data_ptr())

            def red():
                _build.check(lib.tq_df_reduce(*c_args, st()), f"{name} df_reduce")
            red()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int64), ref.view(torch.int64)):
                sys.exit(f"{name} df_reduce (n={n}): {float(out)!r} is not the twin's "
                         f"{float(ref)!r} bit for bit")
            t_r = timed(red)
            print(f"df_reduce_flat (n={n}) {name}: {t_r[0]:.4f} ms in a CUDA graph, "
                  f"{t_r[1]:.4f} ms alone; bit for bit the twin on {card}")
        t_s = timed(lambda: torch.sum(x))
        print(f"df_reduce_flat (n={n}) torch.sum: {t_s[0]:.4f} ms in a CUDA graph, "
              f"{t_s[1]:.4f} ms alone on {card}")


if __name__ == "__main__":
    main()

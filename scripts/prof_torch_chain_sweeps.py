#!/usr/bin/env python3
"""The serial chain sweep kernels (``csrc/chain_sweeps.cu``) against
another checkout's, on one card.

    python3 scripts/prof_torch_chain_sweeps.py --parent DIR [--reps 50]

DIR is another checkout of the repository (for example a ``git archive``
of the parent commit). Its own ``treeqp_tpu_torch/ops/_build.py`` builds
its kernel library into DIR/build; this checkout's ``_build`` builds this
one's. Shapes: ``scripts/prof_torch_chain_cr.py``'s three (random S=256,
L=16, n=8; the pruned quadcopter's first chain factors, S=128, L=16, n=6;
sdunes' S=256, L=20, n=8), a long chain of the widest blocks (S=4, L=130,
n=16) and an odd one (S=5, L=17, n=5: the 4-byte copies).

For both libraries and every shape: the backward and forward sweeps' ms a
launch on the card alone (20 launches captured in a CUDA graph, by
``chip_smoke.graph_ms``) and of one launch timed alone (the median of
REPS, host launch included, by ``chip_smoke.cuda_ms``), their largest
difference from the plain twins (held to ``chip_smoke.SOLVE_RTOL``), and
whether the two libraries' outputs are equal bit for bit. Exits non-zero
if a launch fails or a result leaves the twins' tolerance. Needs CUDA and
nvcc; imports nothing of JAX.
"""

import argparse
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import SOLVE_RTOL, cuda_ms, graph_ms  # noqa: E402
from prof_common import card as card_name  # noqa: E402


def parent_lib(parent):
    """The kernel library of the checkout at ``parent``, built and bound
    by that checkout's own ``_build``."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(parent) / "treeqp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="another checkout of the repository to compare with")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_chain_sweeps: needs a CUDA device")
    from prof_torch_chain_cr import shapes as cr_shapes
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import chain_kernels as ck
    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    libs = {"package": _build.lib(), "parent": parent_lib(args.parent)}

    ops = cr_shapes(torch, dev)
    rng = np.random.default_rng(2)
    for tag, (S, L, n) in (("long", (4, 130, 16)), ("odd", (5, 17, 5))):
        A = rng.standard_normal((S, L, n, n))
        Wc = torch.tensor(A @ A.transpose(0, 1, 3, 2) + 3.0 * np.eye(n), **f32)
        Utc = torch.tensor(0.3 * rng.standard_normal((S, L, n, n)), **f32)
        Ls, CUs, _ = ck.chain_factor_ref(Wc, Utc)
        ops[tag] = (Ls, CUs, torch.tensor(rng.standard_normal((S, L, n)), **f32),
                    torch.tensor(rng.standard_normal((S, n)), **f32))

    for tag, (Ls, CUs, res, droot) in ops.items():
        S, L, n, _ = Ls.shape
        ys_r, radd_r = ck.chain_solve_bwd_ref(Ls, CUs, res)
        dls_r = ck.chain_forward_ref(Ls, CUs, ys_r, droot)
        outs = {}
        for name, lib in libs.items():
            ys = torch.empty((S, L, n), **f32)
            radd = torch.empty((S, n), **f32)
            dls = torch.empty((S, L, n), **f32)

            def bwd():
                _build.check(lib.tq_chain_solve_bwd(
                    Ls.data_ptr(), CUs.data_ptr(), res.data_ptr(), ys.data_ptr(),
                    radd.data_ptr(), S, L, n, _build.stream(dev)), f"{name} bwd")

            def fwd():
                _build.check(lib.tq_chain_forward(
                    Ls.data_ptr(), CUs.data_ptr(), ys_r.data_ptr(), droot.data_ptr(),
                    dls.data_ptr(), S, L, n, _build.stream(dev)), f"{name} fwd")
            bwd()
            fwd()
            torch.cuda.synchronize()
            err = 0.0
            for g, r in ((ys, ys_r), (radd, radd_r), (dls, dls_r)):
                e = float((g - r).abs().max())
                if not e <= SOLVE_RTOL * max(1.0, float(r.abs().max())):
                    sys.exit(f"{name} ({tag}): differs from the twin by {e:.3e}")
                err = max(err, e)
            outs[name] = (ys.clone(), radd.clone(), dls.clone())
            t_b, t_f = cuda_ms(torch, bwd, args.reps), cuda_ms(torch, fwd, args.reps)
            g_b, g_f = graph_ms(torch, bwd), graph_ms(torch, fwd)
            print(f"{tag} (S={S}, L={L}, n={n}) {name}: bwd {g_b:.4f} ms, fwd {g_f:.4f} ms in "
                  f"a CUDA graph (one launch timed alone: {t_b:.4f} / {t_f:.4f} ms), max |diff| "
                  f"to the twins {err:.3e} on {card}")
        same = all(torch.equal(a, b) for a, b in zip(outs["package"], outs["parent"]))
        print(f"{tag}: package bit for bit equal to parent: {same}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The serial chain sweeps against their cyclic-reduction variants on one
card: the accept/reject measurement of the CR lever, counterpart of
``scripts/prof_chain_cr.py``.

    python3 scripts/prof_torch_chain_cr.py [--loop 256] [--nrep 4]

For each shape, times LOOP_N backward + forward solve pairs with the
right-hand side varied each step (r_k = res0 (1 + 2e-4 k), the
forward sweep from droot + radd0, the directions summed), once through
the serial kernels (``chain_solve_bwd`` + ``chain_forward``) and once
through the CR kernels (``chain_solve_bwd_cr`` + ``chain_forward_cr``,
with ``chain_cr_precompute``'s operands built once beforehand). The loop
is captured in a CUDA graph, so its time is the card's, not the host's
launches; CUDA events, the minimum over NREP replays. The same loop run
eagerly (a Python loop of launches) is timed too. Shapes:

* ``random``: the JAX script's default S=256, L=16, n=8, its factors built
  as it builds them (seed 0: W = A A' + 3 I, Ut = 0.3 N, through
  ``chain_factor``);
* ``pruned``: the chain factors of ``tdunes_solve`` on quadcopter(4,4,20)
  pruned to 128 scenarios at ``models.GENERIC_SPEED_OPTS`` (n=6), its
  first factorization and right-hand side;
* ``sdunes``: the chain factors of ``sdunes_solve`` on
  spring_mass_chain(4,4,4,20) at ``models.SDUNES_OPTS`` (S=256, L=20,
  n=8), its first factorization, the first column of its first solve.

Prints us per pair, the speedup of serial over CR, the precompute's time
and the CR pair's largest difference from the serial pair. Needs CUDA;
imports nothing of JAX.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from prof_common import card as card_name  # noqa: E402


def capture_calls(mod, names, fn):
    """Run fn() with the wrappers ``names`` of module ``mod`` recording
    (args, result) of every call; returns {name: [(args, result), ...]}.
    A wrapper counts its launches through the name its module binds, so
    each stand-in carries a count."""
    got, orig = {}, {n: getattr(mod, n) for n in names}

    def stand_in(n):
        def w(*a, **k):
            out = orig[n](*a, **k)
            got.setdefault(n, []).append((a, out))
            return out
        w.launches = 0
        return w
    for n in names:
        setattr(mod, n, stand_in(n))
    try:
        fn()
    finally:
        for n, f in orig.items():
            setattr(mod, n, f)
    return got


def shapes(torch, dev):
    """{name: (Ls, CUs, res0, droot)} on the card."""
    import numpy as np
    import treeqp_tpu_torch  # noqa: F401
    from treeqp_tpu_torch import models
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.solvers import sdunes as sd
    from treeqp_tpu_torch.solvers import tdunes as td
    f32 = dict(dtype=torch.float32, device=dev)
    out = {}
    # the JAX script's factors (scripts/prof_chain_cr.py, seed 0)
    S, L, N = 256, 16, 8
    rng = np.random.default_rng(0)
    A = rng.standard_normal((S, L, N, N))
    Wc = torch.tensor(A @ A.transpose(0, 1, 3, 2) + 3.0 * np.eye(N), **f32)
    Utc = torch.tensor(0.3 * rng.standard_normal((S, L, N, N)), **f32)
    Ls, CUs, _ = ck.chain_factor(Wc, Utc)
    out["random"] = (Ls, CUs, torch.tensor(rng.standard_normal((S, L, N)), **f32),
                     torch.tensor(rng.standard_normal((S, N)), **f32))
    # the pruned quadcopter's first factorization and solve
    qg = models.pruned(models.quadcopter(4, 4, 20, device=dev).qp, 128)
    o = td.TdunesOpts(**{**models.GENERIC_SPEED_OPTS, "max_iter": 1})
    got = capture_calls(ck, ("chain_factor", "chain_solve_bwd", "chain_forward"),
                        lambda: td.tdunes_solve(qg, None, o))
    (_, _), (Ls, CUs, _) = got["chain_factor"][0]
    res = got["chain_solve_bwd"][0][0][2]
    droot = got["chain_forward"][0][0][3]
    out["pruned"] = (Ls, CUs, res, droot)
    # sdunes' banded factors and its first solve's first column
    sq = sd.scenario_data(models.spring_mass_chain(4, 4, 4, 20, device=dev)[0])
    o = dataclasses.replace(sd.SdunesOpts(**models.SDUNES_OPTS), max_iter=1)
    got = capture_calls(ck, ("chain_factor", "chain_full_solve_mat"),
                        lambda: sd.sdunes_solve(sq, None, None, o))
    (_, _), (Ls, CUs, _) = got["chain_factor"][0]
    rhs = got["chain_full_solve_mat"][0][0][2]
    rng = np.random.default_rng(1)
    out["sdunes"] = (Ls, CUs, rhs[..., 0].contiguous(),
                     torch.tensor(rng.standard_normal((Ls.shape[0], Ls.shape[2])), **f32))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--loop", type=int, default=256, help="solve pairs a loop (LOOP_N)")
    ap.add_argument("--nrep", type=int, default=4, help="timed replays; the minimum counts")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("prof_torch_chain_cr: needs a CUDA device")
    from treeqp_tpu_torch.ops import chain_cr as cr
    from treeqp_tpu_torch.ops import chain_kernels as ck
    card = card_name()
    dev = torch.device("cuda", 0)
    print(card)

    def event_ms(fn, reps):
        """Minimum milliseconds of fn() over reps, from CUDA events."""
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        return best

    for name, (Ls, CUs, res0, dr0) in shapes(torch, dev).items():
        S, L, n, _ = Ls.shape
        Abwd, Bfwd = cr.chain_cr_precompute(Ls, CUs)

        def serial(r):
            ys, radd = ck.chain_solve_bwd(Ls, CUs, r)
            return ck.chain_forward(Ls, CUs, ys, dr0 + radd)

        def cr_pair(r):
            ys, radd = cr.chain_solve_bwd_cr(Ls, CUs, Abwd, r)
            return cr.chain_forward_cr(Ls, CUs, Bfwd, ys, dr0 + radd)

        diff = float((serial(res0) - cr_pair(res0)).abs().max())
        top = float(serial(res0).abs().max())
        # the right-hand side of step k: res0 (1 + 2e-4 k)
        fac = 1.0 + 2e-4 * torch.arange(args.loop, dtype=torch.float32, device=dev)
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        out = {}
        for kind, pair in (("serial", serial), ("cr", cr_pair)):
            def loop():
                acc.zero_()
                for k in range(args.loop):
                    acc.add_(pair(res0 * fac[k]).sum())
            loop()
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                loop()
            out[kind] = (event_ms(g.replay, args.nrep) / args.loop * 1e3,
                         event_ms(loop, args.nrep) / args.loop * 1e3)
            print(f"{name} (S={S}, L={L}, n={n}): {kind} {out[kind][0]:.2f} us per bwd+fwd "
                  f"pair in a CUDA graph, {out[kind][1]:.2f} us launched eagerly "
                  f"(loop {args.loop}, min of {args.nrep}) on {card}")
        pre = event_ms(lambda: cr.chain_cr_precompute(Ls, CUs), 20) * 1e3
        print(f"{name}: speedup serial/cr {out['serial'][0] / out['cr'][0]:.2f}x in a graph, "
              f"{out['serial'][1] / out['cr'][1]:.2f}x eager; chain_cr_precompute "
              f"{pre:.2f} us once per factorization; CR pair vs serial max |diff| {diff:.3e} "
              f"(max |dl| {top:.3e}) on {card}")


if __name__ == "__main__":
    main()

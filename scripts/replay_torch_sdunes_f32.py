#!/usr/bin/env python3
"""Which kernel moves sdunes' all-f32 mode: the sdunes_f32 requests of
``chip_smoke.py`` with each of the mode's three kernels swapped, in turn,
for its plain PyTorch twin.

    python3 scripts/replay_torch_sdunes_f32.py [--device cuda|cpu] [--nr 4]
        [--requests 2] [--json replay.json]

The requests are ``chip_smoke.py``'s: box-only spring_mass_chain(4, 4, Nr,
20), stage 0's state bounds scaled by 1 + 0.02 sin(1 + 1.7 (k + 1)), the
scenario data in f32, a cold ``sdunes_solve`` at ``models.SDUNES_OPTS``
with tol 1e-3, max_iter 80 and no coarse phase. Each request runs

* ``kernels``: as the package runs it on the card (chain_factor,
  chain_full_solve_mat and jay_cr_solve launch their CUDA kernels);
* ``plain <name>``: the same with that one wrapper replaced, in the
  solver's module namespace and for this run only, by its plain twin
  called on the CUDA tensors;
* ``plain all``: all three replaced.

For every run it prints the iterations, the status, the final error and
the first iteration whose iterate (the stage solution x the dual point
gives) differs from the ``kernels`` run's: at all, and by more than 1e-3
of its size. The ``kernels`` run also holds each kernel, at every call,
against its twin on the same inputs and prints the largest relative
difference per iteration (the twins' results are dropped: the run's
trajectory is the kernels'). ``--device cpu`` runs the plain path on the
CPU instead (the twins on CPU tensors; no swaps). ``--json`` writes the
per-iteration errors and differences. Imports nothing of JAX.
"""

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TOL = 1e-3
MAX_ITER = 80
PART = 1e-3  # an iterate "parts" once it differs by this much of its size


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--nr", type=int, default=4)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("replay_torch_sdunes_f32: needs a CUDA device (or --device cpu)")
    from treeqp_tpu_torch.models import SDUNES_OPTS, spring_mass_chain
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import jay_kernel as jk
    from treeqp_tpu_torch.solvers import sdunes as sd

    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        from prof_common import card
        print(f"card: {card()}")
    qp = spring_mass_chain(4, 4, args.nr, 20, device=dev)[0]
    sqp = sd.scenario_data(qp)
    paths = torch.as_tensor(sqp.meta.paths, device=dev)
    opts = dataclasses.replace(sd.SdunesOpts(**SDUNES_OPTS), tol=TOL, max_iter=MAX_ITER,
                               f32_phase_tol=0.0)
    print(f"spring_mass_chain(4,4,{args.nr},20): {sqp.meta.Ns} scenarios; sdunes_f32 "
          f"(tol {TOL}, max_iter {MAX_ITER}) on {dev}")

    def request(k):
        fac = 1.0 + 0.02 * math.sin(1.0 + 1.7 * (k + 1.0))
        xmin, xmax = qp.xmin.clone(), qp.xmax.clone()
        xmin[0] *= fac
        xmax[0] *= fac
        return sqp.replace(xmin=xmin[paths], xmax=xmax[paths]).to(dtype=torch.float32)

    # (module, wrapper name, twin) of the mode's three kernels
    kernels = ((ck, "chain_factor", ck.chain_factor_ref),
               (ck, "chain_full_solve_mat", ck.chain_full_solve_mat_ref),
               (jk, "jay_cr_solve", jk.jay_cr_solve_ref))
    originals = {name: getattr(mod, name) for mod, name, _ in kernels}

    def run(sq, swap=(), diff=False):
        """One cold solve; returns (info, per-iteration records). ``swap``
        names the wrappers replaced by their twins; ``diff`` holds each
        kernel against its twin at every call."""
        recs = []
        residuals = sd._residuals

        def rec_residuals(sqp_, sol, cmask):
            out = residuals(sqp_, sol, cmask)
            recs.append({"x": sol["x"].double().cpu(), "diff": {},
                         "err": float(sd._error_of(opts, *out))})
            return out

        def differ(name, kern, twin):
            def call(*a, **kw):
                got = kern(*a, **kw)
                if recs:
                    ref = twin(*a, **kw)
                    g = got if isinstance(got, tuple) else (got,)
                    r = ref if isinstance(ref, tuple) else (ref,)
                    d = max(float((x - y).abs().max() / max(1.0, float(y.abs().max())))
                            for x, y in zip(g, r))
                    dd = recs[-1]["diff"]
                    dd[name] = max(dd.get(name, 0.0), d)
                return got
            call.launches = 0  # the wrappers count through their module's name
            return call

        sd._residuals = rec_residuals
        try:
            for mod, name, twin in kernels:
                if name in swap:
                    setattr(mod, name, twin)
                elif diff:
                    setattr(mod, name, differ(name, originals[name], twin))
            info = sd.sdunes_solve(sq, None, None, opts)[3]
        finally:
            sd._residuals = residuals
            for mod, name, _ in kernels:
                setattr(mod, name, originals[name])
        return info, recs

    def parts(recs, base):
        """First iteration whose iterate differs from base's at all, and by
        more than PART of its size."""
        first = big = None
        for i, (a, b) in enumerate(zip(recs, base)):
            d = float((a["x"] - b["x"]).abs().max())
            if first is None and d > 0:
                first = i
            if big is None and d > PART * max(1.0, float(b["x"].abs().max())):
                big = i
        return first, big

    out = {"device": str(dev), "nr": args.nr, "requests": []}
    for k in range(args.requests):
        sq = request(k)
        runs = {}
        if dev.type == "cpu":
            runs["plain (cpu)"] = run(sq)
        else:
            runs["kernels"] = run(sq, diff=True)
            for _, name, _ in kernels:
                runs[f"plain {name}"] = run(sq, swap=(name,))
            runs["plain all"] = run(sq, swap=tuple(n for _, n, _ in kernels))
        base = next(iter(runs.values()))[1]
        req = {"k": k, "runs": {}}
        for what, (info, recs) in runs.items():
            first, big = parts(recs, base)
            print(f"request {k} {what}: {info['iter']} iterations, status {info['status']}, "
                  f"error {info['error']:.3e}; parts from the first run at iteration "
                  f"{first} (> {PART:g}: {big})")
            req["runs"][what] = dict(iter=info["iter"], status=info["status"],
                                     error=info["error"], first_differs=first,
                                     first_parts=big, errors=[r["err"] for r in recs])
        if dev.type == "cuda":
            recs = runs["kernels"][1]
            for i, r in enumerate(recs):
                if r["diff"]:
                    print(f"  request {k} iteration {i}: kernel vs twin, relative "
                          + ", ".join(f"{n} {v:.2e}" for n, v in r["diff"].items()))
            req["diff"] = [r["diff"] for r in recs]
        out["requests"].append(req)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

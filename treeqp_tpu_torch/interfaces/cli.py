"""JSON batch front-end — the ``solve_qp_json.out`` equivalent
(examples/solve_qp_json.cpp:206-615). Port of ``treeqp_tpu/interfaces/cli.py``.

Usage::

    python3 -m treeqp_tpu_torch.interfaces.cli qp_in.json [init.json] [-o qp_out.json]
                                               [--device cuda|cpu]
    python3 -m treeqp_tpu_torch.interfaces.cli --serve [--device cuda|cpu]

Reads a reference-format QP (nodes/edges/options), optionally overwrites x0
and the dual initialization from ``init.json`` (keys x0, lam0_tree,
lam0_scen, mu0_scen — solve_qp_json.cpp:210-213), dispatches on
``options.solver`` in {tdunes, sdunes, hpmpc, hpipm, ipm} (the last three
map to the built-in tree IPM), repeats the solve NREP times keeping the
minimum time and asserting identical iteration counts, and writes the
solution JSON with multipliers, KKT residual, timing and the updated warm
start.

Multistage dispatch (``options.multistage``, default "auto"): on a
multistage scenario tree with clipping-class data, tdunes routes to the
crown+chains solver (tdunes_ms) when clipping is asked for, and
hpmpc/hpipm/ipm to the multistage IPM (ipm_ms), returning the merged
full-tree output in the identical JSON schema. Set ``multistage: false``
to force the generic solvers.

The solves run on the card (``--device cuda``, the default) unless the
caller asks for the CPU; without a CUDA device the default refuses to run
(no fallback). The output ``info`` carries the solver-vs-interface time
split (treeqp_info_t, tree_qp_common.h:43-51): ``solver_time`` =
min-over-NREP solve wall time (each solve synchronized),
``interface_time`` = data marshalling (JSON parse, layout conversion and
the copy to the device, solution serialization), ``cpu_time`` = their sum.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback

import numpy as np
import torch

from treeqp_tpu_torch.core.json_io import load_tree_qp_json, solution_to_json
from treeqp_tpu_torch.core.kkt import max_kkt_residual
from treeqp_tpu_torch.solvers import ipm as ipm_mod
from treeqp_tpu_torch.solvers import ipm_multistage as ipm_ms_mod
from treeqp_tpu_torch.solvers import sdunes as sd
from treeqp_tpu_torch.solvers import tdunes as td
from treeqp_tpu_torch.solvers import tdunes_multistage as tm
from treeqp_tpu_torch.utils.timing import Timer, min_time_over

__all__ = ["solve_request", "run", "serve", "main", "resolve_device"]

_REG_MAP = {
    "TREEQP_NO_REGULARIZATION": "none",
    "TREEQP_ALWAYS_LEVENBERG_MARQUARDT": "always",
    "TREEQP_ON_THE_FLY_LEVENBERG_MARQUARDT": "on_the_fly",
}


def resolve_device(name, prog="treeqp-solve-torch") -> torch.device:
    """The torch device of ``--device``; a CUDA device that is not there is
    an error (``SystemExit`` with a message naming ``prog``), never a
    fallback to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: --device {name} but no CUDA device is "
                         "available (pass --device cpu to solve on the CPU)")
    return dev


def _pick_stage_solver(qp, options) -> str:
    """Stage-QP solver selection for the tdunes dispatch.

    Explicit ``options["stageQp"]`` wins (clipping | qpoases->qpgen |
    dense | boxqp | qpgen | mixed). Otherwise: the reference's
    ``clipping`` flag selects clipping (solve_qp_json.cpp option
    pass-through); with no flag, pick by the DATA — general C/D rows
    need the qpOASES-class solver (qpgen), finite bounds need boxqp,
    and only the truly unconstrained case gets the dense closed form
    (the reference links qpOASES for everything non-clipping;
    dual_Newton_tree_qpoases.c).
    """
    req = str(options.get("stageQp", "auto"))
    table = dict(clipping="clipping", qpoases="qpgen", qpgen="qpgen",
                 dense="dense", boxqp="boxqp", mixed="mixed")
    if req != "auto":
        return table[req]
    if options.get("clipping", False):
        return "clipping"
    if max(qp.topo.nc) > 0:
        return "qpgen"
    inf = 1e11
    finite = any(bool((getattr(qp, f).abs() < inf).any())
                 for f in ("xmin", "xmax", "umin", "umax"))
    return "boxqp" if finite else "dense"


def _lam_tree_to_nodes(vec, topo):
    """Flat reference lambda layout (stacked per non-root node, node order)
    -> [Nn, nxm] padded rows."""
    lam = np.zeros((topo.Nn, topo.nxm))
    i = 0
    for c in range(1, topo.Nn):
        lam[c, : topo.nx[c]] = vec[i: i + topo.nx[c]]
        i += topo.nx[c]
    return lam


def _lam_nodes_to_tree(lam, topo):
    lam = lam.detach().cpu().numpy() if isinstance(lam, torch.Tensor) else np.asarray(lam)
    out = []
    for c in range(1, topo.Nn):
        out.extend(lam[c, : topo.nx[c]].tolist())
    return out


def solve_request(j_in: dict, init: dict | None = None, nrep_arg=None,
                  eliminate_x0: bool = False, device="cuda") -> dict:
    """Solve one reference-schema QP dict on ``device``; returns the output
    JSON dict.

    The core of the batch front-end, shared by the one-shot file mode
    (``run``) and the persistent JSON-lines server (``serve``) that backs
    the C++ embedding. Repeated requests in one process reuse the solvers'
    per-topology caches and the built kernel library — the
    persistent-workspace pattern of the reference C++ API
    (treeqp_cpp_interface.cpp:130-430 keeps the solver workspace alive
    across Solve() calls)."""
    dev = resolve_device(device)
    t_iface = Timer().tic()  # interface time: parse + layout + serialize
    iface_box = {"prep": 0.0}

    def run_solve(fn, check):
        # close the interface-prep window right before the timed solves
        iface_box["prep"] = t_iface.toc()
        return min_time_over(fn, nrep, check_deterministic=check)

    qp, extras = load_tree_qp_json(j_in, device=dev)
    topo = qp.topo
    options = extras.get("options", {})
    solver = options.get("solver", "tdunes")
    nrep = int(nrep_arg) if nrep_arg is not None else int(options.get("NREP", 1))

    init = init or {}
    if "x0" in init and topo.nx[0] > 0:
        qp = qp.set_x0(np.asarray(init["x0"], dtype=np.float64).reshape(-1))

    if eliminate_x0:
        xmin0 = qp.xmin[0, : topo.nx[0]].cpu().numpy()
        xmax0 = qp.xmax[0, : topo.nx[0]].cpu().numpy()
        if not np.allclose(xmin0, xmax0):
            raise SystemExit("--eliminate-x0 needs a pinned root state")
        qp = qp.eliminate_x0()
        topo = qp.topo

    j_out = {"init": {}}

    # --- multistage dispatch (options.multistage: auto | true | false).
    # "auto" routes to the crown+chains engines when the instance is a
    # multistage clipping-class tree AND (for tdunes) clipping was asked
    # for; "true" forces it (erroring when inapplicable); "false" keeps
    # the generic solvers.
    ms_mode = str(options.get("multistage", "auto")).lower()

    def ms_dispatch(auto_ok: bool) -> bool:
        if ms_mode in ("false", "0", "no"):
            return False
        applicable = tm.multistage_applicable(qp)
        if ms_mode in ("true", "1", "yes"):
            if not applicable:
                raise SystemExit(
                    "options.multistage=true but the instance is not a "
                    "multistage clipping-class tree (diag Q/R, S=0, nc=0, "
                    "setup_multistage_tree shape)")
            return True
        return auto_ok and applicable

    iters = lambda o: int(o.info["iter"])
    dispatched = solver
    if solver == "tdunes":
        opts = td.TdunesOpts(
            max_iter=int(options.get("maxit", 100)),
            tol=float(options.get("stationarityTolerance", 1e-8)),
            ls_max_iter=int(options.get("lineSearchMaxIter", 50)),
            ls_beta=float(options.get("lineSearchBeta", 0.6)),
            ls_gamma=float(options.get("lineSearchGamma", 0.1)),
            reg_type=_REG_MAP.get(options.get("regType", ""), "on_the_fly"),
            reg_tol=float(options.get("regTol", 1e-6)),
            reg_value=float(options.get("regValue", 1e-6)),
            stage_solver=_pick_stage_solver(qp, options),
        )
        lam0 = None
        if "lam0_tree" in init:
            lam0 = torch.as_tensor(_lam_tree_to_nodes(
                np.asarray(init["lam0_tree"], dtype=np.float64), topo), device=dev)
        if ms_dispatch(auto_ok=opts.stage_solver == "clipping"):
            dispatched = "tdunes_ms"
            ms = tm.split_multistage(qp)
            opts = dataclasses.replace(opts, stage_solver="clipping")
            lam0_cr = lam0_ch = None
            if lam0 is not None:
                lam0_cr, lam0_ch = tm.split_duals(ms, lam0)

            def do():
                cro, cho, info = tm.tdunes_ms_solve(ms, lam0_cr, lam0_ch, opts)
                return tm.merge_output(ms, cro, cho, info)

            t, out = run_solve(do, iters)
        else:
            t, out = run_solve(lambda: td.tdunes_solve(qp, lam0, opts), iters)
        j_out["init"]["lam0_tree"] = _lam_nodes_to_tree(out.lam, topo)

    elif solver == "sdunes":
        sqp = sd.scenario_data(qp)
        meta = sqp.meta
        opts = sd.SdunesOpts(
            max_iter=int(options.get("maxit", 100)),
            tol=float(options.get("stationarityTolerance", 1e-8)),
            ls_max_iter=int(options.get("lineSearchMaxIter", 50)),
            ls_beta=float(options.get("lineSearchBeta", 0.6)),
            ls_gamma=float(options.get("lineSearchGamma", 0.1)),
            reg_type=_REG_MAP.get(options.get("regType", ""), "on_the_fly"),
        )
        lam0 = mu0 = None
        if "mu0_scen" in init:
            mu0 = torch.as_tensor(np.asarray(init["mu0_scen"], np.float64)
                                  .reshape(meta.Ns, meta.Nh, -1), device=dev)
        if "lam0_scen" in init:
            flat = np.asarray(init["lam0_scen"], np.float64)
            nu = sqp.r.shape[-1]
            lam = np.zeros((meta.Ns - 1, meta.Nr, nu))
            i = 0
            for s in range(meta.Ns - 1):
                c = meta.common[s]
                lam[s, :c] = flat[i: i + c * nu].reshape(c, nu)
                i += c * nu
            lam0 = torch.as_tensor(lam, device=dev)

        def do():
            sol, lam, mu, info = sd.sdunes_solve(sqp, lam0, mu0, opts)
            return sd.scenario_output(sqp, sol, lam, mu, info)

        t, out = run_solve(do, iters)

    elif solver in ("hpmpc", "hpipm", "ipm"):
        opts = ipm_mod.IpmOpts(
            max_iter=int(options.get("maxit", options.get("maxIter", 30))),
            tol=float(options.get("tol", options.get("mu_tol", 1e-10))),
        )
        if ms_dispatch(auto_ok=True):
            dispatched = solver + "_ms"
            ms = tm.split_multistage(qp)

            def do():
                cro, cho, info = ipm_ms_mod.ipm_ms_solve(ms, opts)
                return tm.merge_output(ms, cro, cho, info)

            t, out = run_solve(do, iters)
        else:
            t, out = run_solve(lambda: ipm_mod.ipm_solve(qp, opts), iters)
    else:
        raise SystemExit(f"unknown solver '{solver}'")

    kkt = float(max_kkt_residual(qp, out))
    tser = Timer().tic()
    j = solution_to_json(qp, out, kkt=kkt, num_iter=int(out.info["iter"]),
                         status=int(out.info["status"]))
    j["init"] = j_out["init"]
    iface = iface_box["prep"] + tser.toc()
    # solver-vs-interface split (treeqp_info_t, tree_qp_common.h:43-51),
    # in the info dict AND the output JSON
    out.info["solver_time"] = t
    out.info["interface_time"] = iface
    j["info"]["cpu_time"] = t + iface
    j["info"]["solver_time"] = t
    j["info"]["interface_time"] = iface
    j["info"]["solver"] = dispatched
    return j


def run(argv=None):
    ap = argparse.ArgumentParser(prog="treeqp-solve-torch")
    ap.add_argument("qp_in")
    ap.add_argument("init", nargs="?", default=None)
    ap.add_argument("-o", "--output", default="qp_out.json")
    ap.add_argument("--nrep", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card; an error without one) or cpu")
    ap.add_argument("--eliminate-x0", action="store_true",
                    help="fold a pinned root state into the data before "
                         "solving (the reference front-end always does this, "
                         "solve_qp_json.cpp:350-353)")
    args = ap.parse_args(argv)

    with open(args.qp_in) as f:
        j_in = json.load(f)
    init = None
    if args.init:
        with open(args.init) as f:
            init = json.load(f)

    j = solve_request(j_in, init, args.nrep, args.eliminate_x0, device=args.device)
    info = j["info"]
    with open(args.output, "w") as f:
        json.dump(j, f, indent=1)
    print(f"solver={info['solver']} iter={info['num_iter']} "
          f"status={info['status']} kkt={info['kkt_tol']:.2e} "
          f"time={info['solver_time']*1e3:.2f}ms "
          f"(+{info['interface_time']*1e3:.1f}ms interface) device={args.device}")
    return 0


def serve(argv=None):
    """Persistent JSON-lines solve server (the embedding bridge).

    Reads one request per line on stdin, writes one response per line on
    stdout. Requests: {"qp": <reference QP schema>, "init": {...}?,
    "nrep": N?, "eliminate_x0": bool?} or {"cmd": "quit"}. The process —
    and with it the CUDA context, the built kernels and the solvers'
    per-topology caches — lives across requests, so a C++ host
    (treeqp_cpp.hpp SolverSession) pays process start and device set-up
    once (treeqp_cpp_interface.cpp:130-430 workspace persistence analog).
    Without the requested device the server exits non-zero before its
    handshake."""
    ap = argparse.ArgumentParser(prog="treeqp-solve-torch --serve")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    out_stream = sys.stdout
    # handshake line: the host blocks on this before sending requests
    out_stream.write(json.dumps({"ready": True}) + "\n")
    out_stream.flush()
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if req.get("cmd") == "quit":
                break
            resp = solve_request(req["qp"], req.get("init"),
                                 req.get("nrep"),
                                 bool(req.get("eliminate_x0", False)),
                                 device=args.device)
        except SystemExit as e:  # solver-dispatch errors use SystemExit
            resp = {"error": str(e)}
        except Exception as e:  # noqa: BLE001 — the server must not die
            traceback.print_exc(file=sys.stderr)
            resp = {"error": f"{type(e).__name__}: {e}"}
        out_stream.write(json.dumps(resp) + "\n")
        out_stream.flush()
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--serve" in argv:
        argv = [a for a in argv if a != "--serve"]
        return serve(argv)
    return run(argv)


if __name__ == "__main__":
    sys.exit(main())

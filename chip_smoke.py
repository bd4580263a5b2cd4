#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``treeqp_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device and build: requires CUDA, prints the card's name and power limit
   (nvidia-smi), builds the kernels of ``treeqp_tpu_torch/csrc/`` into
   ``build/`` and prints the build time;
2. kernels against their plain PyTorch twins on the card, on the operands
   of the first factorization and Newton solve of the headline instance
   (quadcopter, md=4, Nr=4, Nh=20: 256 scenarios, 4437 nodes), with each
   one's median time from CUDA events;
3. main path: ``tdunes_ms_solve`` on that instance on the card, certified by
   the KKT oracle (< 1e-8) and compared with the same solve on the CPU;
4. a few requests: 8 instances with perturbed initial state, solved cold and
   then warm-started, each certified by the KKT oracle.

Prints the kernels' JSON summary, then the device JSON as the last line.
Imports nothing of JAX.
"""

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-8
MD, NR, NH = 4, 4, 20
N_REQUESTS = 8
PERT = 0.02
SLICE_OPTS = dict(stage_solver="clipping", tol=TOL, max_iter=120,
                  factor_dtype="float32", refine_steps=2,
                  refine_safeguard=False, chain_backend="pallas",
                  reg_type="always", reg_value=1e-6, f32_phase_tol=0.0,
                  df64_phase=False)
# f32 kernels against f32 plain twins that sum in another order: factors
# to 1e-5 and solves to 1e-4 relative (tests/test_fused_eval.py,
# tests/test_crown_kernels.py use the same bounds)
FACTOR_RTOL = 1e-5
SOLVE_RTOL = 1e-4


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(torch, name, got, ref, rtol):
    """Max abs difference over paired outputs; fails above
    rtol * max(1, max|ref|) for any output."""
    worst = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"{name}: output shape {tuple(g.shape)} vs {tuple(r.shape)} "
                 f"or not finite")
        err = float((g - r).abs().max())
        bound = rtol * max(1.0, float(r.abs().max()))
        if not err <= bound:
            fail(f"{name}: kernel differs from its plain twin by {err:.3e} "
                 f"> {bound:.3e}")
        worst = max(worst, err)
    return worst


def perturbed(qp, ms, fac):
    """Scale the pinned initial state (the root's bound rows) by ``fac``:
    the closed-loop MPC variation of bench.py."""
    def scale(q):
        xmin, xmax = q.xmin.clone(), q.xmax.clone()
        xmin[0] *= fac
        xmax[0] *= fac
        return q.replace(xmin=xmin, xmax=xmax)
    return scale(qp), dataclasses.replace(ms, crown=scale(ms.crown))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "treeqp_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: treeqp_tpu_torch/ not found next to this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    import treeqp_tpu_torch  # noqa: F401  (pins full-precision f32)
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.models import quadcopter
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import system_kernels as sk
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    assert "jax" not in sys.modules

    # ---- 1. device and build
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libpath = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {libpath.relative_to(ROOT)}")
    for line in Path(str(libpath) + ".ptxas.txt").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 2. kernels against their plain twins, main-path shapes
    opts = td.TdunesOpts(**SLICE_OPTS)
    qp_cpu = quadcopter(MD, NR, NH).qp
    ms_cpu = tm.split_multistage(qp_cpu)
    ms = ms_cpu.to(dev)
    meta = ms.meta
    print(f"instance: quadcopter({MD},{NR},{NH}): {meta.full_topo.Nn} nodes, "
          f"S={meta.S} L={meta.L} nx={meta.nx} nu={meta.nu}, crown "
          f"{meta.crown_topo.Nn} nodes")
    prep = td._get_prep(meta.crown_topo)
    ctx = tm._solve_ctx(ms, prep)
    crown_data = td._stage_data(ms.crown, opts, prep)
    lam_cr = torch.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm),
                         dtype=torch.float64, device=dev)
    lam_ch = torch.zeros_like(ms.q)
    cr, ch = tm._ms_stage_solve(ms, crown_data, lam_cr, lam_ch, opts, prep,
                                ctx["rid"])
    inp = tm._factor_inputs(cr["qtilde"], cr["rtilde"], ch["qt"], ch["rt"],
                            prep, ctx)
    reg = opts.reg_value
    results = []

    c_ref = ck.chain_blocks_factor_ref(*inp["chain"])
    c_got = ck.chain_blocks_factor(*inp["chain"])
    torch.cuda.synchronize()
    err = compare(torch, "chain_blocks_factor", c_got, c_ref, FACTOR_RTOL)
    results.append(dict(
        name="chain_blocks_factor", route="cuda",
        source="treeqp_tpu_torch/csrc/chain_blocks_factor.cu",
        replaces="treeqp_tpu/ops/chain_kernels.py:311", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ck.chain_blocks_factor(*inp["chain"]), 50),
        plain_ms=cuda_ms(torch, lambda: ck.chain_blocks_factor_ref(*inp["chain"]), 5),
        shapes=f"ABt {tuple(inp['chain'][0].shape)}"))

    Ls, CUs, schur0, sc = c_ref
    Wadd = -tm._schur_scatter(schur0, ctx["g_of"], ctx["slot"], prep, prep.nxm)
    cargs = (*inp["crown"], Wadd, prep)
    w_ref = ckr.crown_blocks_factor_ref(*cargs, reg=reg)
    w_got = ckr.crown_blocks_factor(*cargs, reg=reg)
    torch.cuda.synchronize()
    err = compare(torch, "crown_blocks_factor", w_got, w_ref, FACTOR_RTOL)
    results.append(dict(
        name="crown_blocks_factor", route="cuda",
        source="treeqp_tpu_torch/csrc/crown_blocks_factor.cu",
        replaces="treeqp_tpu/ops/crown_kernels.py:332", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ckr.crown_blocks_factor(*cargs, reg=reg), 50),
        plain_ms=cuda_ms(torch, lambda: ckr.crown_blocks_factor_ref(*cargs, reg=reg), 5),
        shapes=f"CholW {tuple(w_ref[0].shape)}"))

    CholW, CholUt = w_ref
    res_cr = td._dual_residual(ms.crown, cr, prep)
    res_ch = tm._chain_residual(ms, ch, cr["x"], cr["u"], ctx["rid"])
    rg = td._nodes_to_group_mm(res_cr * inp["s_node"], prep)
    rch = res_ch * sc
    sargs = (Ls, CUs, CholW, CholUt, rg, rch, prep, meta.root_ids)
    s_ref = sk.system_solve_ref(*sargs)
    s_got = sk.system_solve(*sargs)
    torch.cuda.synchronize()
    err = compare(torch, "system_solve", s_got, s_ref, SOLVE_RTOL)
    results.append(dict(
        name="system_solve", route="cuda",
        source="treeqp_tpu_torch/csrc/system_solve.cu",
        replaces="treeqp_tpu/ops/system_kernels.py:74", max_abs_err=err,
        ms=cuda_ms(torch, lambda: sk.system_solve(*sargs), 50),
        plain_ms=cuda_ms(torch, lambda: sk.system_solve_ref(*sargs), 5),
        shapes=f"rch {tuple(rch.shape)}, rg {tuple(rg.shape)}"))
    for r in results:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms, max |diff| {r['max_abs_err']:.3e} "
              f"[{r['shapes']}] on {card}")

    # ---- 3. main path on the card, certified
    launched = (ck.chain_blocks_factor, ckr.crown_blocks_factor, sk.system_solve)
    for fn in launched:
        fn.launches = 0
    qp = qp_cpu.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cro, cho, info = tm.tdunes_ms_solve(ms, None, None, opts)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    out = tm.merge_output(ms, cro, cho, info)
    kkt = max_kkt_residual(qp, out)
    print(f"main path: iter {info['iter']} status {info['status']} error "
          f"{info['error']:.3e} kkt {kkt:.3e} in {t_solve * 1e3:.1f} ms "
          f"(first solve, includes warm-up) on {card}")
    if info["status"] != td.TDUNES_OPTIMAL or not info["error"] < TOL:
        fail(f"headline solve: status {info['status']} error {info['error']}")
    if not kkt < TOL:
        fail(f"headline solve: KKT residual {kkt}")
    if tuple(out.x.shape) != (meta.full_topo.Nn, meta.full_topo.nxm) \
            or not torch.isfinite(out.lam).all():
        fail("headline solve: output of the wrong shape or not finite")
    # the same solve through the plain twins on the CPU
    cro_c, cho_c, info_c = tm.tdunes_ms_solve(ms_cpu, None, None, opts)
    out_c = tm.merge_output(ms_cpu, cro_c, cho_c, info_c)
    gaps = {f: float((getattr(out, f).cpu() - getattr(out_c, f)).abs().max())
            for f in ("x", "u", "lam")}
    print(f"card vs CPU plain path: iter {info['iter']} vs {info_c['iter']}, "
          + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    if abs(info["iter"] - info_c["iter"]) > 1 or gaps["x"] > 1e-7 \
            or gaps["u"] > 1e-7 or gaps["lam"] > 1e-6:
        fail(f"card and CPU solves disagree: {gaps}")

    # ---- 4. a few requests: perturbed initial states, cold then warm
    # bench.py's rule, seed 1: fac_k = 1 + 0.02 sin(seed + 1.7 (k + 1))
    facs = [1.0 + PERT * math.sin(1.0 + 1.7 * (k + 1.0))
            for k in range(N_REQUESTS)]
    insts = [perturbed(qp, ms, f) for f in facs]
    rates = {}
    for mode in ("cold", "warm"):
        lam0 = (cro["lam"], cho["lam"])
        iters = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, (qp_k, ms_k) in enumerate(insts):
            start = lam0 if mode == "warm" else (None, None)
            cro_k, cho_k, info_k = tm.tdunes_ms_solve(ms_k, *start, opts)
            out_k = tm.merge_output(ms_k, cro_k, cho_k, info_k)
            kkt_k = max_kkt_residual(qp_k, out_k)
            if info_k["status"] != td.TDUNES_OPTIMAL or not kkt_k < TOL:
                fail(f"{mode} request {k}: status {info_k['status']} kkt {kkt_k}")
            iters.append(info_k["iter"])
            lam0 = (cro_k["lam"], cho_k["lam"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[mode] = N_REQUESTS / dt
        print(f"requests {mode}: iters {iters}, {rates[mode]:.2f} solves/s "
              f"({dt / N_REQUESTS * 1e3:.1f} ms/solve incl. KKT check) on {card}")

    counts = {fn.__name__: fn.launches for fn in launched}
    print(f"launches in the main path: {counts}")
    for r in results:
        r["launches"] = counts[r["name"]]
        del r["shapes"]
        if r["launches"] <= 0:
            fail(f"{r['name']} was not launched by the main path")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``treeqp_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device and build: requires CUDA, prints the card's name and power limit
   (nvidia-smi), builds the kernels of ``treeqp_tpu_torch/csrc/`` into
   ``build/`` (one nvcc per source, in parallel) and prints the build time
   and each kernel's registers and spills;
2. the first eighteen kernels against their plain PyTorch twins on the card,
   with each one's median time from CUDA events, its bound (the least
   time the card could take: the bytes it must move over the memory rate,
   or its operations over the FP32 / FP64 peak, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time:
   the factor and solve kernels of the f64 phase on the operands of its
   first factorization and solve, the coarse phase's kernels (chain_eval,
   crown_eval, chain_blocks_factor_lanes, newton_iter in both modes) on the
   operands of its first iteration, the high-precision phase's f64 kernels
   (chain_eval_df, crown_eval_df, chain_apply_df, crown_apply_df,
   df_reduce_flat) at its first point on the bench path (the coarse
   phase's last duals), all on the headline instance (quadcopter, md=4,
   Nr=4, Nh=20: 256 scenarios, 4437 nodes); and the generic-tree solver's
   tree-Cholesky kernels (chain_factor, chain_solve_bwd, chain_forward,
   crown_factor, crown_solve) on each of the three instances of section 5
   and on the general C/D tree of section 6 (the pruned tree's timed), at
   the cold start of the headline trees and two iterations into the
   asymmetric tree's solve; and the general stage QPs' ADMM identification
   (admm_identify) at the first cold stage solve of the general C/D
   headline (all 4437 nodes; timed) and of its mixed instance (its 1478
   general nodes), with the working sets it seeds held equal;
3. the main paths on that instance, each certified by the KKT oracle
   (< 1e-8) and compared with the same solve through the plain twins on
   the CPU: the one-phase solve (slice 1), the two-phase solve (coarse f32
   phase, then the f64 phase) and the bench path (bench.py's options: the
   coarse f32 phase, then the high-precision phase of ms_df64), with cold
   and warm requests of perturbed instances; and, on the bench path, the
   factorizations of one cold solve and the handover of the coarse phase's
   last factorization, counted;
4. more requests: two-phase requests with two-norm termination (the coarse
   phase's per-kernel loop), each certified; and the two-phase and bench
   solves of the 1024-scenario tree quadcopter(4,5,20), whose 1365-node
   crown the TPU kernels could not hold;
5. the generic-tree solver ``tdunes_solve`` at generic_bench's speed
   options (slice 4) on the headline tree pruned to 128 scenarios (the
   fault-tolerance example's pruned controller: 2257 nodes, 2129
   lambda-groups; the split path), cold and warm requests, each with
   stationarity < 1e-8 and KKT < 1e-6, the first held against the CPU
   plain path; the crown path on the asymmetric thesis-class tree of
   benchmarks/generic_bench.py, also held against the CPU plain path; and
   ``tdunes_solve`` on the unpruned headline tree (split path, 256 chains)
   against ``tdunes_ms_solve`` at bench options;
6. ``tdunes_solve`` on general C/D trees (slice 5) at general_cd_bench's
   tdunes options (``models.GENERAL_CD_OPTS``), on the bench's tree
   spring_mass_chain(4,4,4,20) (256 scenarios, 4437 nodes) with a row
   -0.6 <= sum x + 0.5 u <= 0.6 on every node (stage solver qpgen): a cold
   solve and a warm MPC chain of four requests (b + 1e-6 (k + 1), each from
   the previous solve's duals and working sets), and with the row on every
   third node (stage solver mixed) cold; each request with status 0 and
   KKT < 1e-8, its iterations, ADMM launches and time printed; the cold
   qpgen solve of the same plant at the depth Nr=2 (16 scenarios, 309
   nodes: the full tree takes ~6 minutes on the CPU) held against the same
   solve through the plain twins on the CPU (the same iterations, x and u
   within 1e-9);
7. the interior-point engine (slice 6) at ``models.IPM_OPTS``: its five
   Riccati kernels (ric_chain_factor, ric_chain_bwd, ric_chain_fwd,
   crown_ric_factor, crown_ric_solve) held against their twins on the
   operands of the first f32 iteration of each path (captured from a
   one-iteration solve), timed on path A (chain kernels) and B (crown
   kernels); then path A, ``ipm_ms_solve`` on general_cd_bench's ipm_ms
   tree (spring_mass_chain(4,4,4,20) with a row on every node: dense chain
   Riccati, the crown through the plain f32 recursion), and path B, the
   same tree box-only (ipm_bench's ms_f32_pallas mode: the crown through
   the crown kernels), each cold and through a warm chain of four requests
   b + 1e-6 (k + 1) from the previous solve; path C, ``ipm_solve`` on the
   box-only tree whole (4437 nodes, 21 stages) and on
   spring_mass_chain(4,4,3,7) (341 nodes), the f32 phase through the crown
   kernels; every request with status 0, max(res4) < tol and KKT < 1e-8,
   its iterations (f32 + f64), Riccati launches and time printed; path
   A's cold solve held against the same solve through the plain twins on
   the CPU at full depth (iterations within one, x and u within 1e-7);
8. sdunes (slice 7) at ``models.SDUNES_OPTS`` on sdunes_bench's tree (B's
   box-only spring_mass_chain(4,4,4,20): 256 scenarios, Jay P=255, b=4):
   chain_full_solve_mat (m=5 and m=1) held against its twin, with
   chain_factor, on the operands of the first final-phase iteration of
   the cold solve (captured from it); jay_cr_solve against its twin at the
   solve's first iteration, and at the first final-phase iteration (where
   the Jay system is near singular) both f32 solves held to a backward
   error below 1e-5, with their distances to the f64 solve printed; and
   jay_cr_solve once more on a seeded system at P=1023, b=16 with the
   on-the-fly shift and one exactly singular block; the cold
   ``sdunes_solve``; the bench's
   sdunes_boot requests (stage 0's state bounds scaled by 1 + 0.02
   sin(1 + 1.7(k+1)); a ``tdunes_ms_solve`` bootstrap at
   ``models.SDUNES_BOOT_OPTS``, ``merge_output``, ``scenario_duals_from_tree``
   with the tree solution, then ``sdunes_solve``) and sdunes_boot_df64's
   (the same with ``df64_phase=True``), each certified (status 0, error
   < 1e-8, port-oracle KKT < 1e-8 through ``scenario_output``) with its
   iterations, bootstrap iterations, launches and time printed; the
   sdunes_f32 mode (f32 data, cold, tol 1e-3: finite iterates, its ms an
   iteration beside ``tdunes_ms_solve``'s all-f32 loop's); and a cold solve
   at Nr=3 held against the CPU plain path (iterations within one; x and
   u within 1e-7, at the same iteration count when the counts differ);
9. the cyclic-reduction chain sweeps (slice 8; no solver calls them):
   chain_cr_precompute, chain_solve_bwd_cr and chain_forward_cr held
   against their twins (factors 1e-5, solves 1e-4 relative) and the CR pair
   against the serial kernels (2e-4 relative) at the three shapes of
   scripts/prof_torch_chain_cr.py (S=256, L=16, n=8 from that script's
   seed; the pruned tree's chain factors of section 5; sdunes' of section
   8, S=256, L=20, n=8) and at S=4, L=130, n=16 (buffers beyond shared
   memory), timed at the pruned tree's shape beside the
   library call (batched ``torch.linalg.solve_triangular`` on each chain's
   factor as one matrix, also timed beside chain_solve_bwd and
   chain_forward), then that script's loop of CR and serial pairs as their
   path;
10. the MPC re-embedding path (slice 8) on section 5's pruned tree at
   ``models.GENERIC_SPEED_OPTS``, along the closed loop of
   ``benchmarks/closed_loop.py`` (``closed_loop_mpc`` with tdunes, warm
   starts and no IPM bootstrap): ``set_x0`` then ``eliminate_x0`` keeping
   the originals, a cold solve, then four steps, each applying the
   solution's first control to the quadcopter's nonlinear plant
   (``BenchmarkModel.simulate``, RK4 at the true mass) and re-embedding the
   next state through ``EliminatedTreeQP.set_x0``, warm-started from the
   previous duals; each request's data equal to elimination from scratch
   (the root's state bounds aside), status 0 (the stalled steps counted),
   KKT < 1e-8 on the eliminated problem, x[1:] and u within 1e-6 of the
   solve without elimination, its iterations, launches and time printed;
   and the instance rebuilt through the three LTV setters from flat
   arrays, every field equal.

The kernel launch counts are set to 0 before each path (one-phase,
two-phase, bench, bench handover, two-norm, 1024 scenarios, generic split,
generic crown, generic cross-check, general C/D qpgen, general C/D mixed,
IPM paths A, B and C; the sdunes cold solve, each boot request's
bootstrap and its sdunes solve apart, sdunes_f32, tdunes_ms_f32; the CR
loop; the MPC re-embedding path)
and read after it; every kernel must launch on a path that runs it, the
multistage paths launch none of the generic solver's kernels, the generic
split path none of the multistage solver's, the crown path only
crown_factor and crown_solve, no path before section 6 launches
admm_identify, and the general C/D paths launch it and the five generic
kernels and none of the multistage solver's; no path before section 7
launches an IPM kernel, the IPM paths launch none of the dual Newton's,
path A no crown-Riccati kernel and path C no chain-Riccati kernel; no path
before section 8 launches chain_full_solve_mat or jay_cr_solve, and each
sdunes solve launches chain_factor once an iteration and both of them once
a coarse iteration and 1 + its refinement steps times a final iteration,
and no other kernel; no path but section 9's launches a CR kernel, and the
MPC path launches the five generic kernels and no other. Prints the JSON
summary of all 28 kernels, then the device JSON as the last line.
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
N_REQUESTS = 8          # two-phase cold and warm requests each
N_REQUESTS_1P = 4       # one-phase (slice 1) cold and warm requests each
N_REQUESTS_2N = 2       # two-phase two-norm requests, cold then warm
N_REQUESTS_B = 8        # bench-path cold and warm requests each
PERT = 0.02
SLICE_OPTS = dict(stage_solver="clipping", tol=TOL, max_iter=120,
                  factor_dtype="float32", refine_steps=2,
                  refine_safeguard=False, chain_backend="pallas",
                  reg_type="always", reg_value=1e-6, f32_phase_tol=0.0,
                  df64_phase=False)
# the main path of bench.py without its df64 phase
TWO_PHASE_OPTS = {**SLICE_OPTS, "f32_phase_tol": 1e-4, "f32_patience": 3}
# bench.py's options (bench_opts(on_tpu=True)): the high-precision phase is
# solvers/ms_df64.py's
BENCH_OPTS = {**TWO_PHASE_OPTS, "df64_phase": True}
# f32 kernels against f32 plain twins that sum in another order: factors
# to 1e-5 and solves to 1e-4 relative (tests/test_fused_eval.py,
# tests/test_crown_kernels.py use the same bounds); the evaluations sum in
# the twins' order without FMA contraction, so 1e-5 is a loose bound there
# and their active sets (Qinv or 0) must agree exactly
FACTOR_RTOL = 1e-5
SOLVE_RTOL = 1e-4
EVAL_RTOL = 1e-5
# at the trial point of newton_iter's "iter" mode the direction differs by
# the solve's rounding, so an active-set bit is held equal only where the
# twin's clipping input is this far from its bound (relative to max(1, |bound|))
TRIAL_MARGIN = 1e-4
# the f64 evaluations and the reduction reproduce their twins bit for bit;
# the f64 Hessian action to 1e-12 relative
BIT_EXACT = 0.0
DF_RTOL = 1e-12
# the generic-tree solver (models.GENERIC_SPEED_OPTS) on the headline tree
# pruned to GEN_SCEN scenarios; KKT bar of the reference's per-MPC-step check
GEN_SCEN = 128
N_REQUESTS_G = 4        # generic cold and warm requests each
GENERIC_KKT = 1e-6
# the general C/D trees (models.GENERAL_CD_OPTS): warm MPC requests of the
# qpgen chain, b + CD_DB (k + 1); the card and the CPU plain path agree on
# x and u to CD_GAP with the same iterations
N_REQUESTS_CD = 4
CD_DB = 1e-6
CD_GAP = 1e-9
CD_CPU_NR = 2  # the depth of that comparison: 16 scenarios, 309 nodes
# admm_identify repeats its twin's order of operations without FMA
# contraction: held to 1e-6 x max(1, max|lm|), the seeded working sets
# exactly
ADMM_RTOL = 1e-6
# the bound of a kernel: H100 SXM data-sheet rates (FP32 outside the
# tensor cores, FP64, HBM3)
PEAK_FLOPS = {False: 67e12, True: 34e12}
PEAK_BYTES = 3.35e12
# sdunes (models.SDUNES_OPTS, sdunes_bench's modes): boot requests, their
# high-precision-phase twins, sdunes_f32 requests (its tol), the depth of
# the card-vs-CPU comparison (64 scenarios: ~3 s on the CPU), and the Jay
# system held beyond the TPU kernel's caps (P, b) with its seed
N_REQUESTS_SD = 4
N_REQUESTS_SD_DF = 2
N_REQUESTS_F32 = 2
SD_F32_TOL = 1e-3
SD_CPU_NR = 3
JAY_BIG = (1023, 16)
JAY_SEED = 1039
# an f32 solve that is backward stable: ||J x - r|| over (||J|| ||x|| + ||r||)
JAY_BACKWARD = 1e-5
# the cyclic-reduction chain sweeps (slice 8): the CR pair held against the
# serial kernels to the 2e-4 of tests/test_chain_cr.py (absolute there, on
# O(1) data: here times max(1, max|serial|)); the right-hand sides' seed;
# solve pairs a shape on their path
CR_PAIR_RTOL = 2e-4
CR_SEED = 8
CR_LOOP = 4
# the MPC re-embedding path (slice 8) on the pruned headline tree: warm
# requests follow the closed loop (the plant driven by each solution's first
# control); x[1:] and u within MPC_GAP of the solve without the elimination
N_REQUESTS_MPC = 4
MPC_GAP = 1e-6


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


def compare_sets(torch, name, got, ref, keys, near=None):
    """Active-set outputs (Qinv or 0) bit for bit; ``near`` maps a key to a
    mask of components exempt from the check. Returns the count exempted."""
    exempt = 0
    for k in keys:
        ok = got[k] == ref[k]
        if near is not None:
            exempt += int((~ok & near[k]).sum())
            ok = ok | near[k]
        if not bool(ok.all()):
            fail(f"{name}: active set {k} differs from the twin's in "
                 f"{int((~ok).sum())} components")
    return exempt


def near_bound(torch, vU, lo, hi, mask):
    """Components whose clipping input lies within TRIAL_MARGIN of a bound."""
    near = torch.zeros_like(vU, dtype=torch.bool)
    for b in (lo, hi):
        near |= (vU - b).abs() < TRIAL_MARGIN * b.abs().clamp(min=1.0)
    return near & (mask > 0)


def nbytes(torch, *objs):
    """Bytes of every tensor in ``objs`` (tuples, lists and dicts walked),
    each counted once: a tensor met twice (an input that a kernel hands
    back among its outputs) moves once."""
    seen = {}

    def walk(o):
        if isinstance(o, torch.Tensor):
            key = (o.data_ptr(), o.dtype, tuple(o.shape))
            seen[key] = o.numel() * o.element_size()
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
    for o in objs:
        walk(o)
    return sum(seen.values())


# operation counts of the dense block routines (an FMA counts two)
def chol_ops(n):
    return n ** 3 / 3


def trsm_ops(m, n):
    return m * n * n


def syrk_ops(m, k):
    return 2 * m * m * k


def perturbed(qp, ms, fac):
    """Scale the pinned initial state (the root's bound rows) by ``fac``:
    the closed-loop MPC variation of bench.py."""
    def scale(q):
        xmin, xmax = q.xmin.clone(), q.xmax.clone()
        xmin[0] *= fac
        xmax[0] *= fac
        return q.replace(xmin=xmin, xmax=xmax)
    return scale(qp), None if ms is None else dataclasses.replace(ms, crown=scale(ms.crown))


def main():
    import numpy as np
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
    from treeqp_tpu_torch.core.qp_data import QP_FIELDS
    from treeqp_tpu_torch.models import (GENERAL_CD_OPTS, GENERIC_SPEED_OPTS, IPM_OPTS,
                                         SDUNES_BOOT_OPTS, SDUNES_OPTS, asym_tree,
                                         general_cd, pruned, quadcopter, spring_mass_chain)
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import chain_cr as ccr
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import crown_riccati as crk
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    from treeqp_tpu_torch.ops import df_reduce as dr
    from treeqp_tpu_torch.ops import iter_kernel as ik
    from treeqp_tpu_torch.ops import jay_kernel as jk
    from treeqp_tpu_torch.ops import qpgen_lanes as ql
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    from treeqp_tpu_torch.ops import system_kernels as sk
    from treeqp_tpu_torch.solvers import ipm
    from treeqp_tpu_torch.solvers import ipm_multistage as ims
    from treeqp_tpu_torch.solvers import ms_df64 as md
    from treeqp_tpu_torch.solvers import sdunes as sd
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
    t_start = time.perf_counter()
    libpath = _build.build()
    _build.lib()
    t_build = time.perf_counter() - t_start
    print(f"build: {t_build:.1f} s -> {libpath.relative_to(ROOT)}")
    for line in Path(str(libpath) + ".ptxas.txt").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 2. kernels against their plain twins, main-path shapes
    opts = td.TdunesOpts(**SLICE_OPTS)
    opts2 = td.TdunesOpts(**TWO_PHASE_OPTS)
    optsb = td.TdunesOpts(**BENCH_OPTS)
    # the coarse phase's options inside the two-phase solve
    opts_coarse = dataclasses.replace(optsb, refine_steps=0, tol=optsb.f32_phase_tol,
                                      ls_batch=4)
    quad = quadcopter(MD, NR, NH, device="cpu")
    qp_cpu = quad.qp
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

    def record(name, source, replaces, err, fn, ref_fn, shapes, inputs, ops,
               fp64=False, lib_fn=None):
        """One kernel's line: its times (kernel, plain twin, the library
        call if any) and its bound from this run's operands: the bytes of
        ``inputs`` and of fn()'s outputs, each moved once, and ``ops``
        operations at the FP32 (FP64 with ``fp64``) peak."""
        moved = nbytes(torch, inputs, fn())
        t_bytes, t_ops = moved / PEAK_BYTES, ops / PEAK_FLOPS[fp64]
        results.append(dict(
            name=name, route="cuda", source=f"treeqp_tpu_torch/csrc/{source}",
            replaces=replaces, max_abs_err=err, ms=cuda_ms(torch, fn, 50),
            plain_ms=cuda_ms(torch, ref_fn, 5), bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if lib_fn is None else cuda_ms(torch, lib_fn, 50),
            shapes=f"{shapes}; {moved} B, {ops:.4g} {'FP64' if fp64 else 'FP32'} ops"))

    def crown_ops(sched, factor, nz=None):
        """Operations of a crown factor (with the block build of each
        group when ``nz`` is given) or solve on ``sched``."""
        G, n, nlev = sched.G, sched.nxm, len(sched.lev_child)
        if not factor:
            return nlev * (2 * G * G + 4 * n * G) + 2 * G * G
        ops = nlev * (chol_ops(G) + trsm_ops(n, G) + syrk_ops(n, G)) + chol_ops(G)
        if nz is not None:
            ops += sched.NpG * (2 * G * G * nz + 3 * G * G + 3 * n * G)
        return ops

    # operation counts of the multistage kernels at the headline shapes
    S_, L_, nx_, nz_ = meta.S, meta.L, meta.nx, meta.nx + meta.nu
    Nc_ = meta.crown_topo.Nn

    def chain_factor_ops(shape, build=False):
        S, L, nx = shape[:3]
        per = nx * nx + chol_ops(nx) + trsm_ops(nx, nx) + syrk_ops(nx, nx)
        if build:
            per += 2 * nx * nx * shape[3] + 4 * nx * nx
        return S * L * per

    system_ops = S_ * L_ * 6 * nx_ * nx_ + crown_ops(ckr._get_sched(prep), False)
    chain_eval_ops = S_ * L_ * (4 * nx_ * nz_ + 12 * nz_)
    crown_eval_ops = Nc_ * (4 * nx_ * nz_ + 12 * nz_)
    chain_apply_ops = S_ * L_ * (4 * nx_ * nz_ + 4 * nz_)
    crown_apply_ops = Nc_ * (4 * nx_ * nz_ + 4 * nz_)

    c_ref = ck.chain_blocks_factor_ref(*inp["chain"])
    c_got = ck.chain_blocks_factor(*inp["chain"])
    torch.cuda.synchronize()
    record("chain_blocks_factor", "chain_blocks_factor.cu",
           "treeqp_tpu/ops/chain_kernels.py:311",
           compare(torch, "chain_blocks_factor", c_got, c_ref, FACTOR_RTOL),
           lambda: ck.chain_blocks_factor(*inp["chain"]),
           lambda: ck.chain_blocks_factor_ref(*inp["chain"]),
           f"ABt {tuple(inp['chain'][0].shape)}", inp["chain"],
           chain_factor_ops(inp["chain"][0].shape, build=True))

    Ls, CUs, schur0, sc = c_ref
    Wadd = -tm._schur_scatter(schur0, ctx["g_of"], ctx["slot"], prep, prep.nxm)
    cargs = (*inp["crown"], Wadd, prep)
    w_ref = ckr.crown_blocks_factor_ref(*cargs, reg=reg)
    w_got = ckr.crown_blocks_factor(*cargs, reg=reg)
    torch.cuda.synchronize()
    record("crown_blocks_factor", "crown_blocks_factor.cu",
           "treeqp_tpu/ops/crown_kernels.py:332",
           compare(torch, "crown_blocks_factor", w_got, w_ref, FACTOR_RTOL),
           lambda: ckr.crown_blocks_factor(*cargs, reg=reg),
           lambda: ckr.crown_blocks_factor_ref(*cargs, reg=reg),
           f"CholW {tuple(w_ref[0].shape)}", (cargs[:-1], ckr._get_sched(prep).on(dev)),
           crown_ops(ckr._get_sched(prep), True, nz=inp["crown"][0].shape[-1]))

    CholW, CholUt = w_ref
    res_cr = td._dual_residual(ms.crown, cr, prep)
    res_ch = tm._chain_residual(ms, ch, cr["x"], cr["u"], ctx["rid"])
    rg = td._nodes_to_group_mm(res_cr * inp["s_node"], prep)
    rch = res_ch * sc
    sargs = (Ls, CUs, CholW, CholUt, rg, rch, prep, meta.root_ids)
    s_ref = sk.system_solve_ref(*sargs)
    s_got = sk.system_solve(*sargs)
    torch.cuda.synchronize()
    record("system_solve", "system_solve.cu", "treeqp_tpu/ops/system_kernels.py:74",
           compare(torch, "system_solve", s_got, s_ref, SOLVE_RTOL),
           lambda: sk.system_solve(*sargs), lambda: sk.system_solve_ref(*sargs),
           f"rch {tuple(rch.shape)}, rg {tuple(rg.shape)}",
           (sargs[:6], ckr._get_sched(prep).on(dev), sk.ms_sched(prep, meta.root_ids, dev)),
           system_ops)

    # the coarse phase's first iteration: f32 data, duals 0
    ms32 = ms.to(dtype=torch.float32)
    data_ch, data_cr = tm._eval_data(ms32, prep)
    ctx32 = tm._solve_ctx(ms32, prep)
    lam_cr32 = lam_cr.to(torch.float32)
    lam_ch32 = lam_ch.to(torch.float32)
    floats = lambda o, keys: [o[k] for k in keys]
    e_ref = ck.chain_eval_ref(data_ch, lam_ch32)
    e_got = ck.chain_eval(data_ch, lam_ch32)
    torch.cuda.synchronize()
    keys = ("x", "u", "xUnc", "uUnc", "res_part", "cqr", "fch")
    err = compare(torch, "chain_eval", floats(e_got, keys), floats(e_ref, keys), EVAL_RTOL)
    compare_sets(torch, "chain_eval", e_got, e_ref, ("qt", "rt"))
    record("chain_eval", "chain_eval.cu", "treeqp_tpu/ops/chain_kernels.py:402", err,
           lambda: ck.chain_eval(data_ch, lam_ch32),
           lambda: ck.chain_eval_ref(data_ch, lam_ch32),
           f"ABt {tuple(data_ch['ABt'].shape)}", (data_ch, lam_ch32), chain_eval_ops)

    extra = torch.zeros_like(data_cr["ABt"][:, 0])
    extra[ctx["rid"]] = e_ref["cqr"]
    r_ref = ckr.crown_eval_ref(data_cr, lam_cr32, extra, prep)
    r_got = ckr.crown_eval(data_cr, lam_cr32, extra, prep)
    torch.cuda.synchronize()
    keys = ("x", "u", "xUnc", "uUnc", "res", "fcr")
    err = compare(torch, "crown_eval", floats(r_got, keys), floats(r_ref, keys), EVAL_RTOL)
    compare_sets(torch, "crown_eval", r_got, r_ref, ("qtilde", "rtilde"))
    record("crown_eval", "crown_eval.cu", "treeqp_tpu/ops/crown_kernels.py:466", err,
           lambda: ckr.crown_eval(data_cr, lam_cr32, extra, prep),
           lambda: ckr.crown_eval_ref(data_cr, lam_cr32, extra, prep),
           f"ABt {tuple(data_cr['ABt'].shape)}",
           (data_cr, lam_cr32, extra, ckr.eval_sched(prep, dev)), crown_eval_ops)

    largs = tm._factor_inputs(r_ref["qtilde"], r_ref["rtilde"], e_ref["qt"],
                              e_ref["rt"], prep, ctx32, lanes=True)["chain"]
    l_ref = ck.chain_blocks_factor_lanes_ref(*largs)
    l_got = ck.chain_blocks_factor_lanes(*largs)
    torch.cuda.synchronize()
    record("chain_blocks_factor_lanes", "chain_blocks_factor.cu",
           "treeqp_tpu/ops/chain_kernels.py:534",
           compare(torch, "chain_blocks_factor_lanes", l_got, l_ref, FACTOR_RTOL),
           lambda: ck.chain_blocks_factor_lanes(*largs),
           lambda: ck.chain_blocks_factor_lanes_ref(*largs),
           f"ABt {tuple(largs[0].shape)}", largs,
           chain_factor_ops(largs[0].shape, build=True))

    iter_keys = ("dcr", "dch", "lam2_cr", "lam2_ch", "res2_cr", "res2_ch", "x",
                 "u", "cx", "cu", "xUnc", "uUnc", "cxUnc", "cuUnc")
    part_keys = ("f1p", "dotp", "errp")
    set_keys = ("qt", "rt", "qtilde", "rtilde")

    def iter_outputs(o):
        return [o[k] for k in iter_keys] + [p for k in part_keys for p in o[k]]

    state = dict(lam_cr=lam_cr32, lam_ch=lam_ch32)
    iargs = (data_ch, data_cr, None, state, prep, meta.root_ids)
    v_ref = ik.newton_iter_ref(*iargs, mode="eval")
    v_got = ik.newton_iter(*iargs, mode="eval")
    torch.cuda.synchronize()
    err_eval = compare(torch, "newton_iter(eval)", iter_outputs(v_got),
                       iter_outputs(v_ref), EVAL_RTOL)
    compare_sets(torch, "newton_iter(eval)", v_got, v_ref, set_keys)
    ms_eval = cuda_ms(torch, lambda: ik.newton_iter(*iargs, mode="eval"), 50)
    fact = tm._ms_factorize(ms32, v_ref["qtilde"], v_ref["rtilde"], v_ref["qt"],
                            v_ref["rt"], td.TdunesOpts(**TWO_PHASE_OPTS), prep,
                            ctx32, lanes=True)
    state = dict(state, res_cr=v_ref["res2_cr"], res_ch=v_ref["res2_ch"])
    iargs = (data_ch, data_cr, fact, state, prep, meta.root_ids)
    i_ref = ik.newton_iter_ref(*iargs, mode="iter")
    i_got = ik.newton_iter(*iargs, mode="iter")
    torch.cuda.synchronize()
    err = compare(torch, "newton_iter(iter)", iter_outputs(i_got), iter_outputs(i_ref),
                  SOLVE_RTOL)
    near = dict(
        qt=near_bound(torch, i_ref["xUnc"], data_ch["xmin"], data_ch["xmax"],
                      torch.ones_like(data_ch["xmin"])),
        rt=near_bound(torch, i_ref["uUnc"], data_ch["umin"], data_ch["umax"],
                      torch.ones_like(data_ch["umin"])),
        qtilde=near_bound(torch, i_ref["cxUnc"], data_cr["xmin"], data_cr["xmax"],
                          data_cr["xm"]),
        rtilde=near_bound(torch, i_ref["cuUnc"], data_cr["umin"], data_cr["umax"],
                          data_cr["um"]))
    exempt = compare_sets(torch, "newton_iter(iter)", i_got, i_ref, set_keys, near)
    record("newton_iter", "newton_iter.cu", "treeqp_tpu/ops/iter_kernel.py:79",
           max(err, err_eval), lambda: ik.newton_iter(*iargs, mode="iter"),
           lambda: ik.newton_iter_ref(*iargs, mode="iter"),
           f"S={meta.S} L={meta.L} crown {data_cr['ABt'].shape[0]} nodes; mode eval "
           f"{ms_eval:.4f} ms, max |diff| {err_eval:.3e}; iter-mode active-set "
           f"bits exempt near a bound: {exempt}",
           (data_ch, data_cr, fact, state, ik.iter_sched(prep, meta.root_ids, dev)),
           system_ops + chain_eval_ops + crown_eval_ops)

    # the high-precision phase's kernels at its first point on the bench
    # path: the duals the coarse phase ends with
    lam_cr_h, lam_ch_h, it_h, _ = tm._ms_newton_loop_mega(
        ms32, lam_cr32, lam_ch32, opts_coarse, 0, patience=optsb.f32_patience)
    dd = md.make_dd(ms, prep)
    lam_crd = lam_cr_h.double() * dd["cr"]["nrxm"]
    lam_chd = lam_ch_h.double()
    keys = ("x", "u", "qt", "rt", "xUnc", "uUnc", "res_part", "cqr", "fch")
    ch_ref = dek.chain_eval_df_ref(dd["ch"], lam_chd)
    ch_got = dek.chain_eval_df(dd["ch"], lam_chd)
    torch.cuda.synchronize()
    record("chain_eval_df", "chain_eval_df.cu", "treeqp_tpu/ops/df_eval_kernels.py:93",
           compare(torch, "chain_eval_df", floats(ch_got, keys), floats(ch_ref, keys),
                   BIT_EXACT),
           lambda: dek.chain_eval_df(dd["ch"], lam_chd),
           lambda: dek.chain_eval_df_ref(dd["ch"], lam_chd),
           f"ABt {tuple(dd['ch']['ABt'].shape)} f64, after {it_h} coarse iterations",
           (dd["ch"], lam_chd), chain_eval_ops, fp64=True)
    extra = md._root_extra(dd, ch_ref["cqr"])
    keys = ("x", "u", "qtilde", "rtilde", "xUnc", "uUnc", "res", "fcr")
    cr_ref = dek.crown_eval_df_ref(dd["cr"], lam_crd, extra, prep)
    cr_got = dek.crown_eval_df(dd["cr"], lam_crd, extra, prep)
    torch.cuda.synchronize()
    record("crown_eval_df", "crown_eval_df.cu", "treeqp_tpu/ops/df_eval_kernels.py:399",
           compare(torch, "crown_eval_df", floats(cr_got, keys), floats(cr_ref, keys),
                   BIT_EXACT),
           lambda: dek.crown_eval_df(dd["cr"], lam_crd, extra, prep),
           lambda: dek.crown_eval_df_ref(dd["cr"], lam_crd, extra, prep),
           f"ABt {tuple(dd['cr']['ABt'].shape)} f64",
           (dd["cr"], lam_crd, extra, ckr.eval_sched(prep, dev)), crown_eval_ops, fp64=True)
    # an f32 direction on the path: the dual gradient there
    res_crd, res_chd = md.df_residuals(dd, cr_ref, ch_ref)
    dcr, dch = res_crd.float(), res_chd.float()
    aargs = (dd["ch"], ch_ref["qt"], ch_ref["rt"], dch)
    keys = ("xl", "ul", "res_part", "cqr")
    a_ref = dek.chain_apply_df_ref(*aargs)
    a_got = dek.chain_apply_df(*aargs)
    torch.cuda.synchronize()
    record("chain_apply_df", "chain_apply_df.cu", "treeqp_tpu/ops/df_eval_kernels.py:237",
           compare(torch, "chain_apply_df", floats(a_got, keys), floats(a_ref, keys),
                   DF_RTOL),
           lambda: dek.chain_apply_df(*aargs), lambda: dek.chain_apply_df_ref(*aargs),
           f"d {tuple(dch.shape)} f32", aargs, chain_apply_ops, fp64=True)
    cargs = (dd["cr"], cr_ref["qtilde"], cr_ref["rtilde"], dcr,
             md._root_extra(dd, a_ref["cqr"]), prep)
    keys = ("xl", "ul", "res")
    c_ref = dek.crown_apply_df_ref(*cargs)
    c_got = dek.crown_apply_df(*cargs)
    torch.cuda.synchronize()
    record("crown_apply_df", "crown_apply_df.cu", "treeqp_tpu/ops/df_eval_kernels.py:555",
           compare(torch, "crown_apply_df", floats(c_got, keys), floats(c_ref, keys),
                   DF_RTOL),
           lambda: dek.crown_apply_df(*cargs), lambda: dek.crown_apply_df_ref(*cargs),
           f"d {tuple(dcr.shape)} f32", (cargs[:-1], ckr.eval_sched(prep, dev)),
           crown_apply_ops, fp64=True)
    # the phase's two reductions: the dual value's partials and the
    # directional derivative's terms
    fx = torch.cat([cr_ref["fcr"], ch_ref["fch"]])
    gx = torch.cat([(res_crd * dcr).reshape(-1), (res_chd * dch).reshape(-1)])
    r_got = [dr.df_reduce_flat(fx), dr.df_reduce_flat(gx)]
    r_ref = [dr.df_reduce_flat_ref(fx), dr.df_reduce_flat_ref(gx)]
    torch.cuda.synchronize()
    record("df_reduce_flat", "df_reduce.cu", "treeqp_tpu/ops/df_reduce.py:72",
           compare(torch, "df_reduce_flat", r_got, r_ref, BIT_EXACT),
           lambda: dr.df_reduce_flat(gx), lambda: dr.df_reduce_flat_ref(gx),
           f"n {gx.numel()} (the dual value's: {fx.numel()}, "
           f"{cuda_ms(torch, lambda: dr.df_reduce_flat(fx), 50):.4f} ms)",
           gx, gx.numel(), fp64=True, lib_fn=lambda: torch.sum(gx))
    # the generic-tree solver's tree-Cholesky kernels on each of its paths'
    # instances: the headline tree pruned to GEN_SCEN scenarios (split path;
    # timed) and the unpruned headline tree (split path, 256 chains) at their
    # cold start (zero duals), the asymmetric tree (crown path) two
    # iterations on
    optsg = td.TdunesOpts(**GENERIC_SPEED_OPTS)
    qg_cpu = pruned(qp_cpu, GEN_SCEN)
    qg = qg_cpu.to(dev)
    prepg = td._get_prep(qg.topo)
    split = td._split_sched(prepg)
    if split is None:
        fail("the pruned instance has no split schedule")
    print(f"generic instance: quadcopter({MD},{NR},{NH}) pruned to {GEN_SCEN} "
          f"scenarios: {qg.topo.Nn} nodes, {prepg.NpG} lambda-groups of dim "
          f"{prepg.G}, split into {len(split[0])} chain levels of {split[0][0][1]} "
          f"chains and {len(split[1])} crown levels")
    qa = asym_tree(device=dev)
    if td._split_sched(td._get_prep(qa.topo)) is not None:
        fail("the asymmetric tree has a split schedule")
    qp = qp_cpu.to(dev)
    # the general C/D trees of general_cd_bench (section 6)
    qc_cpu = general_cd("qpgen", device="cpu")
    qm_cpu = general_cd("mixed", device="cpu")
    qc, qm = qc_cpu.to(dev), qm_cpu.to(dev)
    optsc = td.TdunesOpts(**GENERAL_CD_OPTS)
    optsm = dataclasses.replace(optsc, stage_solver="mixed")
    # the options tdunes_solve derives from the data, for the calls below
    # that skip it
    optsc_d = dataclasses.replace(optsc, h_diag=True)
    optsm_d = dataclasses.replace(optsm, h_diag=True,
                                  node_solver=td.clipping_applicable_nodes(qm_cpu))
    print(f"general C/D instance: spring_mass_chain(4,4,4,20) with rows: {qc.topo.Nn} "
          f"nodes, nx={qc.topo.nxm} nu={qc.topo.num}, a row on every node (qpgen) or on "
          f"{qm.topo.Nn - sum(optsm_d.node_solver)} nodes (mixed), "
          f"{td._get_prep(qc.topo).NpG} lambda-groups of dim {td._get_prep(qc.topo).G}")

    def tree_chol_checks(q, tag, it, o=optsg):
        """Each tree-Cholesky kernel tdunes_solve launches on q, held against
        its twin on the operands at the dual point of the it-th iterate of
        the one-phase solve (0: the cold start; run through the plain twins
        on the CPU), in the order of _tree_chol_factor and _tree_chol_solve.
        Returns record()'s arguments by kernel name."""
        p = td._get_prep(q.topo)
        regg = o.reg_value
        lam = torch.zeros((q.topo.Nn, q.topo.nxm), dtype=torch.float64, device=dev)
        if it:
            o_it = dataclasses.replace(o, f32_phase_tol=0.0, max_iter=it)
            lam = td.tdunes_solve(q.to("cpu"), None, o_it).lam.to(dev)
        data = td._stage_data(q, o, p)
        sol = td._stage_solve(q, lam, data, o, p)
        sW, W, Ut = td._equilibrate(*td._build_dual_hessian(q, sol, data, o, p), p)
        rg = (td._nodes_to_group_mm(td._dual_residual(q, sol, p), p) * sW).float()
        out = {}

        def check(name, source, replaces, fn, ref_fn, rtol, shapes, inputs, ops):
            ref, got = ref_fn(), fn()
            torch.cuda.synchronize()
            many = isinstance(ref, tuple)
            err = compare(torch, f"{name} ({tag})", got if many else [got],
                          ref if many else [ref], rtol)
            out[name] = (name, source, f"treeqp_tpu/ops/{replaces}", err, fn, ref_fn,
                         shapes, inputs, ops)
            return ref

        split_q = td._split_sched(p)
        levels, Wcr, Utcr, rcr = None, W, Ut, rg
        if split_q is not None:
            sp = td._split_index(p, split_q, dev)
            n, K, Nc = p.nxm, p.K, sp["Nc"]
            Wc = (W[sp["chain"], :n, :n]
                  + regg * torch.eye(n, dtype=torch.float32, device=dev)).contiguous()
            Utc = Ut[sp["chain"], :, :n].contiguous()
            Ls, CUs, schur = check(
                "chain_factor", "chain_factor.cu", "chain_kernels.py:127",
                lambda: ck.chain_factor(Wc, Utc), lambda: ck.chain_factor_ref(Wc, Utc),
                FACTOR_RTOL, f"Wc {tuple(Wc.shape)}", (Wc, Utc), chain_factor_ops(Wc.shape))
            rch = rg[sp["chain"], :n].contiguous()
            sweep_ops = Wc.shape[0] * Wc.shape[1] * (3 * n * n + n)
            ys, radd = check(
                "chain_solve_bwd", "chain_sweeps.cu", "chain_kernels.py:175",
                lambda: ck.chain_solve_bwd(Ls, CUs, rch),
                lambda: ck.chain_solve_bwd_ref(Ls, CUs, rch), SOLVE_RTOL,
                f"res {tuple(rch.shape)}", (Ls, CUs, rch), sweep_ops)
            # the crown: the groups 0..Nc-1, with the chains' Schur blocks and
            # right-hand-side updates
            levels, Wcr, Utcr, rcr = sp["crown"], W[:Nc].clone(), Ut[:Nc], rg[:Nc].clone()
            Wcr.view(Nc, K, n, K, n)[sp["dad"], sp["slot"], :, sp["slot"], :] -= schur
            rcr.view(Nc, K, n)[sp["dad"], sp["slot"]] -= radd
        sched = ckr._get_sched(p, levels)
        CholW, CholUt = check(
            "crown_factor", "crown_factor.cu", "crown_kernels.py:241",
            lambda: ckr.crown_factor(Wcr, Utcr, p, reg=regg, levels=levels),
            lambda: ckr.crown_factor_ref(Wcr, Utcr, p, reg=regg, levels=levels),
            FACTOR_RTOL, f"W {tuple(Wcr.shape)}, {sched.n_lev} levels",
            (Wcr, Utcr, sched.on(dev)), crown_ops(sched, True))
        dcr = check(
            "crown_solve", "crown_solve.cu", "crown_kernels.py:280",
            lambda: ckr.crown_solve(CholW, CholUt, rcr, p, levels=levels),
            lambda: ckr.crown_solve_ref(CholW, CholUt, rcr, p, levels=levels),
            SOLVE_RTOL, f"rg {tuple(rcr.shape)}", (CholW, CholUt, rcr, sched.on(dev)),
            crown_ops(sched, False))
        if split_q is not None:
            droot = dcr.view(Nc, K, n)[sp["dad"], sp["slot"]].contiguous()
            check("chain_forward", "chain_sweeps.cu", "chain_kernels.py:207",
                  lambda: ck.chain_forward(Ls, CUs, ys, droot),
                  lambda: ck.chain_forward_ref(Ls, CUs, ys, droot), SOLVE_RTOL,
                  f"ys {tuple(ys.shape)}", (Ls, CUs, ys, droot), sweep_ops)
        return out

    # the asymmetric tree's cold start is ill-conditioned (its root block's
    # Schur complement cancels: a 1-ulp rsqrt difference shows as ~1e-5 in
    # its factor, tests/test_torch_generic_kernels.py), so its kernels are
    # held against their twins two iterations on; the general C/D tree's
    # blocks are the dense-P ones, W = Cf P Cf' (G = 32)
    checks = {tag: tree_chol_checks(q, tag, it, o) for tag, q, it, o in (
        ("pruned", qg, 0, optsg), ("asymmetric", qa, 2, optsg), ("unpruned", qp, 0, optsg),
        ("general C/D", qc, 0, optsc_d))}
    def chain_matrix(Ls, CUs):
        """Each chain's factor as one [L n, L n] matrix, lower triangular
        with its blocks in reversed order: Ls_{L-1-k} on the diagonal, CUs_{L-k}
        below it. The backward sweep solves it, the forward sweep its
        transpose: the library call beside the sweep kernels."""
        S, L, n, _ = Ls.shape
        T = torch.zeros((S, L * n, L * n), dtype=Ls.dtype, device=Ls.device)
        for k in range(L):
            T[:, k * n:(k + 1) * n, k * n:(k + 1) * n] = Ls[:, L - 1 - k]
            if k:
                T[:, k * n:(k + 1) * n, (k - 1) * n:k * n] = CUs[:, L - k]
        return T

    rev = lambda v: v.flip(1).reshape(v.shape[0], -1, 1).contiguous()
    _mv_t = lambda M, v: torch.einsum("sij,si->sj", M, v)  # M' v per chain

    def sweep_library(Ls, CUs, res, ys, droot):
        """The library calls of the backward and forward sweeps on these
        operands (batched torch.linalg.solve_triangular on chain_matrix and
        its transpose, the root term folded into the right-hand side
        beforehand), and the larger of their distances to the serial
        twins."""
        T = chain_matrix(Ls, CUs)
        Tt = T.mT.contiguous()
        rb = rev(res)
        rhs = ys.clone()
        rhs[:, 0] -= _mv_t(CUs[:, 0], droot)
        rf = rev(rhs)
        bwd = lambda: torch.linalg.solve_triangular(T, rb, upper=False)
        fwd = lambda: torch.linalg.solve_triangular(Tt, rf, upper=True)
        unrev = lambda v: v.reshape(ys.shape).flip(1)
        err = max(float((unrev(bwd()) - ck.chain_solve_bwd_ref(Ls, CUs, res)[0]).abs().max()),
                  float((unrev(fwd()) - ck.chain_forward_ref(Ls, CUs, ys, droot)).abs().max()))
        return bwd, fwd, err

    Ls_g, CUs_g, rch_g = checks["pruned"]["chain_solve_bwd"][7]
    ys_g, droot_g = checks["pruned"]["chain_forward"][7][2:]
    lib_bwd, lib_fwd, lib_err = sweep_library(Ls_g, CUs_g, rch_g, ys_g, droot_g)
    lib_fns = {"chain_solve_bwd": lib_bwd, "chain_forward": lib_fwd}
    for name, source, replaces, _, fn, ref_fn, shapes, inputs, ops in checks["pruned"].values():
        errs = {tag: c[name][3] for tag, c in checks.items() if name in c}
        lib = (f"; the library call (solve_triangular) |diff| {lib_err:.3e}"
               if name in lib_fns else "")
        record(name, source, replaces, max(errs.values()), fn, ref_fn,
               f"{shapes}; max |diff| "
               + ", ".join(f"{tag} {e:.3e}" for tag, e in errs.items()) + lib, inputs, ops,
               lib_fn=lib_fns.get(name))

    def admm_check(q, o, tag, lam):
        """admm_identify against its twin at a cold stage solve of q's
        coarse phase (f32 data) at the duals lam, on the general nodes; the
        working sets both seed must be equal. Returns (operands, max |diff|,
        operations, description, active rows)."""
        q = q.to(dtype=torch.float32)
        p = td._get_prep(q.topo)
        data = td._stage_data(q, o, p)
        hmod = torch.cat(td._modified_gradient(q, lam.to(q.dtype), p), dim=1)
        d = data.get("gen", data)
        if "idx" in d:
            hmod = hmod[d["idx"]]
        lo_c, hi_c, m_eq = td._general_bounds(d["lo"], d["hi"], d["m_lo"], d["m_hi"])
        args = td._admm_operands(hmod, d["Hinv"], d["G"], lo_c, hi_c, d["rho_row"],
                                 d["L_admm"])
        ref = ql.admm_identify_ref(*args, o.qpgen_iters)
        got = ql.admm_identify(*args, o.qpgen_iters)
        torch.cuda.synchronize()
        err = compare(torch, f"admm_identify ({tag})", [got], [ref], ADMM_RTOL)
        sets = [td._admm_working_sets(lm, d["rho_row"], d["m_lo"], d["m_hi"], m_eq)
                for lm in (got, ref)]
        for a, b in zip(*sets):
            if not torch.equal(a, b):
                fail(f"admm_identify ({tag}): the working sets it seeds differ from the "
                     f"twin's in {int((a != b).sum())} rows")
        N, ng, nz = args[0].shape
        it = o.qpgen_iters
        ops = N * (2 * ng * nz + 2 * ng + it * (4 * ng * nz + 2 * nz * nz + 6 * ng + nz))
        n_act = int(sum(m.sum() for m in sets[1]))
        bits = float((got == ref).float().mean())
        return args, err, ops, (f"G {tuple(args[0].shape)} f32, {it} iterations, {n_act} "
                                f"active rows, {100 * bits:.1f}% of lm bit-equal"), n_act

    # the first cold stage solve (duals 0: nothing active yet; timed) and
    # the cold stage solve at the end of the coarse phase (rows active)
    it_a = optsc.qpgen_iters
    checks_a = {}
    for tag, q, o_solve, o in (("qpgen", qc, optsc, optsc_d), ("mixed", qm, optsm, optsm_d)):
        zero = torch.zeros((q.topo.Nn, q.topo.nxm), dtype=torch.float64, device=dev)
        lam_c = td.tdunes_solve(q, None, dataclasses.replace(o_solve, max_iter=5)).lam
        checks_a[tag] = [admm_check(q, o, f"{tag}, {what}", lam)
                         for what, lam in (("duals 0", zero), ("coarse end", lam_c))]
        if checks_a[tag][1][4] <= 0:
            fail(f"admm_identify ({tag}): no active row at the coarse phase's end")
    ac, am = checks_a["qpgen"][0], checks_a["mixed"][0]
    errs_a = {f"{tag} {i}": c[1] for tag, cs in checks_a.items() for i, c in enumerate(cs)}
    # the f64 instantiation (qpgen_factor_dtype="same" on f64 data) on the
    # same operands
    a64 = [a.double() for a in checks_a["qpgen"][1][0]]
    got64, ref64 = ql.admm_identify(*a64, it_a), ql.admm_identify_ref(*a64, it_a)
    torch.cuda.synchronize()
    errs_a["qpgen f64"] = compare(torch, "admm_identify (f64)", [got64], [ref64], ADMM_RTOL)
    record("admm_identify", "admm_identify.cu", "treeqp_tpu/ops/qpgen_lanes.py:189",
           max(errs_a.values()), lambda: ql.admm_identify(*ac[0], it_a),
           lambda: ql.admm_identify_ref(*ac[0], it_a),
           f"{ac[3]}; mixed subset {am[3]}, "
           f"{cuda_ms(torch, lambda: ql.admm_identify(*am[0], it_a), 20):.4f} ms; at the "
           f"coarse phase's end: qpgen {checks_a['qpgen'][1][3]}, mixed "
           f"{checks_a['mixed'][1][3]}; max |diff| {max(errs_a.values()):.3e}", ac[0], ac[2])

    for r in results:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), library call "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
              f"max |diff| {r['max_abs_err']:.3e} [{r['shapes']}] on {card}")

    # ---- 3. main paths on the card, certified and held against the CPU
    ms_kernels = (ck.chain_blocks_factor, ckr.crown_blocks_factor, sk.system_solve,
                  ck.chain_eval, ckr.crown_eval, ck.chain_blocks_factor_lanes,
                  ik.newton_iter, dek.chain_eval_df, dek.crown_eval_df,
                  dek.chain_apply_df, dek.crown_apply_df, dr.df_reduce_flat)
    generic_kernels = (ck.chain_factor, ck.chain_solve_bwd, ck.chain_forward,
                       ckr.crown_factor, ckr.crown_solve)
    ipm_kernels = (rk.ric_chain_factor, rk.ric_chain_bwd, rk.ric_chain_fwd,
                   crk.crown_ric_factor, crk.crown_ric_solve)
    sd_kernels = (ck.chain_full_solve_mat, jk.jay_cr_solve)
    cr_kernels = (ccr.chain_cr_precompute, ccr.chain_solve_bwd_cr, ccr.chain_forward_cr)
    kernels = (ms_kernels + generic_kernels + (ql.admm_identify,) + ipm_kernels + sd_kernels
               + cr_kernels)
    ms_names = tuple(k.__name__ for k in ms_kernels)
    generic_names = tuple(k.__name__ for k in generic_kernels)
    admm_name = ("admm_identify",)
    ipm_names = tuple(k.__name__ for k in ipm_kernels)
    sd_names = tuple(k.__name__ for k in sd_kernels)
    cr_names = tuple(k.__name__ for k in cr_kernels)
    df_kernels = ("chain_eval_df", "crown_eval_df", "chain_apply_df",
                  "crown_apply_df", "df_reduce_flat")
    paths = {}

    def drive(path, needs, fn, forbid=generic_names + admm_name, ipm_path=False,
              sd_path=False, cr_path=False):
        """Run one main path with every launch count set to 0 just before
        it; read the counts just after. Each kernel in ``needs`` must have
        launched, none in ``forbid``, none of the IPM's Riccati kernels
        unless ``ipm_path``, none of sdunes' two unless ``sd_path`` and none
        of the CR sweeps unless ``cr_path`` (no solver calls them)."""
        if not ipm_path:
            forbid = tuple(forbid) + ipm_names
        if not sd_path:
            forbid = tuple(forbid) + sd_names
        if not cr_path:
            forbid = tuple(forbid) + cr_names
        for fn_k in kernels:
            fn_k.launches = 0
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        paths[path] = {fn_k.__name__: fn_k.launches for fn_k in kernels}
        print(f"launches on the {path} path: {paths[path]}")
        for k in needs:
            if paths[path][k] <= 0:
                fail(f"{k} was not launched by the {path} path")
        for k in forbid:
            if paths[path][k] != 0:
                fail(f"{k} was launched by the {path} path")
        return out

    facs = [1.0 + PERT * math.sin(1.0 + 1.7 * (k + 1.0)) for k in range(N_REQUESTS)]
    insts = [perturbed(qp, ms, f) for f in facs]

    def certified(qp_k, ms_k, start, o, what):
        cro_k, cho_k, info_k = tm.tdunes_ms_solve(ms_k, *start, o)
        out_k = tm.merge_output(ms_k, cro_k, cho_k, info_k)
        kkt_k = max_kkt_residual(qp_k, out_k)
        if info_k["status"] != td.TDUNES_OPTIMAL or not info_k["error"] < TOL \
                or not kkt_k < TOL:
            fail(f"{what}: status {info_k['status']} error {info_k['error']} kkt {kkt_k}")
        if tuple(out_k.x.shape) != (ms_k.meta.full_topo.Nn, ms_k.meta.full_topo.nxm) \
                or not torch.isfinite(out_k.lam).all():
            fail(f"{what}: output of the wrong shape or not finite")
        return cro_k, cho_k, info_k, out_k, kkt_k

    def requests(o, n, modes, lam0, what):
        """Solve the first n perturbed instances in each mode (cold: zero
        duals; warm: the previous request's), each certified; returns
        {mode: (ms per solve, iterations, coarse iterations)}."""
        timing = {}
        for mode in modes:
            iters, coarse = [], []
            prev = lam0 or (None, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k, (qp_k, ms_k) in enumerate(insts[:n]):
                start = prev if mode == "warm" else (None, None)
                cro_k, cho_k, info_k, _, _ = certified(qp_k, ms_k, start, o,
                                                       f"{what} {mode} request {k}")
                iters.append(info_k["iter"])
                coarse.append(info_k["iter_f32"])
                prev = (cro_k["lam"], cho_k["lam"])
            torch.cuda.synchronize()
            timing[mode] = ((time.perf_counter() - t0) / n * 1e3, iters, coarse)
            print(f"requests {what} {mode}: iters {iters} (coarse {coarse}), "
                  f"{timing[mode][0]:.1f} ms/solve incl. KKT check on {card}")
        return timing

    def headline(o, what, same_iters=False):
        """The cold headline solve on the card, certified, and held against
        the same solve through the plain twins on the CPU: iteration counts
        within one (equal with ``same_iters``), the solutions within the
        slice tolerances."""
        t0 = time.perf_counter()
        cro, cho, info, out, kkt = certified(qp, ms, (None, None), o, what)
        t_solve = time.perf_counter() - t0
        print(f"{what}: iter {info['iter']} (coarse {info['iter_f32']}) status "
              f"{info['status']} error {info['error']:.3e} kkt {kkt:.3e} in "
              f"{t_solve * 1e3:.1f} ms (first solve, includes warm-up) on {card}")
        # the same solve through the plain twins on the CPU
        cro_c, cho_c, info_c = tm.tdunes_ms_solve(ms_cpu, None, None, o)
        out_c = tm.merge_output(ms_cpu, cro_c, cho_c, info_c)
        gaps = {f: float((getattr(out, f).cpu() - getattr(out_c, f)).abs().max())
                for f in ("x", "u", "lam")}
        print(f"{what}, card vs CPU plain path: iter {info['iter']} vs "
              f"{info_c['iter']}, coarse {info['iter_f32']} vs {info_c['iter_f32']}, "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
        slack = 0 if same_iters else 1
        if abs(info["iter"] - info_c["iter"]) > slack \
                or abs(info["iter_f32"] - info_c["iter_f32"]) > slack \
                or gaps["x"] > 1e-7 or gaps["u"] > 1e-7 or gaps["lam"] > 1e-6:
            fail(f"{what}: card and CPU solves disagree: {gaps}")
        return cro, cho, info

    # one-phase (slice 1): f64 loop, f32 factors, two refinement steps
    def one_phase():
        cro, cho, _ = headline(opts, "one-phase headline solve")
        return requests(opts, N_REQUESTS_1P, ("cold", "warm"),
                        (cro["lam"], cho["lam"]), "one-phase")
    t1 = drive("one-phase", ("chain_blocks_factor", "crown_blocks_factor",
                             "system_solve"), one_phase)

    # two-phase: coarse f32 phase on newton_iter, then the f64 loop
    def two_phase():
        cro, cho, info = headline(opts2, "two-phase headline solve")
        if info["iter_f32"] < 1:
            fail("two-phase headline solve ran no coarse iteration")
        return requests(opts2, N_REQUESTS, ("cold", "warm"),
                        (cro["lam"], cho["lam"]), "two-phase")
    t2 = drive("two-phase", ("newton_iter", "chain_blocks_factor_lanes",
                             "crown_blocks_factor", "system_solve",
                             "chain_blocks_factor"), two_phase)

    # the bench path: bench.py's options, the coarse phase then ms_df64's
    def bench_path():
        cro, cho, info = headline(optsb, "bench-path headline solve", same_iters=True)
        if info["iter_f32"] < 1 or info["iter"] <= info["iter_f32"]:
            fail(f"bench-path headline solve: phases {info}")
        return requests(optsb, N_REQUESTS_B, ("cold", "warm"),
                        (cro["lam"], cho["lam"]), "bench-path")
    tb = drive("bench", ("newton_iter", "chain_blocks_factor_lanes",
                         "crown_blocks_factor", "system_solve") + df_kernels, bench_path)

    # factorizations of one cold bench solve, and the handover: the
    # high-precision phase from the coarse phase's last duals with and
    # without the coarse phase's last factorization
    def handover():
        facs = (ck.chain_blocks_factor, ck.chain_blocks_factor_lanes)
        count = lambda: sum(k.launches for k in facs)
        _, _, info = tm.tdunes_ms_solve(ms, None, None, optsb)
        n_solve = count()
        z_cr = torch.zeros_like(lam_cr32)
        lam_cr, lam_ch, it0, ho = tm._ms_newton_loop_mega(
            ms32, z_cr, torch.zeros_like(lam_ch32), opts_coarse, 0,
            patience=optsb.f32_patience)
        n0 = count()
        cr, ch = md.df_stage_solve(dd, prep, lam_cr.double() * dd["cr"]["nrxm"],
                                   lam_ch.double())
        same = tm._pattern_equal((cr["qtilde"], cr["rtilde"], ch["qt"], ch["rt"]), ho[1])
        out_h = md.ms_newton_loop_df(ms, lam_cr.double(), lam_ch.double(), optsb, it0,
                                     handover=ho)
        n1 = count()
        out_n = md.ms_newton_loop_df(ms, lam_cr.double(), lam_ch.double(), optsb, it0)
        n2 = count()
        print(f"bench cold solve: {n_solve} factorizations ({info['iter']} iter, "
              f"{info['iter_f32']} coarse); the coarse phase {n0 - n_solve}, the "
              f"high-precision phase {n1 - n0} with the handover vs {n2 - n1} "
              f"without (patterns equal at the handover: {same}; iterations "
              f"{out_h[2]} vs {out_n[2]})")
        if same and n1 - n0 != n2 - n1 - 1:
            fail("the handover did not save the phase's first factorization")
        return dict(solve=n_solve, coarse=n0 - n_solve, df_handover=n1 - n0,
                    df_without=n2 - n1, pattern_equal=same)
    drive("bench handover", ("chain_blocks_factor_lanes",) + df_kernels, handover)

    # ---- 4. more requests
    # two-norm termination: the coarse phase's per-kernel loop
    opts2n = td.TdunesOpts(**{**TWO_PHASE_OPTS, "termination": "twonorm"})
    drive("two-phase two-norm", ("chain_eval", "crown_eval",
                                 "chain_blocks_factor_lanes"),
          lambda: requests(opts2n, N_REQUESTS_2N, ("cold", "warm"), None,
                           "two-phase two-norm"))
    print("per solve, one-phase vs two-phase vs bench path (ms incl. KKT check; "
          f"mean iterations, coarse share) on {card}:")
    for mode in ("cold", "warm"):
        (a, ia, _), (b, ib, cb), (c, ic, cc) = t1[mode], t2[mode], tb[mode]
        print(f"  {mode}: {a:.1f} ms ({statistics.mean(ia):.2f} iter) vs "
              f"{b:.1f} ms ({statistics.mean(ib):.2f} iter, "
              f"{statistics.mean(cb):.2f} coarse) vs {c:.1f} ms "
              f"({statistics.mean(ic):.2f} iter, {statistics.mean(cc):.2f} coarse)")

    # the 1024-scenario tree (1365-node crown): both coarse loops launch
    qp5_cpu = quadcopter(MD, 5, NH, device="cpu").qp
    qp5 = qp5_cpu.to(dev)
    ms5 = tm.split_multistage(qp5)

    def big():
        for o, what in ((opts2, "infnorm"), (opts2n, "two-norm"), (optsb, "bench")):
            t0 = time.perf_counter()
            _, _, info5, _, kkt5 = certified(qp5, ms5, (None, None), o,
                                             f"quadcopter({MD},5,{NH}) {what}")
            print(f"quadcopter({MD},5,{NH}) two-phase {what}: S={ms5.meta.S}, "
                  f"crown {ms5.meta.crown_topo.Nn} nodes, iter {info5['iter']} "
                  f"(coarse {info5['iter_f32']}) kkt {kkt5:.3e} in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first solve) on {card}")
    drive("1024-scenario", ("newton_iter", "crown_eval", "chain_eval") + df_kernels, big)

    # ---- 5. the generic-tree solver (slice 4)
    gfacs = [1.0 + PERT * math.sin(1.0 + 1.7 * (k + 1.0)) for k in range(N_REQUESTS_G)]
    ginsts = [perturbed(qg, None, f)[0] for f in gfacs]

    def g_certified(qp_k, lam0, what):
        """One tdunes_solve request, certified: OPTIMAL, stationarity
        < 1e-8, the port's KKT < GENERIC_KKT, finite output of the right
        shape. Returns (out, kkt, ms, factorizations)."""
        n0 = ckr.crown_factor.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = td.tdunes_solve(qp_k, lam0, optsg)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        kkt_k = max_kkt_residual(qp_k, out_k)
        info_k = out_k.info
        if info_k["status"] != td.TDUNES_OPTIMAL or not info_k["error"] < TOL \
                or not kkt_k < GENERIC_KKT:
            fail(f"{what}: status {info_k['status']} error {info_k['error']} kkt {kkt_k}")
        if tuple(out_k.x.shape) != (qp_k.topo.Nn, qp_k.topo.nxm) \
                or not torch.isfinite(out_k.lam).all():
            fail(f"{what}: output of the wrong shape or not finite")
        return out_k, kkt_k, t_ms, ckr.crown_factor.launches - n0

    def g_headline(q, q_cpu, what):
        """The first cold solve of q, certified, and held against the same
        solve through the plain twins on the CPU: iterations within one,
        x and u within 1e-7, lambda within 1e-6."""
        out, kkt, t_ms, nf = g_certified(q, None, what)
        info = out.info
        out_c = td.tdunes_solve(q_cpu, None, optsg)
        gaps = {f: float((getattr(out, f).cpu() - getattr(out_c, f)).abs().max())
                for f in ("x", "u", "lam")}
        print(f"{what} ({q.topo.Nn} nodes): iter {info['iter']} ({info['iter_f32']} "
              f"coarse + {info['iter'] - info['iter_f32']} final), error "
              f"{info['error']:.3e}, kkt {kkt:.3e}, {nf} factorizations, {t_ms:.1f} ms "
              f"(first solve); card vs CPU plain path: iter {info['iter']} vs "
              f"{out_c.info['iter']}, "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()) + f" on {card}")
        if abs(info["iter"] - out_c.info["iter"]) > 1 or gaps["x"] > 1e-7 \
                or gaps["u"] > 1e-7 or gaps["lam"] > 1e-6:
            fail(f"{what}: card and CPU solves disagree: {gaps}")
        return out

    def generic_split():
        out = g_headline(qg, qg_cpu, "generic headline solve")
        timing = {}
        for mode in ("cold", "warm"):
            prev, rows = out.lam, []
            for k, qp_k in enumerate(ginsts):
                o_k, kkt_k, t_k, nf_k = g_certified(
                    qp_k, prev if mode == "warm" else None, f"generic {mode} request {k}")
                rows.append((o_k.info["iter"], o_k.info["iter_f32"], t_k, nf_k, kkt_k))
                prev = o_k.lam
            timing[mode] = rows
            print(f"requests generic {mode}: iters {[r[0] for r in rows]} (coarse "
                  f"{[r[1] for r in rows]}), factorizations {[r[3] for r in rows]}, "
                  f"{statistics.mean(r[2] for r in rows):.1f} ms/solve (median "
                  f"{statistics.median(r[2] for r in rows):.1f}), max kkt "
                  f"{max(r[4] for r in rows):.3e} on {card}")
        return timing
    drive("generic split", generic_names, generic_split, forbid=ms_names + admm_name)

    # the crown path: the asymmetric thesis-class tree has no split schedule
    drive("generic crown", ("crown_factor", "crown_solve"),
          lambda: g_headline(qa, asym_tree(device="cpu"), "asymmetric tree"),
          forbid=ms_names + admm_name + ("chain_factor", "chain_solve_bwd", "chain_forward"))

    # tdunes_solve on the unpruned headline tree (split path, 256 chains)
    # against tdunes_ms_solve at bench options, on the same card
    def cross_check():
        out_g, kkt_g, t_g, _ = g_certified(qp, None, "generic solve of the headline tree")
        cro, cho, info = tm.tdunes_ms_solve(ms, None, None, optsb)
        out_m = tm.merge_output(ms, cro, cho, info)
        gaps = {f: float((getattr(out_g, f) - getattr(out_m, f)).abs().max())
                for f in ("x", "u", "lam")}
        print(f"headline tree, tdunes_solve vs tdunes_ms_solve (bench options): iter "
              f"{out_g.info['iter']} vs {info['iter']}, kkt {kkt_g:.3e} vs "
              f"{max_kkt_residual(qp, out_m):.3e}, "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items())
              + f", {t_g:.1f} ms on {card}")
        if gaps["x"] > 1e-7 or gaps["u"] > 1e-7:
            fail(f"tdunes_solve and tdunes_ms_solve disagree on the headline tree: {gaps}")
    drive("generic cross-check", generic_names + ("newton_iter",), cross_check,
          forbid=admm_name)

    # ---- 6. general C/D trees (slice 5)
    def c_certified(q, lam0, ws0, o, what):
        """One general C/D request, certified: OPTIMAL, stationarity below
        the options' tol, the port's KKT < 1e-8, finite output of the right
        shape. Returns (out, kkt, ms, factorizations, ADMM launches)."""
        nf0, na0 = ckr.crown_factor.launches, ql.admm_identify.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = td.tdunes_solve(q, lam0, o, stage_ws=ws0)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        kkt_k = max_kkt_residual(q, out_k)
        info_k = out_k.info
        if info_k["status"] != td.TDUNES_OPTIMAL or not info_k["error"] < o.tol \
                or not kkt_k < TOL:
            fail(f"{what}: status {info_k['status']} error {info_k['error']} kkt {kkt_k}")
        if tuple(out_k.x.shape) != (q.topo.Nn, q.topo.nxm) \
                or tuple(out_k.mu_d.shape) != (q.topo.Nn, q.topo.ncm) \
                or not all(bool(torch.isfinite(v).all()) for v in
                           (out_k.x, out_k.u, out_k.lam, out_k.mu_d)):
            fail(f"{what}: output of the wrong shape or not finite")
        return (out_k, kkt_k, t_ms, ckr.crown_factor.launches - nf0,
                ql.admm_identify.launches - na0)

    def c_line(what, out, kkt, t_ms, nf, na):
        info = out.info
        return (f"{what}: iter {info['iter']} ({info['iter_f32']} coarse + "
                f"{info['iter'] - info['iter_f32']} final), error {info['error']:.3e}, kkt "
                f"{kkt:.3e}, qpgen_res {info['qpgen_res']:.2e}, max |mu_d| "
                f"{float(out.mu_d.abs().max()):.3e}, {nf} factorizations, {na} ADMM "
                f"launches, {t_ms:.1f} ms")

    def general_qpgen():
        first = c_certified(qc, None, None, optsc, "general C/D qpgen cold solve")
        print(c_line(f"general C/D qpgen cold solve ({qc.topo.Nn} nodes)", *first)
              + f" (first solve, includes warm-up) on {card}")
        again = c_certified(qc, None, None, optsc, "general C/D qpgen cold solve (again)")
        print(c_line("general C/D qpgen cold solve (again)", *again) + f" on {card}")
        prev, rows = first[0], []
        for k in range(N_REQUESTS_CD):
            q_k = qc.replace(b=qc.b + CD_DB * (k + 1))
            r = c_certified(q_k, prev.lam, prev.info["qpgen_ws"], optsc,
                            f"general C/D qpgen warm request {k}")
            print(c_line(f"general C/D qpgen warm request {k} (b + {CD_DB * (k + 1):g})", *r)
                  + f" on {card}")
            rows.append(r)
            prev = r[0]
        print(f"requests general C/D qpgen warm: iters {[r[0].info['iter'] for r in rows]}, "
              f"ADMM launches {[r[4] for r in rows]}, "
              f"{statistics.mean(r[2] for r in rows):.1f} ms/solve (cold "
              f"{again[2]:.1f} ms), max kkt {max(r[1] for r in rows):.3e} on {card}")
        return first[0]
    out_qc = drive("general C/D qpgen", generic_names + admm_name, general_qpgen,
                   forbid=ms_names)

    def general_mixed():
        first = c_certified(qm, None, None, optsm, "general C/D mixed cold solve")
        print(c_line(f"general C/D mixed cold solve ({qm.topo.Nn} nodes)", *first)
              + f" (first solve) on {card}")
        again = c_certified(qm, None, None, optsm, "general C/D mixed cold solve (again)")
        print(c_line("general C/D mixed cold solve (again)", *again) + f" on {card}")
        return first[0]
    drive("general C/D mixed", generic_names + admm_name, general_mixed, forbid=ms_names)

    # the cold qpgen solve through the plain twins on the CPU, at the depth
    # CD_CPU_NR (the full tree takes ~6 minutes on the CPU)
    qs_cpu = general_cd("qpgen", Nr=CD_CPU_NR, device="cpu")
    out_s = c_certified(qs_cpu.to(dev), None, None, optsc, "general C/D qpgen, reduced")[0]
    t0 = time.perf_counter()
    out_cpu = td.tdunes_solve(qs_cpu, None, optsc)
    t_cpu = time.perf_counter() - t0
    gaps = {f: float((getattr(out_s, f).cpu() - getattr(out_cpu, f)).abs().max())
            for f in ("x", "u", "lam", "mu_d")}
    ic, ip = out_s.info, out_cpu.info
    print(f"general C/D qpgen cold solve at Nr={CD_CPU_NR} ({qs_cpu.topo.Nn} nodes), card vs "
          f"CPU plain path ({t_cpu:.1f} s on the CPU): iter {ic['iter']} vs {ip['iter']}, "
          f"coarse {ic['iter_f32']} vs {ip['iter_f32']}, "
          + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    if ic["iter"] != ip["iter"] or ic["iter_f32"] != ip["iter_f32"] \
            or gaps["x"] > CD_GAP or gaps["u"] > CD_GAP:
        fail(f"general C/D qpgen: card and CPU solves disagree: {gaps}")

    # ---- 7. the interior-point engine (slice 6)
    f32 = torch.float32
    opts_ipm = {k: ipm.IpmOpts(**v) for k, v in IPM_OPTS.items()}
    qa_cpu = general_cd("qpgen", device="cpu")        # path A: a row on every node
    qb_cpu = spring_mass_chain(4, 4, 4, 20, device="cpu")[0]  # B and C: box-only
    qc2_cpu = spring_mass_chain(4, 4, 3, 7, device="cpu")[0]  # C within the TPU caps
    msa_cpu, msb_cpu = tm.split_multistage(qa_cpu), tm.split_multistage(qb_cpu)
    qa, qb, qc2 = qa_cpu.to(dev), qb_cpu.to(dev), qc2_cpu.to(dev)
    msa, msb = msa_cpu.to(dev), msb_cpu.to(dev)
    print(f"IPM instances: A general_cd qpgen ({qa.topo.Nn} nodes, S={msa.meta.S} "
          f"L={msa.meta.L}, crown {msa.meta.crown_topo.Nn} nodes, nx={qa.topo.nxm} "
          f"nu={qa.topo.num}); B box-only spring_mass_chain(4,4,4,20) ({qb.topo.Nn} nodes); "
          f"C the same tree whole and spring_mass_chain(4,4,3,7) ({qc2.topo.Nn} nodes, "
          f"{qc2.topo.Nh + 1} stages)")

    def capture(wrappers, fn):
        """Run fn() with the wrappers ``names`` of each ``(mod, names)`` in
        ``wrappers`` recording the operands of every call; returns ({name:
        [(args, kwargs), ...]}, fn()'s result). A wrapper adds one to the
        count of the name its module binds, which during the capture is the
        stand-in: so each stand-in carries a count, and the kernels' own
        counts do not move (``drive`` sets them to 0 before each main path
        in any case)."""
        got, orig = {}, {(mod, n): getattr(mod, n) for mod, names in wrappers for n in names}

        def stand_in(mod, n):
            def w(*a, **k):
                got.setdefault(n, []).append((a, k))
                return orig[mod, n](*a, **k)
            w.launches = 0
            return w
        for mod, n in orig:
            setattr(mod, n, stand_in(mod, n))
        try:
            res = fn()
        finally:
            for (mod, n), f in orig.items():
                setattr(mod, n, f)
        return got, res

    def first_iteration(fn, key):
        """The operands each IPM kernel takes at the first f32 iteration of
        the solve fn(opts) of path ``key``."""
        one = ipm.IpmOpts(**{**IPM_OPTS[key], "max_iter": 1})
        got, _ = capture(((rk, ipm_names[:3]), (crk, ipm_names[3:])), lambda: fn(one))
        return {n: calls[0] for n, calls in got.items()}

    def stage_ops(nx, nz, part):
        """Operations of one Riccati stage (an FMA counts two)."""
        nu = nz - nx
        if part == "factor":
            return (chol_ops(nu) + 2 * nu * nu * nx + 2 * nx * nu * nx + 2 * nx * nx * nz
                    + 2 * nz * nz * nx + nz * nz)
        if part == "bwd":
            return 2 * nu * nu + 2 * nx * nu + 2 * nx * nx + 2 * nx * nz + nz
        return 2 * nx * nz + 2 * nu * nx + 2 * nx * nx

    ops_at = {
        "A": first_iteration(lambda o: ims.ipm_ms_solve(msa, o), "cd"),
        "B": first_iteration(lambda o: ims.ipm_ms_solve(msb, o), "box"),
        "C4437": first_iteration(lambda o: ipm.ipm_solve(qb, o), "cd"),
        f"C{qc2.topo.Nn}": first_iteration(lambda o: ipm.ipm_solve(qc2, o), "cd")}
    ipm_checks = {}

    def ipm_check(name, path, fn, ref_fn, rtol, shapes, inputs, ops):
        ref, got = ref_fn(), fn()
        torch.cuda.synchronize()
        if isinstance(ref, tuple) and isinstance(ref[0], dict):
            got = [got[0][k] for k in ("P", "Luu", "K", "Mxu")] + list(got[1:])
            ref = [ref[0][k] for k in ("P", "Luu", "K", "Mxu")] + list(ref[1:])
        elif isinstance(ref, dict):
            got, ref = ([d[k] for k in ("P", "Luu", "K", "Mxu")] for d in (got, ref))
        err = compare(torch, f"{name} (path {path})", got, ref, rtol)
        ipm_checks.setdefault(name, {})[path] = (err, fn, ref_fn, shapes, inputs, ops)

    for path, got in ops_at.items():
        if "ric_chain_factor" in got:
            (hbar, AB), kw = got["ric_chain_factor"]
            S_, L_, nx_, nz_ = AB.shape
            ipm_check("ric_chain_factor", path,
                      lambda hbar=hbar, AB=AB, kw=kw: rk.ric_chain_factor(hbar, AB, **kw),
                      lambda hbar=hbar, AB=AB, kw=kw: rk.ric_chain_factor_ref(hbar, AB, **kw),
                      FACTOR_RTOL, f"hbar {tuple(hbar.shape)}", (hbar, AB),
                      S_ * L_ * stage_ops(nx_, nz_, "factor"))
            (fact, rg, rb), _ = got["ric_chain_bwd"]
            rg, rb = rg.to(f32).contiguous(), rb.to(f32).contiguous()
            ipm_check("ric_chain_bwd", path,
                      lambda fact=fact, rg=rg, rb=rb: rk.ric_chain_bwd(fact, rg, rb),
                      lambda fact=fact, rg=rg, rb=rb: rk.ric_chain_bwd_ref(fact, rg, rb),
                      SOLVE_RTOL, f"rg {tuple(rg.shape)}",
                      ([fact[k] for k in ("P", "Luu", "Mxu", "AB")], rg, rb),
                      S_ * L_ * stage_ops(nx_, nz_, "bwd"))
            (fact, p, k, rb, zr), _ = got["ric_chain_fwd"]
            rb, zr = rb.to(f32).contiguous(), zr.to(f32).contiguous()
            ipm_check("ric_chain_fwd", path,
                      lambda a=(fact, p, k, rb, zr): rk.ric_chain_fwd(*a),
                      lambda a=(fact, p, k, rb, zr): rk.ric_chain_fwd_ref(*a),
                      SOLVE_RTOL, f"rb {tuple(rb.shape)}",
                      ([fact[k] for k in ("P", "K", "AB")], p, k, rb, zr),
                      S_ * L_ * stage_ops(nx_, nz_, "fwd"))
        if "crown_ric_factor" in got:
            (hbar, AB, W0, prep_c, nx_), kw = got["crown_ric_factor"]
            Nc_c, nz_ = hbar.shape
            sched_c = crk._get_sched(prep_c)
            ipm_check("crown_ric_factor", path,
                      lambda a=(hbar, AB, W0, prep_c, nx_), kw=kw: crk.crown_ric_factor(*a, **kw),
                      lambda a=(hbar, AB, W0, prep_c, nx_), kw=kw:
                      crk.crown_ric_factor_ref(*a, **kw),
                      FACTOR_RTOL, f"hbar {tuple(hbar.shape)}, {sched_c.n_lev} levels",
                      (hbar, AB, W0, [v for k, v in sched_c.on(dev).items()
                                      if k != "par"]),  # the factor reads no parent
                      Nc_c * (stage_ops(nx_, nz_, "factor") + nz_ * nz_))
            (fact, rg, rb, w0, prep_c), _ = got["crown_ric_solve"]
            rg, rb, w0 = (v.to(f32).contiguous() for v in (rg, rb, w0))
            ipm_check("crown_ric_solve", path,
                      lambda a=(fact, rg, rb, w0, prep_c): crk.crown_ric_solve(*a),
                      lambda a=(fact, rg, rb, w0, prep_c): crk.crown_ric_solve_ref(*a),
                      SOLVE_RTOL, f"rg {tuple(rg.shape)}",
                      ([fact[k] for k in ("P", "Luu", "K", "Mxu", "AB")], rg, rb, w0,
                       sched_c.on(dev)),
                      Nc_c * (stage_ops(nx_, nz_, "bwd") + stage_ops(nx_, nz_, "fwd") + nz_)
                      + chol_ops(nx_) + 4 * nx_ * nx_)
    # timed at path A (the chain kernels: the dense headline) and path B
    # (the crown kernels: the 341-node crown with the chains' terms); the
    # other paths' differences and times go into the shapes note
    for name, timed in (("ric_chain_factor", "A"), ("ric_chain_bwd", "A"),
                        ("ric_chain_fwd", "A"), ("crown_ric_factor", "B"),
                        ("crown_ric_solve", "B")):
        runs = ipm_checks[name]
        err, fn, ref_fn, shapes, inputs, ops = runs[timed]
        others = ", ".join(
            f"path {p} {r[3]}: |diff| {r[0]:.3e}, "
            f"{cuda_ms(torch, r[1], 20):.4f} ms" for p, r in runs.items() if p != timed)
        source = "ric_chain.cu" if name.startswith("ric") else "crown_ric.cu"
        replaces = {"ric_chain_factor": "riccati_kernels.py:84",
                    "ric_chain_bwd": "riccati_kernels.py:150",
                    "ric_chain_fwd": "riccati_kernels.py:193",
                    "crown_ric_factor": "crown_riccati.py:98",
                    "crown_ric_solve": "crown_riccati.py:170"}[name]
        record(name, source, f"treeqp_tpu/ops/{replaces}", max(r[0] for r in runs.values()),
               fn, ref_fn, f"path {timed} {shapes}, |diff| {err:.3e}; {others}", inputs, ops)
    for r in results[-5:]:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library call none, "
              f"max |diff| {r['max_abs_err']:.3e} [{r['shapes']}] on {card}")

    ipm_launches = lambda: sum(k.launches for k in ipm_kernels)

    def i_certified(q, ms_q, o, ws, what):
        """One IPM request, certified: status 0, max(res4) < tol, the port's
        KKT < 1e-8, finite output of the right shape. Returns (out, the
        (crown, chain) pair or None, kkt, ms, IPM kernel launches)."""
        n0 = ipm_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if ms_q is None:
            out, pair = ipm.ipm_solve(q, o, ws=ws), None
        else:
            pair = ims.ipm_ms_solve(ms_q, o, ws=ws)
            out = tm.merge_output(ms_q, *pair)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        kkt = max_kkt_residual(q, out)
        info = out.info
        if info["status"] != ipm.IPM_OPTIMAL or not float(info["res4"].max()) < o.tol \
                or not kkt < TOL:
            fail(f"{what}: status {info['status']} res4 {info['res4'].tolist()} kkt {kkt}")
        if tuple(out.x.shape) != (q.topo.Nn, q.topo.nxm) or not all(
                bool(torch.isfinite(v).all()) for v in (out.x, out.u, out.lam, out.mu_d)):
            fail(f"{what}: output of the wrong shape or not finite")
        n = ipm_launches() - n0
        print(f"{what} ({q.topo.Nn} nodes): iter {info['iter']} ({info['iter_f32']} f32 + "
              f"{info['iter'] - info['iter_f32']} f64), max res4 "
              f"{float(info['res4'].max()):.3e}, kkt {kkt:.3e}, max |mu_d| "
              f"{float(out.mu_d.abs().max()):.3e}, {n} Riccati kernel launches, "
              f"{t_ms:.1f} ms on {card}")
        return out, pair, kkt, t_ms, n

    def shifted(q, ms_q, db):
        """The next MPC request: b + db on every edge, in both layouts."""
        bump = lambda x: x.replace(b=x.b + db)
        return bump(q), dataclasses.replace(ms_q, b=ms_q.b + db, crown=bump(ms_q.crown))

    def ms_path(tag, q, ms_q, o):
        first = i_certified(q, ms_q, o, None, f"IPM {tag} cold solve (first)")
        again = i_certified(q, ms_q, o, None, f"IPM {tag} cold solve (again)")
        prev, rows = first[1][:2], []
        for k in range(N_REQUESTS_CD):
            q_k, ms_k = shifted(q, ms_q, CD_DB * (k + 1))
            r = i_certified(q_k, ms_k, o, prev, f"IPM {tag} warm request {k} "
                            f"(b + {CD_DB * (k + 1):g})")
            rows.append(r)
            prev = r[1][:2]
        print(f"requests IPM {tag} warm: iters {[r[0].info['iter'] for r in rows]}, "
              f"{statistics.mean(r[3] for r in rows):.1f} ms/request (cold "
              f"{again[3]:.1f} ms), max kkt {max(r[2] for r in rows):.3e} on {card}")
        return first[0]

    tdunes_names = ms_names + generic_names + admm_name
    out_a = drive("IPM general C/D (A)", ipm_names[:3],
                  lambda: ms_path("A general C/D", qa, msa, opts_ipm["cd"]),
                  forbid=tdunes_names + ipm_names[3:], ipm_path=True)
    drive("IPM box-only multistage (B)", ipm_names,
          lambda: ms_path("B box-only", qb, msb, opts_ipm["box"]),
          forbid=tdunes_names, ipm_path=True)

    def generic_path():
        for q in (qb, qc2):
            for k in range(2):
                i_certified(q, None, opts_ipm["cd"], None,
                            f"IPM C generic tree cold solve ({'first' if k == 0 else 'again'})")
    drive("IPM generic tree (C)", ipm_names[3:], generic_path,
          forbid=tdunes_names + ipm_names[:3], ipm_path=True)

    # path A's cold solve through the plain twins on the CPU, at full depth:
    # iterations within one; x and u within 1e-7 at the same iteration
    # count. (On this tree one iteration past tol still moves x by ~6e-6
    # and u by ~8e-5, in JAX's solve too: tests/test_torch_ipm_ms.py::
    # test_general_cd_headline_ends_one_step_apart. So when the counts
    # differ by one, the longer solve is rerun stopped at the shorter one's
    # count and the two are compared there.)
    def solve_a(ms_q, **kw):
        pair = ims.ipm_ms_solve(ms_q, dataclasses.replace(opts_ipm["cd"], **kw))
        return tm.merge_output(ms_q, *pair)

    t0 = time.perf_counter()
    out_ac = solve_a(msa_cpu)
    t_cpu = time.perf_counter() - t0
    ia, ic = out_a.info, out_ac.info
    gap = lambda a, b: {f: float((getattr(a, f).cpu() - getattr(b, f)).abs().max())
                        for f in ("x", "u", "lam", "mu_d")}
    gaps = gap(out_a, out_ac)
    print(f"IPM A cold solve, card vs CPU plain path ({t_cpu:.1f} s on the CPU): iter "
          f"{ia['iter']} vs {ic['iter']} (f32 {ia['iter_f32']} vs {ic['iter_f32']}), "
          + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    n_eq = min(ia["iter"], ic["iter"])
    if ia["iter"] != ic["iter"]:
        card_n = out_a if ia["iter"] == n_eq else solve_a(msa, max_iter=n_eq)
        cpu_n = out_ac if ic["iter"] == n_eq else solve_a(msa_cpu, max_iter=n_eq)
        gaps = gap(card_n, cpu_n)
        print(f"IPM A, card vs CPU plain path, both stopped at {n_eq} iterations: "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    if abs(ia["iter"] - ic["iter"]) > 1 or gaps["x"] > 1e-7 or gaps["u"] > 1e-7:
        fail(f"IPM path A: card and CPU solves disagree at {n_eq} iterations: {gaps}")

    # ---- 8. sdunes (slice 7): sdunes_bench's three modes on its tree, the
    # box-only spring_mass_chain(4,4,4,20) of path B
    opts_sd = sd.SdunesOpts(**SDUNES_OPTS)
    opts_sd_df = dataclasses.replace(opts_sd, df64_phase=True)
    opts_boot = td.TdunesOpts(**SDUNES_BOOT_OPTS)
    opts_sd_f32 = dataclasses.replace(opts_sd, tol=SD_F32_TOL, max_iter=80, f32_phase_tol=0.0)
    opts_ms_f32 = dataclasses.replace(opts_boot, tol=SD_F32_TOL, max_iter=80, f32_phase_tol=0.0,
                                      df64_phase=False, refine_steps=0)
    sqp = sd.scenario_data(qb)
    sm = sqp.meta
    nl = sm.Nr * sm.nu
    print(f"sdunes instance: spring_mass_chain(4,4,4,20): {sm.Ns} scenarios, Nh={sm.Nh}, "
          f"nx={sm.nx} nu={sm.nu}, {sum(sm.common) * sm.nu} coupling multipliers, Jay "
          f"P={sm.Ns - 1} b={nl}")
    sd_three = ("chain_factor",) + sd_names
    sd_forbid = ms_names + tuple(n for n in generic_names if n != "chain_factor") + admm_name

    def sd_counts():
        return {k.__name__: k.launches for k in kernels if k.__name__ in sd_three}

    def sd_launch_rule(info, o, what, got):
        """Each Newton step factors once; the coarse phase solves once, the
        final phase 1 + its refinement steps times, through both kernels."""
        r = max(o.refine_steps, 1) if o.df64_phase else o.refine_steps
        c, n = info["iter_f32"], info["iter"]
        want = dict(chain_factor=n, chain_full_solve_mat=c + (n - c) * (1 + r))
        want["jay_cr_solve"] = want["chain_full_solve_mat"]
        if got != want:
            fail(f"{what}: launches {got}, expected {want} ({c} coarse + {n - c} final "
                 f"iterations)")
        return got

    def sd_solve(sq, lam0, mu0, o, q_tree, what, certify=True):
        """One sdunes request: (TreeQPOut, info, kkt, ms), its kernel launches
        held to the rule above. Certified unless ``certify`` is False: status
        0, error < 1e-8, port-oracle KKT < 1e-8 through scenario_output;
        finite iterates of the right shape always."""
        n0 = sd_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol, lam, mu, info = sd.sdunes_solve(sq, lam0, mu0, o)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        n1 = sd_counts()
        info["launches"] = sd_launch_rule(info, o, what, {k: n1[k] - n0[k] for k in n1})
        if tuple(sol["x"].shape) != (sm.Ns, sm.Nh + 1, sm.nx) or not all(
                bool(torch.isfinite(v).all()) for v in (sol["x"], sol["u"], lam, mu)):
            fail(f"{what}: iterates of the wrong shape or not finite")
        out, kkt = None, float("nan")
        if certify:
            out = sd.scenario_output(sq, sol, lam, mu, info)
            kkt = max_kkt_residual(q_tree, out)
            if info["status"] != td.TDUNES_OPTIMAL or not info["error"] < TOL \
                    or not kkt < TOL:
                fail(f"{what}: status {info['status']} error {info['error']} kkt {kkt}")
        return out, info, kkt, t_ms

    def sd_instance(fac):
        """sdunes_bench's request: stage 0's state bounds scaled by ``fac``
        in the scenario data, the crown and the tree (the KKT oracle's)."""
        q_k, ms_k = perturbed(qb, msb, fac)
        return sqp.replace(xmin=q_k.xmin[paths_t], xmax=q_k.xmax[paths_t]), q_k, ms_k

    paths_t = torch.as_tensor(sm.paths, device=dev)

    # the kernels against their twins on the operands of the first
    # final-phase iteration of the cold headline solve
    calls, (_, _, _, info_c0) = capture(((ck, sd_three[:2]), (jk, sd_names[1:])),
                                        lambda: sd.sdunes_solve(sqp, None, None, opts_sd))
    c0 = info_c0["iter_f32"]
    if info_c0["iter"] <= c0:
        fail(f"cold sdunes solve ran no final iteration: {info_c0}")
    (Wc, Ut), _ = calls["chain_factor"][c0]
    err_cf = compare(torch, "chain_factor (sdunes)", ck.chain_factor(Wc, Ut),
                     ck.chain_factor_ref(Wc, Ut), FACTOR_RTOL)
    (Ls5, CUs5, r5), _ = calls["chain_full_solve_mat"][c0]
    (_, _, r1), _ = calls["chain_full_solve_mat"][c0 + 1]
    if r5.shape[-1] != 1 + nl or r1.shape[-1] != 1:
        fail(f"chain_full_solve_mat: right-hand sides {r5.shape[-1]} and {r1.shape[-1]}")
    errs_fs = {m: compare(torch, f"chain_full_solve_mat (m={m})",
                          [ck.chain_full_solve_mat(Ls5, CUs5, r)],
                          [ck.chain_full_solve_mat_ref(Ls5, CUs5, r)], SOLVE_RTOL)
               for m, r in ((1 + nl, r5), (1, r1))}
    S_s, L_s, n_s, _ = Ls5.shape
    record("chain_full_solve_mat", "chain_full_solve.cu", "treeqp_tpu/ops/chain_kernels.py:261",
           max(errs_fs.values()), lambda: ck.chain_full_solve_mat(Ls5, CUs5, r5),
           lambda: ck.chain_full_solve_mat_ref(Ls5, CUs5, r5),
           f"Ls {tuple(Ls5.shape)}, m={1 + nl} (the iteration's first solve; after {c0} coarse "
           f"iterations); m=1 {cuda_ms(torch, lambda: ck.chain_full_solve_mat(Ls5, CUs5, r1), 20):.4f}"
           f" ms, |diff| {errs_fs[1]:.3e}; chain_factor there |diff| {err_cf:.3e}",
           (Ls5, CUs5, r5), S_s * (1 + nl) * L_s * 6 * n_s * n_s)
    # the Jay system: held to its twin at the cold start (the first coarse
    # iteration); at the first final-phase iteration it is near singular
    # (clipped couplings; only the 1e-6 shift holds it), where an f32
    # solve's forward error is set by the conditioning and not by the
    # kernel, so there both f32 solves are held to a backward error below
    # JAY_BACKWARD against the system in f64, with their distances to the
    # f64 solve printed
    (dg0, of0, rj0), kw0 = calls["jay_cr_solve"][0]
    err_j = compare(torch, "jay_cr_solve (cold start)", [jk.jay_cr_solve(dg0, of0, rj0, **kw0)],
                    [jk.jay_cr_solve_ref(dg0, of0, rj0, **kw0)], SOLVE_RTOL)
    (dg, of, rj), kw = calls["jay_cr_solve"][c0]

    def jay_dense(dg_, of_, sh_):
        """The shifted block-tridiagonal system as one dense f64 matrix."""
        P_, b_ = dg_.shape[0], dg_.shape[-1]
        M = torch.block_diag(*dg_.double()) + torch.diag(sh_.double().reshape(-1))
        for i in range(P_ - 1):
            M[(i + 1) * b_:(i + 2) * b_, i * b_:(i + 1) * b_] = of_[i].double()
            M[i * b_:(i + 1) * b_, (i + 1) * b_:(i + 2) * b_] = of_[i].double().T
        return M
    M_j, r_j = jay_dense(dg, of, kw["shift"]), rj.double().reshape(-1)
    x_j64 = torch.linalg.solve(M_j, r_j)
    ev_j = torch.linalg.eigvalsh(M_j)
    jay_fe = {}
    for tag, x_ in (("kernel", jk.jay_cr_solve(dg, of, rj, **kw)),
                    ("twin", jk.jay_cr_solve_ref(dg, of, rj, **kw))):
        x_ = x_.double().reshape(-1)
        eta = float((M_j @ x_ - r_j).abs().max()
                    / (M_j.abs().sum(1).max() * x_.abs().max() + r_j.abs().max()))
        jay_fe[tag] = f"{float((x_ - x_j64).abs().max()):.3e} (backward error {eta:.3e})"
        if not torch.isfinite(x_).all() or not eta <= JAY_BACKWARD:
            fail(f"jay_cr_solve ({tag}) at the first final-phase iteration: backward error "
                 f"{eta:.3e} > {JAY_BACKWARD:g}")
    print(f"jay_cr_solve at the first final-phase iteration: condition {float(ev_j[-1] / ev_j[0]):.3e}"
          f" (f64 eigenvalues of the equilibrated, shifted system), max|x| "
          f"{float(x_j64.abs().max()):.3e}; distance to the f64 solve: kernel "
          f"{jay_fe['kernel']}, twin {jay_fe['twin']}")
    # beyond the TPU kernel's caps: a seeded SPD system at P = 1023, b = 16
    # with one exactly singular block (its pivot turns the shift on)
    rng = np.random.default_rng(JAY_SEED)
    P_b, b_b = JAY_BIG
    A_ = rng.normal(size=(P_b, b_b, b_b))
    dg_b = A_ @ A_.transpose(0, 2, 1) + 3.0 * b_b * np.eye(b_b)
    of_b = 0.3 * rng.normal(size=(P_b - 1, b_b, b_b))
    r_b = rng.normal(size=(P_b, b_b))
    mid = P_b // 2
    dg_b[mid, 0, :] = dg_b[mid, :, 0] = of_b[mid, :, 0] = of_b[mid - 1, 0, :] = 0.0
    jb = [torch.tensor(v, dtype=f32, device=dev) for v in (dg_b, of_b, r_b)]
    jb.append(torch.full((P_b, b_b), 1e-2, dtype=f32, device=dev))
    x_b, x_bref = jk.jay_cr_solve(*jb, 1e-6), jk.jay_cr_solve_ref(*jb, 1e-6)
    err_jb = compare(torch, f"jay_cr_solve (P={P_b}, b={b_b})", [x_b], [x_bref], SOLVE_RTOL)
    if not float(x_b[mid].abs().max()) > 0.0:
        fail("jay_cr_solve: the singular block's shift did not act")

    def jay_ops(P, b):
        """Operations of the cyclic reduction: per level each eliminated
        block's factor and 2b + 1 solves, each updated block's three block
        products and two block-vector products; the root; the back
        substitution."""
        ops, h = 0, 1
        while h < P:
            n_odd, n_even = len(range(h, P, 2 * h)), len(range(0, P, 2 * h))
            ops += n_odd * (chol_ops(b) + (2 * b + 1) * 2 * b * b + 4 * b * b)
            ops += n_even * (6 * b ** 3 + 4 * b * b)
            h *= 2
        return ops + chol_ops(b) + 2 * b * b

    record("jay_cr_solve", "jay_cr.cu", "treeqp_tpu/ops/jay_kernel.py:89", max(err_j, err_jb),
           lambda: jk.jay_cr_solve(dg, of, rj, **kw),
           lambda: jk.jay_cr_solve_ref(dg, of, rj, **kw),
           f"P={dg.shape[0]} b={dg.shape[-1]}, shift always, |diff| {err_j:.3e} at the cold "
           f"start; P={P_b} "
           f"b={b_b} on the fly with a singular block: "
           f"{cuda_ms(torch, lambda: jk.jay_cr_solve(*jb, 1e-6), 20):.4f} ms, |diff| "
           f"{err_jb:.3e}, bound {nbytes(torch, jb, x_b) / PEAK_BYTES * 1e3:.6f} ms",
           (dg, of, rj, kw["shift"]), jay_ops(dg.shape[0], dg.shape[-1]))
    for r in results[-2:]:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library call none, "
              f"max |diff| {r['max_abs_err']:.3e} [{r['shapes']}] on {card}")

    def sd_line(what, info, kkt, t_ms, launches, extra=""):
        c = info["iter_f32"]
        print(f"{what}: iter {info['iter']} ({c} coarse + {info['iter'] - c} final), status "
              f"{info['status']}, error {info['error']:.3e}, kkt {kkt:.3e}, launches "
              f"{launches}, {t_ms:.1f} ms{extra} on {card}")

    # the cold headline solve (the card's first sdunes solve ran in the capture)
    def sd_cold():
        _, info, kkt, t_ms = sd_solve(sqp, None, None, opts_sd, qb, "sdunes cold solve")
        sd_line("sdunes cold solve", info, kkt, t_ms, info["launches"],
                f", {t_ms / info['iter']:.2f} ms an iteration")
    drive("sdunes cold", sd_three, sd_cold, forbid=sd_forbid, sd_path=True)

    # sdunes_boot (and _df64): each request bootstraps through
    # tdunes_ms_solve at tol 1e-4, merge_output and the exact scenario duals
    # of the tree solution, then sdunes_solve from them
    def boot_request(mode, k, o):
        sq_k, q_k, ms_k = sd_instance(facs[k])

        def bootstrap():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cro, cho, binfo = tm.tdunes_ms_solve(ms_k, None, None, opts_boot)
            lam0, mu0 = sd.scenario_duals_from_tree(
                sq_k, None, tm.merge_output(ms_k, cro, cho, binfo))
            torch.cuda.synchronize()
            return lam0, mu0, binfo, (time.perf_counter() - t0) * 1e3
        lam0, mu0, binfo, t_b = drive(f"{mode} request {k} bootstrap", ("newton_iter",),
                                      bootstrap)
        if binfo["status"] != td.TDUNES_OPTIMAL or not binfo["error"] < opts_boot.tol:
            fail(f"{mode} request {k}: bootstrap {binfo}")

        def solve():
            _, info, kkt, t_ms = sd_solve(sq_k, lam0, mu0, o, q_k, f"{mode} request {k}")
            sd_line(f"{mode} request {k} (fac {facs[k]:.6f})", info, kkt, t_ms,
                    info["launches"],
                    f"; bootstrap {binfo['iter']} iterations ({binfo['iter_f32']} coarse) "
                    f"{t_b:.1f} ms, request {t_b + t_ms:.1f} ms")
            return info, t_b + t_ms
        return drive(f"{mode} request {k}", (), solve, forbid=sd_forbid, sd_path=True)

    sd_modes = {}
    for mode, o, n in (("sdunes_boot", opts_sd, N_REQUESTS_SD),
                       ("sdunes_boot_df64", opts_sd_df, N_REQUESTS_SD_DF)):
        sd_modes[mode] = [boot_request(mode, k, o) for k in range(n)]

    # sdunes_f32: f32 data, cold, tol 1e-3, no coarse phase (the bench
    # asserts nothing here); beside it tdunes_ms_solve's all-f32 loop
    def f32_requests():
        rows = []
        for k in range(N_REQUESTS_F32):
            sq_k = sd_instance(facs[k])[0].to(dtype=f32)
            _, info, _, t_ms = sd_solve(sq_k, None, None, opts_sd_f32, None,
                                        f"sdunes_f32 request {k}", certify=False)
            sd_line(f"sdunes_f32 request {k}", info, float("nan"), t_ms, info["launches"],
                    f", {t_ms / max(info['iter'], 1):.3f} ms an iteration")
            rows.append((info["iter"], t_ms))
        return rows
    rows_sd32 = drive("sdunes_f32", sd_three, f32_requests, forbid=sd_forbid, sd_path=True)
    ms32b = msb.to(dtype=f32)

    def ms_f32_requests():
        rows = []
        for k in range(N_REQUESTS_F32):
            ms_k = perturbed(qb, ms32b, facs[k])[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cro, _, info = tm.tdunes_ms_solve(ms_k, None, None, opts_ms_f32)
            torch.cuda.synchronize()
            t_ms = (time.perf_counter() - t0) * 1e3
            if not bool(torch.isfinite(cro["lam"]).all()):
                fail(f"tdunes_ms_f32 request {k}: not finite")
            print(f"tdunes_ms_f32 request {k}: iter {info['iter']}, status {info['status']}, "
                  f"error {info['error']:.3e}, {t_ms:.1f} ms, "
                  f"{t_ms / max(info['iter'], 1):.3f} ms an iteration on {card}")
            rows.append((info["iter"], t_ms))
        return rows
    rows_ms32 = drive("tdunes_ms_f32", ("chain_eval", "chain_blocks_factor_lanes", "system_solve"),
                      ms_f32_requests)
    per_it = lambda rows: sum(t for _, t in rows) / max(sum(i for i, _ in rows), 1)
    print(f"f32 loop ms an iteration (sdunes_bench's f32_phase_ms_per_iter): sdunes "
          f"{per_it(rows_sd32):.3f}, tdunes_ms {per_it(rows_ms32):.3f}, ratio "
          f"{per_it(rows_sd32) / per_it(rows_ms32):.2f} on {card}")
    for mode, rows in sd_modes.items():
        print(f"requests {mode}: iters {[i['iter'] for i, _ in rows]}, "
              f"{statistics.mean(t for _, t in rows):.1f} ms a request (bootstrap included) "
              f"on {card}")

    # the card against the CPU plain path: a cold solve at Nr = SD_CPU_NR
    qs_cpu = spring_mass_chain(4, 4, SD_CPU_NR, 20, device="cpu")[0]
    sqs_cpu = sd.scenario_data(qs_cpu)
    sqs = sqs_cpu.to(device=dev)

    def solve_at(sq, q, n=None):
        o = opts_sd if n is None else dataclasses.replace(opts_sd, max_iter=n)
        sol, lam, mu, info = sd.sdunes_solve(sq, None, None, o)
        return sd.scenario_output(sq, sol, lam, mu, info), info
    out_sg, info_sg = solve_at(sqs, qs_cpu)
    t0 = time.perf_counter()
    out_sc, info_sc = solve_at(sqs_cpu, qs_cpu)
    t_cpu = time.perf_counter() - t0
    gaps = gap(out_sg, out_sc)
    print(f"sdunes cold solve at Nr={SD_CPU_NR} ({sqs.meta.Ns} scenarios), card vs CPU plain "
          f"path ({t_cpu:.1f} s on the CPU): iter {info_sg['iter']} vs {info_sc['iter']} "
          f"(coarse {info_sg['iter_f32']} vs {info_sc['iter_f32']}), "
          + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    n_eq = min(info_sg["iter"], info_sc["iter"])
    if info_sg["iter"] != info_sc["iter"]:
        card_n = out_sg if info_sg["iter"] == n_eq else solve_at(sqs, qs_cpu, n_eq)[0]
        cpu_n = out_sc if info_sc["iter"] == n_eq else solve_at(sqs_cpu, qs_cpu, n_eq)[0]
        gaps = gap(card_n, cpu_n)
        print(f"sdunes at Nr={SD_CPU_NR}, card vs CPU plain path, both stopped at {n_eq} "
              f"iterations: " + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    if abs(info_sg["iter"] - info_sc["iter"]) > 1 or gaps["x"] > 1e-7 or gaps["u"] > 1e-7:
        fail(f"sdunes at Nr={SD_CPU_NR}: card and CPU solves disagree at {n_eq} iterations: "
             f"{gaps}")

    t_slice8 = time.perf_counter()

    # ---- 9. the cyclic-reduction chain sweeps (slice 8). No solver calls
    # them: their path is the accept/reject loop of
    # scripts/prof_torch_chain_cr.py, at its three shapes: the JAX script's
    # factors (S=256, L=16, n=8, seed 0), the pruned tree's chain factors of
    # section 5 and sdunes' of section 8 (S=256, L=20, n=8), each with a
    # seeded right-hand side
    rng = np.random.default_rng(0)
    A_r = rng.standard_normal((256, 16, 8, 8))
    Wc_r = torch.tensor(A_r @ A_r.transpose(0, 1, 3, 2) + 3.0 * np.eye(8), dtype=f32, device=dev)
    Ut_r = torch.tensor(0.3 * rng.standard_normal((256, 16, 8, 8)), dtype=f32, device=dev)
    # and a long chain of the widest blocks the kernels take, whose sweep
    # buffers exceed a block's shared memory (the global-scratch path)
    A_l = rng.standard_normal((4, 130, 16, 16))
    Wc_l = torch.tensor(A_l @ A_l.transpose(0, 1, 3, 2) + 3.0 * np.eye(16), dtype=f32, device=dev)
    Ut_l = torch.tensor(0.3 * rng.standard_normal((4, 130, 16, 16)), dtype=f32, device=dev)
    rng = np.random.default_rng(CR_SEED)
    cr_in = {}
    for tag, (Ls_, CUs_) in (("random", ck.chain_factor_ref(Wc_r, Ut_r)[:2]),
                             ("pruned", (Ls_g, CUs_g)), ("sdunes", (Ls5, CUs5)),
                             ("long", ck.chain_factor_ref(Wc_l, Ut_l)[:2])):
        S_, L_, n_ = Ls_.shape[:3]
        cr_in[tag] = (Ls_, CUs_,
                      torch.tensor(rng.standard_normal((S_, L_, n_)), dtype=f32, device=dev),
                      torch.tensor(rng.standard_normal((S_, n_)), dtype=f32, device=dev))

    def cr_ops(L, n, part):
        """Operations of one chain: the precompute's 2 n triangular solves
        a node, or a sweep's L triangular solves, the doubling levels (a
        pair with its partner inside the chain: a matvec, and a product of
        blocks below the last level) and the root term."""
        if part == "pre":
            return L * n * 2 * n * n
        ops, h = L * n * n + 2 * n * n, 1
        while h < L:
            ops += (L - h) * n * (2 * n + (2 * n * n if 2 * h < L else 0))
            h *= 2
        return ops

    cr_rows = {}
    for tag, (Ls_, CUs_, res_, dr_) in cr_in.items():
        S_, L_, n_ = Ls_.shape[:3]
        Ab_ref, Bf_ref = ccr.chain_cr_precompute_ref(Ls_, CUs_)
        ys_ref, radd_ref = ccr.chain_solve_bwd_cr_ref(Ls_, CUs_, Ab_ref, res_)
        d_ref = ccr.chain_forward_cr_ref(Ls_, CUs_, Bf_ref, ys_ref, dr_)
        cr_rows[tag] = dict(
            pre=compare(torch, f"chain_cr_precompute ({tag})",
                        ccr.chain_cr_precompute(Ls_, CUs_), (Ab_ref, Bf_ref), FACTOR_RTOL),
            bwd=compare(torch, f"chain_solve_bwd_cr ({tag})",
                        ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab_ref, res_), (ys_ref, radd_ref),
                        SOLVE_RTOL),
            fwd=compare(torch, f"chain_forward_cr ({tag})",
                        [ccr.chain_forward_cr(Ls_, CUs_, Bf_ref, ys_ref, dr_)], [d_ref],
                        SOLVE_RTOL))
        # the CR pair of kernels against the serial pair on the same factors
        ys_s, radd_s = ck.chain_solve_bwd(Ls_, CUs_, res_)
        Ab, Bf = ccr.chain_cr_precompute(Ls_, CUs_)
        ys_c, radd_c = ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab, res_)
        got = [ys_c, radd_c, ccr.chain_forward_cr(Ls_, CUs_, Bf, ys_c, dr_)]
        ref = [ys_s, radd_s, ck.chain_forward(Ls_, CUs_, ys_s, dr_)]
        torch.cuda.synchronize()
        cr_rows[tag]["pair"] = compare(torch, f"CR pair vs serial kernels ({tag})", got, ref,
                                       CR_PAIR_RTOL)
        cr_rows[tag]["ms"] = {
            "pre": cuda_ms(torch, lambda: ccr.chain_cr_precompute(Ls_, CUs_), 20),
            "bwd": cuda_ms(torch, lambda: ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab, res_), 20),
            "fwd": cuda_ms(torch, lambda: ccr.chain_forward_cr(Ls_, CUs_, Bf, ys_c, dr_), 20),
            "serial": cuda_ms(torch, lambda: ck.chain_solve_bwd(Ls_, CUs_, res_), 20)
            + cuda_ms(torch, lambda: ck.chain_forward(Ls_, CUs_, ys_s, dr_), 20)}
        c = cr_rows[tag]
        print(f"CR sweeps ({tag}: S={S_} L={L_} n={n_}): precompute {c['ms']['pre']:.4f} ms, "
              f"bwd {c['ms']['bwd']:.4f}, fwd {c['ms']['fwd']:.4f} (serial pair "
              f"{c['ms']['serial']:.4f}); |diff| to the twins {c['pre']:.3e} / {c['bwd']:.3e} / "
              f"{c['fwd']:.3e}, CR pair vs serial kernels {c['pair']:.3e} (max |dl| "
              f"{float(ref[2].abs().max()):.3e}) on {card}")

    # the JSON rows at the pruned tree's shape (rows 2 and 3's), the other
    # shapes in their descriptions
    Ls_, CUs_, res_, dr_ = cr_in["pruned"]
    S_, L_, n_ = Ls_.shape[:3]
    Ab, Bf = ccr.chain_cr_precompute_ref(Ls_, CUs_)
    ys_p = ccr.chain_solve_bwd_cr_ref(Ls_, CUs_, Ab, res_)[0]
    lib_bwd, lib_fwd, lib_err = sweep_library(Ls_, CUs_, res_, ys_p, dr_)
    others = lambda part: "; ".join(
        f"{tag} {cr_rows[tag]['ms'][part]:.4f} ms (|diff| {cr_rows[tag][part]:.3e}, CR pair vs "
        f"serial {cr_rows[tag]['pair']:.3e})" for tag in ("random", "sdunes", "long"))
    record("chain_cr_precompute", "chain_cr.cu", "treeqp_tpu/ops/chain_cr.py:68",
           max(r["pre"] for r in cr_rows.values()), lambda: ccr.chain_cr_precompute(Ls_, CUs_),
           lambda: ccr.chain_cr_precompute_ref(Ls_, CUs_),
           f"Ls {tuple(Ls_.shape)}; {others('pre')}", (Ls_, CUs_), S_ * cr_ops(L_, n_, "pre"))
    record("chain_solve_bwd_cr", "chain_cr.cu", "treeqp_tpu/ops/chain_cr.py:132",
           max(r["bwd"] for r in cr_rows.values()),
           lambda: ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab, res_),
           lambda: ccr.chain_solve_bwd_cr_ref(Ls_, CUs_, Ab, res_),
           f"res {tuple(res_.shape)}; {others('bwd')}; the library call |diff| {lib_err:.3e}",
           (Ls_, Ab, res_, CUs_[:, 0]), S_ * cr_ops(L_, n_, "sweep"), lib_fn=lib_bwd)
    record("chain_forward_cr", "chain_cr.cu", "treeqp_tpu/ops/chain_cr.py:168",
           max(r["fwd"] for r in cr_rows.values()),
           lambda: ccr.chain_forward_cr(Ls_, CUs_, Bf, ys_p, dr_),
           lambda: ccr.chain_forward_cr_ref(Ls_, CUs_, Bf, ys_p, dr_),
           f"ys {tuple(ys_p.shape)}; {others('fwd')}", (Ls_, Bf, ys_p, dr_),
           S_ * cr_ops(L_, n_, "sweep"), lib_fn=lib_fwd)
    for r in results[-3:]:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library call "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
              f"max |diff| {r['max_abs_err']:.3e} [{r['shapes']}] on {card}")

    def cr_loop():
        """scripts/prof_torch_chain_cr.py's loop, CR_LOOP pairs a shape: the
        CR operands once, then backward + forward pairs with the
        right-hand side varied each step, CR and serial."""
        for Ls_, CUs_, res_, dr_ in cr_in.values():
            Ab, Bf = ccr.chain_cr_precompute(Ls_, CUs_)
            for k in range(CR_LOOP):
                r = res_ * (1.0 + 2e-4 * k)
                ys, radd = ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab, r)
                d_c = ccr.chain_forward_cr(Ls_, CUs_, Bf, ys, dr_ + radd)
                ys, radd = ck.chain_solve_bwd(Ls_, CUs_, r)
                d_s = ck.chain_forward(Ls_, CUs_, ys, dr_ + radd)
                compare(torch, "CR pair vs serial kernels (loop)", [d_c], [d_s], CR_PAIR_RTOL)
    drive("CR sweeps", cr_names + ("chain_solve_bwd", "chain_forward"), cr_loop,
          forbid=ms_names + admm_name + ("chain_factor", "crown_factor", "crown_solve"),
          cr_path=True)

    # ---- 10. the MPC re-embedding path (slice 8): the pruned headline tree
    # of section 5 with its root state folded in once (set_x0, then
    # eliminate_x0 keeping the originals), one cold solve and the closed
    # loop's steps, each re-embedding the plant's next state through
    # EliminatedTreeQP.set_x0
    x0_g = qg.xmin[0].cpu().numpy()
    root_x = torch.zeros_like(qg.xmin, dtype=torch.bool)
    root_x[0] = True

    def same_data(a, b):
        """Every field equal, the root's state bounds aside (the nx[0] = 0
        topology leaves them out; re-embedding keeps the first x0's)."""
        bad = [f for f in QP_FIELDS if not torch.equal(
            *(getattr(q, f).masked_fill(root_x, 0.0) if f in ("xmin", "xmax")
              else getattr(q, f) for q in (a, b)))]
        return a.topo == b.topo and not bad, bad

    def mpc_request(el, x, lam0, what):
        """One request: (re-embedding and) solve of the eliminated problem,
        certified and held to the un-eliminated solve and to elimination
        from scratch. Returns (the eliminated QP, out, ms, launches)."""
        n0 = {k.__name__: k.launches for k in generic_kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if lam0 is not None:
            el = el.set_x0(x)
        out = td.tdunes_solve(el.qp, lam0, optsg)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        launches = {k.__name__: k.launches - n0[k.__name__] for k in generic_kernels}
        ok, bad = same_data(el.qp, qg.set_x0(x).eliminate_x0())
        if not ok:
            fail(f"{what}: the re-embedded data differ from elimination from scratch in {bad}")
        kkt = max_kkt_residual(el.qp, out)
        if out.info["status"] != td.TDUNES_OPTIMAL:
            print(f"{what}: stalled, status {out.info['status']} after "
                  f"{out.info['iter']} iterations, kkt {kkt:.3e}, state {x}")
            return el, out, t_ms, launches
        if not kkt < TOL:
            fail(f"{what}: status 0 but kkt {kkt}")
        full = td.tdunes_solve(qg.set_x0(x), None, optsg)
        gaps = {"x[1:]": float((out.x[1:] - full.x[1:]).abs().max()),
                "u": float((out.u - full.u).abs().max())}
        if max(gaps.values()) > MPC_GAP:
            fail(f"{what}: the eliminated and the full solve differ: {gaps}")
        print(f"{what}: iter {out.info['iter']} ({out.info['iter_f32']} coarse), kkt "
              f"{kkt:.3e}, {t_ms:.1f} ms, launches {launches}; the solve without "
              f"elimination: iter {full.info['iter']}, "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()) + f" on {card}")
        return el, out, t_ms, launches

    def mpc_path():
        el = qg.set_x0(x0_g).eliminate_x0(keep_originals=True)
        if el.qp.topo.nx[0] != 0 or len(el.kids0) != len(qg.topo.kids[0]):
            fail(f"eliminate_x0: root nx {el.qp.topo.nx[0]}, {len(el.kids0)} kids kept")
        x, lam, rows, nu0 = x0_g, None, [], qg.topo.nu[0]
        for k in range(N_REQUESTS_MPC + 1):
            what = "MPC cold request" if lam is None else f"MPC warm request {k - 1}"
            el, out, t_ms, _ = mpc_request(el, x, lam, what)
            rows.append((out.info["iter"], t_ms, out.info["status"], x))
            # closed_loop_mpc: the first control to the plant, the duals kept
            x, lam = quad.simulate(x, out.u[0, :nu0].cpu().numpy()), out.lam
        return rows
    rows_mpc = drive("MPC re-embedding", generic_names, mpc_path, forbid=ms_names + admm_name)
    stalled = sum(st != td.TDUNES_OPTIMAL for _, _, st, _ in rows_mpc)
    print(f"MPC re-embedding on quadcopter({MD},{NR},{NH}) pruned to {GEN_SCEN} scenarios, "
          f"the closed loop's states {[np.round(x, 4).tolist() for *_, x in rows_mpc]}: "
          f"iterations {[r[0] for r in rows_mpc]}, ms a request "
          f"{[round(r[1], 2) for r in rows_mpc]} (re-embedding and solve), "
          f"{stalled} of {len(rows_mpc)} stalled, on {card}")
    if stalled:
        fail(f"{stalled} MPC requests stalled")
    # the LTV setters rebuild the instance from flat arrays, bit for bit
    nxg, nug = qg.topo.nx, qg.topo.nu
    host = {f: getattr(qg, f).cpu().numpy() for f in QP_FIELDS}
    par = qg.topo.parent
    col = lambda M: M.T.ravel()  # column-major
    cat = lambda parts: np.concatenate([np.ravel(p) for p in parts])
    rebuilt = qg.set_ltv_dynamics(
        cat(col(host["A"][c, :nxg[c], :nxg[par[c]]]) for c in range(1, qg.topo.Nn)),
        cat(col(host["B"][c, :nxg[c], :nug[par[c]]]) for c in range(1, qg.topo.Nn)),
        cat(host["b"][c, :nxg[c]] for c in range(1, qg.topo.Nn)))
    nodes = range(qg.topo.Nn)
    rebuilt = rebuilt.set_ltv_objective_diag(
        cat(np.diag(host["Q"][i])[:nxg[i]] for i in nodes),
        cat(np.diag(host["R"][i])[:nug[i]] for i in nodes),
        cat(host["q"][i, :nxg[i]] for i in nodes), cat(host["r"][i, :nug[i]] for i in nodes))
    rebuilt = rebuilt.set_ltv_bounds(*(
        cat(host[f][i, :(nxg if f[0] == "x" else nug)[i]] for i in nodes)
        for f in ("xmin", "xmax", "umin", "umax")))
    bad = [f for f in QP_FIELDS if not torch.equal(getattr(rebuilt, f), getattr(qg, f))]
    if bad:
        fail(f"the LTV setters did not rebuild {bad}")
    print(f"LTV setters: A, B, b, Q, R, q, r and the bounds of the {qg.topo.Nn}-node tree "
          f"rebuilt from flat arrays, every field equal")
    print(f"sections 9-10 (slice 8): {time.perf_counter() - t_slice8:.1f} s on {card}")

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
          f"(build {t_build:.1f} s) on {card}")
    for r in results:
        r["launches"] = sum(p[r["name"]] for p in paths.values())
        del r["shapes"]
        if r["launches"] <= 0:
            fail(f"{r['name']} was not launched by any main path")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the port's cold sdunes solve parts from JAX's: JAX's iterates
replayed through the port, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/replay_torch_sdunes_depth.py [--nr 3 | --tree NM MD NR NH]
        [--perturb N] [--jax-kernels] [--max-iter K]

Solves the box-only ``spring_mass_chain(4, 4, Nr, 20)`` (or ``--tree``'s)
cold at sdunes_bench's options (``models.SDUNES_OPTS``) with the JAX
package's ``chain_backend="pallas"`` (the Pallas kernels in interpret
mode), running the outer ``while_loop`` of each phase's ``_sd_newton_loop``
as a Python loop over its jitted body so that every carry (lam, mu, it,
err, status, ls_it, best, noimp, boost) is kept. Then, for every k, the
port's loop body (``solvers.sdunes._sd_iteration``, the plain twins) runs
once from JAX's carry k and is held against JAX's carry k+1: the
decisions (the stall bookkeeping noimp and boost, the shift, the status,
the line-search count, whether the gradient fallback ran, the Jay
diagonals below 1e-12 at each Jay solve) and the distance of the new
(lam, mu); the clipped count at carry k is printed beside them.

``--perturb N``: each package's step from carry k is also taken N times
with its f32 banded blocks D times (1 + e), e a symmetric 1/2-ulp noise:
the line-search counts and the spread of the steps that rounding reaches
from the same state. ``--jax-kernels``: the port's step is also taken with
JAX's three Pallas kernels (chain_factor, chain_full_solve_mat,
jay_cr_solve) in place of its twins.

Prints one row a k, the first k where the port decides otherwise than
JAX's solve, and with ``--perturb`` the ks where neither package's
perturbed steps reach the other's line-search count and the ks where the
port's step lies outside both spreads.
``tests/test_torch_sdunes_depth_replay.py`` replays the first three coarse
iterations at Nr = 3.
"""

import argparse
import contextlib
import os
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks import models as jmodels  # noqa: E402
from treeqp_tpu.solvers import sdunes as jsd  # noqa: E402
from treeqp_tpu_torch import convert, models  # noqa: E402
from treeqp_tpu_torch.solvers import sdunes as sd  # noqa: E402

CARRY = ("lam", "mu", "it", "err", "status", "ls_it", "best", "noimp", "boost")
_ORIG_WHILE = jax.lax.while_loop


def instance(nm, md, nr, nh):
    """JAX's and the port's scenario data of spring_mass_chain(nm, md, nr, nh)."""
    qp_j = jmodels.spring_mass_chain(nm=nm, md=md, Nr=nr, Nh=nh)[0]
    qp = convert.qp_from_numpy(convert.qp_arrays(qp_j), convert.topo_from(qp_j.topo),
                               device="cpu")
    return jsd.scenario_data(qp_j), sd.scenario_data(qp)


class Recorder:
    """Runs JAX's cold sdunes_solve with each phase's outer loop as a
    Python loop over its jitted body. ``phases`` holds, per phase, the
    list of carries (numpy) and the jitted body; ``noise`` (None or a
    numpy array of D's shape) multiplies the f32 banded blocks by (1 +
    noise) inside the body, read at run time through a host callback so
    that the body compiles once."""

    def __init__(self):
        self.phases = []
        self.noise = None

    def while_loop(self, cond, body, init):
        if not body.__qualname__.endswith("_sd_newton_loop.<locals>.body"):
            return _ORIG_WHILE(cond, body, init)
        jc, jb = jax.jit(cond), jax.jit(body)
        carry, carries = init, [tuple(np.asarray(v) for v in init)]
        while bool(jc(carry)):
            carry = jb(carry)
            carries.append(tuple(np.asarray(v) for v in carry))
        self.phases.append(dict(carries=carries, body=jb))
        return carry

    def sd_factor(self, D, Ssub, topts, extra_shift=None):
        def noise():
            return (np.zeros(D.shape, np.float32) if self.noise is None
                    else self.noise.astype(np.float32))
        n = jax.pure_callback(noise, jax.ShapeDtypeStruct(D.shape, jnp.float32))
        return _REAL_FACTOR(D * (1 + n).astype(D.dtype), Ssub, topts,
                            extra_shift=extra_shift)


_REAL_FACTOR = jsd._sd_factor


def record(sqp_j, max_iter=None):
    """JAX's cold solve at SDUNES_OPTS (``max_iter`` counts both phases),
    recorded; returns (Recorder, info)."""
    rec = Recorder()
    o = jsd.SdunesOpts(**{**models.SDUNES_OPTS,
                          **({} if max_iter is None else {"max_iter": max_iter})})
    with mock.patch.object(jax.lax, "while_loop", rec.while_loop), \
            mock.patch.object(jsd, "_sd_factor", rec.sd_factor):
        _, _, _, info = jsd.sdunes_solve.__wrapped__(sqp_j, None, None, o)
    return rec, {k: float(v) for k, v in info.items()}


def phase_of(carries):
    """(dtype, the port's options) of a recorded phase: the coarse f32 phase
    runs without refinement to f32_phase_tol, as sdunes_solve sets it."""
    opts = models.SDUNES_OPTS
    if carries[0][0].dtype == np.float32:
        return torch.float32, sd.SdunesOpts(**{**opts, "refine_steps": 0,
                                               "tol": max(opts["f32_phase_tol"], opts["tol"])})
    return torch.float64, sd.SdunesOpts(**opts)


class JaxKernels:
    """The JAX package's three Pallas kernels of the sdunes step (interpret
    mode, jitted), with the port's wrappers' signatures: ``chain_factor``
    returns the kernel layout [L, n, n, S_pad] that ``chain_full_solve_mat``
    takes, which the port's step only hands on."""

    def __init__(self):
        from treeqp_tpu.ops import chain_kernels as jck
        from treeqp_tpu.ops import jay_kernel as jjk
        self.factor = jax.jit(jck.chain_factor)
        self.solve = jax.jit(jck.chain_full_solve_mat)
        self.jay = jax.jit(jjk.jay_cr_solve, static_argnames=("reg_tol",))

    def chain_factor(self, Wc, Utc):
        Lt, CUt, schur0 = self.factor(jnp.asarray(Wc.numpy()), jnp.asarray(Utc.numpy()))
        return Lt, CUt, torch.from_numpy(np.array(schur0))

    def chain_full_solve_mat(self, Lt, CUt, rhs):
        return torch.from_numpy(np.array(self.solve(Lt, CUt, jnp.asarray(rhs.numpy()))))

    def jay_cr_solve(self, diag, off, rhs, shift=None, reg_tol=-1.0):
        sh = None if shift is None else jnp.asarray(shift.numpy())
        return torch.from_numpy(np.array(self.jay(
            jnp.asarray(diag.numpy()), jnp.asarray(off.numpy()), jnp.asarray(rhs.numpy()),
            sh, reg_tol=float(reg_tol))))


def port_step(sqp, opts, carry, noise=None, kernels=None):
    """The port's loop body (``_sd_iteration``) from a JAX carry, with the
    f32 banded blocks D times (1 + noise) if ``noise`` is given, and with
    ``kernels`` (a JaxKernels) in place of the port's three twins. Returns
    the next carry's lam, mu, err, status, ls_it, noimp, boost and what it
    decided: the gradient fallback taken, the Armijo count of the Newton
    step, the Jay diagonals below 1e-12 at each Jay solve."""
    dt = sqp.b.dtype
    c = dict(zip(CARRY, carry))
    T = lambda a: torch.from_numpy(np.array(a)).to(dt)
    seen = dict(armijo=[], floored=[])
    real_armijo, real_jay, real_blocks = sd._armijo, sd._jay_solve, sd._banded_blocks

    def armijo(*a, **k):
        out = real_armijo(*a, **k)
        seen["armijo"].append(out)
        return out

    def jay(diag, off, rhs, o, extra_shift=None):
        d = torch.diagonal(diag, dim1=1, dim2=2)
        if extra_shift is not None:
            d = d + extra_shift.to(d.dtype)
        seen["floored"].append(int((d < 1e-12).sum()))
        return real_jay(diag, off, rhs, o, extra_shift=extra_shift)

    def blocks(*a):
        D, Ssub = real_blocks(*a)
        if noise is not None:
            D = D * (1 + torch.from_numpy(noise).to(D.dtype))
        return D, Ssub

    swaps = [] if kernels is None else [
        mock.patch.object(sd.ck, "chain_factor", kernels.chain_factor),
        mock.patch.object(sd.ck, "chain_full_solve_mat", kernels.chain_full_solve_mat),
        mock.patch.object(sd.jk, "jay_cr_solve", kernels.jay_cr_solve)]
    with mock.patch.object(sd, "_armijo", armijo), mock.patch.object(sd, "_jay_solve", jay), \
            mock.patch.object(sd, "_banded_blocks", blocks), contextlib.ExitStack() as stack:
        for sw in swaps:
            stack.enter_context(sw)
        lam, mu, err, status, ls_it, _, noimp, boost, shift, _ = sd._sd_iteration(
            sqp, opts, sd._sd_consts(sqp, opts), T(c["lam"]), T(c["mu"]), int(c["status"]),
            int(c["ls_it"]), T(c["best"]), int(c["noimp"]), T(c["boost"]))
    return dict(lam=lam.double().numpy(), mu=mu.double().numpy(), err=float(err),
                status=status, ls_it=ls_it, noimp=noimp, boost=float(boost),
                shift=float(shift), fallback=len(seen["armijo"]) > 1,
                newton_ls=seen["armijo"][0][1] if seen["armijo"] else 0,
                floored=tuple(seen["floored"]))


def active_count(sqp, carry):
    """(clipped x, clipped u) at a carry's point, in the port."""
    c = dict(zip(CARRY, carry))
    T = lambda a: torch.from_numpy(np.array(a)).to(sqp.b.dtype)
    cmask = sd._coupling_masks(sqp.meta, sqp.b.dtype, sqp.b.device)
    sol = sd._stage_solve(sqp, T(c["mu"]), T(c["lam"]), cmask)
    return int((sol["qt"] == 0).sum()), int((sol["rt"] == 0).sum())


def dist(p, q):
    """Largest |difference| of (lam, mu) between two carries or steps."""
    return max(float(np.abs(np.asarray(p[f], np.float64) - np.asarray(q[f], np.float64)).max())
               for f in ("lam", "mu"))


def noise_like(rng, meta):
    """A symmetric relative perturbation of D of +-1/2 ulp of f32 per entry."""
    e = (rng.random((meta.Ns, meta.Nh, meta.nx, meta.nx)) - 0.5) * 2.0 ** -23
    return 0.5 * (e + e.transpose(0, 1, 3, 2))


def replay_step(rec, phase, k, sqp, perturb=0, rng=None, kernels=None, perturb_port=None):
    """Iteration k of a recorded phase replayed: the port from JAX's carry
    k against JAX's carry k+1, and with ``perturb`` > 0 both packages'
    steps from carry k with D perturbed (``perturb_port`` times for the
    port's, ``perturb`` when None); with ``kernels`` (a JaxKernels) the
    port's step with JAX's kernels too. Returns one row (a dict)."""
    cs = phase["carries"]
    dt, opts = phase_of(cs)
    sq = sqp.to(dtype=dt)
    j0, j1 = dict(zip(CARRY, cs[k])), dict(zip(CARRY, cs[k + 1]))
    p = port_step(sq, opts, cs[k])
    ls_j, ls_p, spread_j, spread_p = {int(j1["ls_it"])}, {p["ls_it"]}, 0.0, 0.0
    jcarry = tuple(jnp.asarray(v) for v in cs[k])
    for _ in range(perturb):
        rec.noise = noise_like(rng, sqp.meta)
        pc = dict(zip(CARRY, (np.asarray(v) for v in phase["body"](jcarry))))
        ls_j.add(int(pc["ls_it"]))
        spread_j = max(spread_j, dist(pc, j1))
    rec.noise = None
    for _ in range(perturb if perturb_port is None else perturb_port):
        pp = port_step(sq, opts, cs[k], noise_like(rng, sqp.meta))
        ls_p.add(pp["ls_it"])
        spread_p = max(spread_p, dist(pp, p))
    swapped = None
    if kernels is not None:
        pk = port_step(sq, opts, cs[k], kernels=kernels)
        swapped = dict(dist=dist(pk, j1), ls=pk["ls_it"], err=pk["err"],
                       same=(pk["noimp"], pk["ls_it"], pk["status"], pk["boost"]) == (
                           int(j1["noimp"]), int(j1["ls_it"]), int(j1["status"]),
                           float(np.float64(j1["boost"]))))
    same = (p["noimp"] == int(j1["noimp"]) and p["ls_it"] == int(j1["ls_it"])
            and p["status"] == int(j1["status"])
            and p["boost"] == float(np.float64(j1["boost"]))
            and abs(p["err"] - float(j1["err"])) <= 1e-6 * max(1.0, float(j1["err"])))
    return dict(phase="coarse" if dt == torch.float32 else "final", k=int(j0["it"]),
                err=(float(j1["err"]), p["err"]), noimp=(int(j1["noimp"]), p["noimp"]),
                boost=(float(j1["boost"]), p["boost"]), shift=p["shift"],
                ls=(int(j1["ls_it"]), p["ls_it"]), fallback=p["fallback"],
                floored=p["floored"], active=active_count(sq, cs[k]),
                step=dist(j1, j0), dist=dist(p, j1), same=same,
                ls_jax=tuple(sorted(ls_j)), ls_port=tuple(sorted(ls_p)),
                spread=(spread_j, spread_p) if perturb or perturb_port else None,
                swapped=swapped)


def fmt(r):
    sp = ("" if r["spread"] is None else
          f" spread {r['spread'][0]:.2e}/{r['spread'][1]:.2e} ls perturbed "
          f"{r['ls_jax']}/{r['ls_port']}")
    if r["swapped"] is not None:
        w = r["swapped"]
        sp += (f" | with JAX's kernels: ls {w['ls']} |port-jax| {w['dist']:.2e} "
               f"{'same' if w['same'] else 'DIFFERS'}")
    return (f"{r['phase']:6s} k={r['k']:3d} err {r['err'][0]:.6e}/{r['err'][1]:.6e} noimp "
            f"{r['noimp'][0]}/{r['noimp'][1]} boost {r['boost'][0]:.1e}/{r['boost'][1]:.1e} "
            f"ls {r['ls'][0]}/{r['ls'][1]} fallback {int(r['fallback'])} floored "
            f"{r['floored']} clipped {r['active']} |step| {r['step']:.2e} |port-jax| "
            f"{r['dist']:.2e}{sp} {'same' if r['same'] else 'DIFFERS'}")


def replay(tree, perturb=0, seed=0, max_iter=None, jax_kernels=False, out=print):
    """Replay JAX's cold solve of spring_mass_chain(*tree) (nm, md, Nr, Nh)
    through the port; prints a row a k and returns (Recorder, info, rows)."""
    sqp_j, sqp = instance(*tree)
    out(f"spring_mass_chain{tuple(tree)}: {sqp.meta.Ns} scenarios")
    t0 = time.perf_counter()
    rec, info = record(sqp_j, max_iter)
    out(f"JAX (Pallas, interpret), the outer loops as Python loops: iter "
        f"{int(info['iter'])}, status {int(info['status'])}, error {info['error']:.3e}, "
        f"{time.perf_counter() - t0:.0f} s")
    rng = np.random.default_rng(seed)
    kernels = JaxKernels() if jax_kernels else None
    rows = []
    for phase in rec.phases:
        for k in range(len(phase["carries"]) - 1):
            rows.append(replay_step(rec, phase, k, sqp, perturb, rng, kernels))
            out(fmt(rows[-1]))
    first = next((r for r in rows if not r["same"]), None)
    out("first k where the port decides otherwise than JAX's solve: "
        + ("none" if first is None else f"{first['phase']} k={first['k']}"))
    if perturb:
        apart = [r for r in rows if not set(r["ls_jax"]) & set(r["ls_port"])]
        out("ks where no perturbed step of either package takes the other's "
            "line-search count: " + (", ".join(f"{r['phase']} k={r['k']}" for r in apart)
                                     or "none"))
        out_ = [r for r in rows if r["dist"] > r["spread"][0] + r["spread"][1] + 1e-12]
        out("ks where the port's step lies outside both packages' perturbed spreads: "
            + (", ".join(f"{r['phase']} k={r['k']}" for r in out_) or "none"))
    return rec, info, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nr", type=int, default=3)
    ap.add_argument("--tree", type=int, nargs=4, default=None, metavar=("NM", "MD", "NR", "NH"),
                    help="spring_mass_chain(NM, MD, NR, NH) instead of (4, 4, --nr, 20)")
    ap.add_argument("--perturb", type=int, default=0,
                    help="steps a k of each package with 1-ulp perturbed blocks (0: none)")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--jax-kernels", action="store_true",
                    help="also step the port with JAX's three Pallas kernels in place of "
                         "its twins")
    a = ap.parse_args()
    torch.set_num_threads(1)
    replay(a.tree or (4, 4, a.nr, 20), a.perturb, max_iter=a.max_iter, jax_kernels=a.jax_kernels,
           out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()

"""Benchmark problem generators (port of ``benchmarks/models.py``), and the
generic-tree solver's instances and options of ``benchmarks/generic_bench.py``,
``benchmarks/fault_tolerance.py`` and ``benchmarks/general_cd_bench.py``.

Every family is ported. ``spring_mass_qp`` loads the reference's own
instance (examples/spring_mass_utils/data.c and x0.txt; md=3, Nr=2, Nh=10,
NX=4, NU=1). The quadcopter: attitude model with uncertain mass (8-12 kg),
Ts=0.05 (benchmark/quadcopter/dynamics_quadcopter_mpc.m + default params),
linearized around hover with ``torch.autograd`` (in place of jax.jacobian
/ CasADi, common/linearize_model.m) and exactly discretized with the
augmented matrix exponential (common/discretize_model.m). The overhead
crane, uncertain friction b in [0.1, 0.3], Ts=0.2
(benchmark/crane/dynamics_crane.m), and the linear chain, nm masses on
springs with nu actuated, uncertain spring constant k in [4, 8]
(benchmark/linear_chain/initialize_linear_chain.m), linearized and
discretized the same way. The spring-mass chain (numpy RK4), with the
general constraint rows of the general C/D trees; the IPM's and sdunes'
options of their benches. Model construction is host-side work: it runs
in f64 on the CPU, and the returned QP is moved to the requested device at
the end. The quadcopter, the crane and the linear chain come with their
nonlinear plant simulators (RK4 at the true parameter drawn from the
seed).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TreeQPIn
from treeqp_tpu_torch.utils.ref_data import parse_c_arrays, read_txt_vector
from treeqp_tpu_torch.utils.tree import TreeStructure

# the reference's spring_mass example data (data.c, x0.txt), looked for in
# a checkout of the reference at reference/ beside the package
SPRING_MASS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "reference", "examples", "spring_mass_utils")

__all__ = ["BenchmarkModel", "SPRING_MASS_DIR", "spring_mass_qp", "quadcopter", "crane",
           "linear_chain", "linearize", "discretize", "GENERIC_SPEED_OPTS",
           "asym_tree", "pruned", "spring_mass_dynamics", "spring_mass_chain",
           "with_general_rows", "with_sparse_rows", "general_cd", "GENERAL_CD_OPTS",
           "GENERAL_CD_CPU_OPTS",
           "IPM_OPTS", "SDUNES_OPTS", "SDUNES_BOOT_OPTS"]

# the generic-tree solver's options, generic_bench.speed_opts(on_tpu=True),
# as TdunesOpts fields
GENERIC_SPEED_OPTS = dict(stage_solver="clipping", tol=1e-8, max_iter=120,
                          factor_dtype="float32", refine_steps=1,
                          refine_safeguard=False, chain_backend="pallas",
                          reg_type="always", reg_value=1e-6, f32_phase_tol=1e-4,
                          f32_patience=3, df64_phase=False)

# general_cd_bench's tdunes modes at their TPU options
# (general_cd_bench.py:94-125), as TdunesOpts fields: a dual stationarity of
# TOL/4 below the KKT bar TOL = 1e-8; stage_solver "mixed" for the mixed
# mode. tdunes_solve sets h_diag and, in mixed mode, node_solver from the
# data, as the bench does.
GENERAL_CD_OPTS = dict(stage_solver="qpgen", tol=2.5e-9, max_iter=150,
                       factor_dtype="float32", refine_steps=1, refine_safeguard=False,
                       qpgen_factor_dtype="float32", qpgen_iters=100,
                       chain_backend="pallas", reg_type="always", reg_value=1e-6,
                       f32_phase_tol=1e-4, f32_patience=3)
# the same modes at general_cd_bench's CPU options (on_tpu=False): f64
# factors, no refinement, the plain tree Cholesky (chain_backend "xla") with
# the on-the-fly Levenberg-Marquardt shift, no coarse phase
GENERAL_CD_CPU_OPTS = dict(stage_solver="qpgen", tol=2.5e-9, max_iter=150,
                           factor_dtype="same", refine_steps=0, refine_safeguard=False,
                           qpgen_factor_dtype="same", qpgen_iters=100,
                           chain_backend="xla", reg_type="on_the_fly", reg_value=1e-6,
                           f32_phase_tol=0.0, f32_patience=3)

# the IPM's main paths, as IpmOpts fields: "cd", general_cd_bench's ipm_ms
# mode at its TPU options (general_cd_bench.py:137-140) on general_cd("qpgen"),
# also ipm_solve's f32 path (one refinement step) on diagonal box-only trees;
# "box", ipm_bench's ms_f32_pallas mode (ipm_bench.py:40-41, 74) on the
# box-only spring_mass_chain(4, 4, 4, 20)
IPM_OPTS = dict(
    cd=dict(tol=1e-8, max_iter=60, factor_dtype="float32", refine_steps=1,
            chain_backend="pallas"),
    box=dict(tol=1e-8, max_iter=40, factor_dtype="float32", chain_backend="pallas"))

# sdunes_bench's options on the card (sdunes_bench.py:55-78), as SdunesOpts
# fields (SDUNES_OPTS: _sdunes_opts(on_tpu=True), the sdunes modes' solve)
# and as TdunesOpts fields (SDUNES_BOOT_OPTS: _tdunes_opts(on_tpu=True,
# tol=1e-4), the tdunes_ms_solve bootstrap of sdunes_boot)
SDUNES_OPTS = dict(tol=1e-8, max_iter=150, factor_dtype="float32", refine_steps=2,
                   f32_phase_tol=1e-4, chain_backend="pallas", reg_type="always",
                   reg_value=1e-6)
SDUNES_BOOT_OPTS = dict(stage_solver="clipping", tol=1e-4, max_iter=120,
                        factor_dtype="float32", refine_steps=2, refine_safeguard=False,
                        chain_backend="pallas", reg_type="always", reg_value=1e-6,
                        f32_phase_tol=1e-4, df64_phase=True)


def _col_major(flat: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Unstack [k*rows*cols] column-major chunks into [k, rows, cols]."""
    return flat.reshape(-1, cols, rows).transpose(0, 2, 1)


def spring_mass_qp(data_dir: str = SPRING_MASS_DIR, xmax1: float = 0.2,
                   x0_from_file: bool = True, device="cuda"):
    """The spring_mass.c robust-MPC tree QP (reference spring_mass.c:125-227)
    from its code-generated instance: ``data_dir``'s data.c (and x0.txt with
    ``x0_from_file``, else x0 = 0). Drops the first (nominal) dynamics
    realization as spring_mass.c:226 does and sets xmax[1] to ``xmax1``
    (spring_mass.c:126) so that state constraints are active at the
    solution; ``xmax1=None`` keeps data.c's bound (the instance of
    spring_mass_dual_newton_scenarios.c). The same data as
    ``benchmarks.models.spring_mass_qp``, made on ``device``. A missing file
    raises, naming its path. Returns (qp, x0)."""
    paths = [f"{data_dir}/data.c"] + ([f"{data_dir}/x0.txt"] if x0_from_file else [])
    for path in paths:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"spring_mass_qp: no reference data file {path}")
    d = parse_c_arrays(paths[0])
    Nh, Nr, md = int(d["Nh"]), int(d["Nr"]), int(d["md"])
    NX, NU = int(d["NX"]), int(d["NU"])

    A = _col_major(d["A"], NX, NX)[1:]  # drop the nominal realization
    B = _col_major(d["B"], NX, NU)[1:]
    b = d["b"].reshape(-1, NX)[1:]

    xmax = d["xmax"].copy()
    if xmax1 is not None:
        xmax[1] = xmax1

    x0 = read_txt_vector(paths[1]) if x0_from_file else np.zeros(NX)

    topo = TreeStructure.multistage(md=md, Nr=Nr, Nh=Nh, nx=NX, nu=NU)
    qp = TreeQPIn.lti_diag_weights(
        topo, A, B, b,
        dQ=d["dQ"], dq=d["q"], dP=d["dP"], dp=d["p"], dR=d["dR"], dr=d["r"],
        xmin=d["xmin"], xmax=xmax, umin=d["umin"], umax=d["umax"], x0=x0,
        scale_by_stage=True, device=device)
    return qp, x0


def _f64(v):
    return torch.as_tensor(np.asarray(v, np.float64))


def linearize(rhs, xlin, ulin):
    """Jacobians (A, B) of a continuous-time rhs at a point, f64 on the CPU."""
    x, u = _f64(xlin), _f64(ulin)
    jac = torch.autograd.functional.jacobian
    A = jac(lambda xx: rhs(xx, u), x)
    B = jac(lambda uu: rhs(x, uu), u)
    return A.numpy(), B.numpy()


def discretize(A, B, Ts):
    """Exact ZOH discretization via the augmented matrix exponential."""
    nx, nu = B.shape
    M = np.zeros((nx + nu, nx + nu))
    M[:nx, :nx] = Ts * A
    M[:nx, nx:] = Ts * B
    E = torch.linalg.matrix_exp(torch.as_tensor(M)).numpy()
    return E[:nx, :nx], E[:nx, nx:]


def rk4_step(rhs, x, u, Ts, substeps=1):
    """RK4 integrator (common/integrate_RK4.m) for the plant simulator."""
    h = Ts / substeps
    for _ in range(substeps):
        k1 = rhs(x, u)
        k2 = rhs(x + h / 2 * k1, u)
        k3 = rhs(x + h / 2 * k2, u)
        k4 = rhs(x + h * k3, u)
        x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


@dataclasses.dataclass
class BenchmarkModel:
    """A robust-MPC benchmark instance: tree QP and nonlinear plant."""

    qp: TreeQPIn
    x0: np.ndarray
    xref: np.ndarray  # [NSIM, nx] reference trajectory
    weights: dict  # dQ, dR, dP diagonals (for online q/r updates)
    Ts: float
    simulate: Callable  # (x, u) -> next x of the true plant (numpy, f64)


def _quadcopter_rhs(par):
    rho, A, Cl, Cd, L, L2 = par["rho"], par["A"], par["Cl"], par["Cd"], par["L"], par["L2"]
    J1, J2, J3 = par["J1"], par["J2"], par["J3"]

    def rhs(x, u):
        q2, q3, q4, O1, O2, O3 = x.unbind()
        q1 = torch.sqrt(torch.clamp(1.0 - q2**2 - q3**2 - q4**2, min=1e-12))
        quat = 0.5 * torch.stack([
            q1 * O1 - q4 * O2 + q3 * O3,
            q4 * O1 + q1 * O2 - q2 * O3,
            -q3 * O1 + q2 * O2 + q1 * O3,
        ])
        W1, W2, W3, W4 = u.unbind()
        dO1 = (-J3 * O2 * O3 + J2 * O2 * O3 + (A * Cl * L * rho * (W2 * W2 - W4 * W4)) / 2) / J1
        dO2 = (J3 * O1 * O3 - J1 * O1 * O3 + (A * Cl * L * rho * (W3 * W3 - W1 * W1)) / 2) / J2
        dO3 = (-J2 * O1 * O2 + J1 * O1 * O2 + (A * Cd * L2 * rho * (W1 * W1 - W2 * W2 + W3 * W3 - W4 * W4)) / 2) / J3
        return torch.cat([quat, torch.stack([dO1, dO2, dO3])])

    return rhs


def _quadcopter_params(m=10.0):
    # default_params_quadcopter.m
    return dict(rho=1.23, A=0.1, Cl=0.25, Cd=0.3 * 0.25, m=m, g=9.81,
                L=0.5, L2=1.0, J1=0.25, J2=0.25, J3=1.0, Ts=0.05)


def quadcopter(md=4, Nr=4, Nh=20, x0=None, seed=0, device="cuda"):
    """Quadcopter attitude robust-MPC tree QP, uncertain mass in [8, 12] kg
    (initialize_quadcopter.m; md realizations linspace over the range).

    nx=6 (quaternion vector part + body rates), nu=4 (rotor speed deltas).
    Same data and plant as ``benchmarks.models.quadcopter`` for the same
    arguments: ``simulate`` integrates the nonlinear model (RK4, 5 substeps,
    f64 on the CPU) at the true mass, drawn from ``seed + 1``, with the
    rotor speeds at hover plus the control. The QP's tensors are made on
    ``device``: the card unless the caller passes ``device="cpu"``.
    """
    nx, nu = 6, 4
    masses = np.linspace(8.0, 12.0, md) if md > 1 else np.array([10.0])
    As, Bs = [], []
    for m in masses:
        par = _quadcopter_params(m)
        # linearize at hover: omega_hover from force balance
        w_h = np.sqrt(2 * m * par["g"] / (par["A"] * par["Cl"] * par["rho"]) / 4)
        A, B = linearize(_quadcopter_rhs(par), np.zeros(nx), w_h * np.ones(nu))
        Ad, Bd = discretize(A, B, par["Ts"])
        As.append(Ad)
        Bs.append(Bd)
    A = np.stack(As)
    B = np.stack(Bs)
    b = np.zeros((md, nx))

    dQ = np.array([500.0, 500, 500, 0.001, 0.001, 0.001])
    dR = 0.001 * np.ones(nu)
    dP = dQ
    inf = 1e12  # reference uses 1e8 as "inf"; map to TREEQP_INF
    xmin = np.concatenate([-inf * np.ones(3), -np.ones(3)])
    xmax = -xmin
    du = 4.0

    if x0 is None:
        rng = np.random.default_rng(seed)
        x0 = np.concatenate([0.05 * rng.standard_normal(3), np.zeros(3)])

    topo = TreeStructure.multistage(md=md, Nr=Nr, Nh=Nh, nx=nx, nu=nu)
    qp = TreeQPIn.lti_diag_weights(
        topo, A, B, b, dQ=dQ, dq=np.zeros(nx), dP=dP, dp=np.zeros(nx),
        dR=dR, dr=np.zeros(nu), xmin=xmin, xmax=xmax,
        umin=-du * np.ones(nu), umax=du * np.ones(nu), x0=x0, device=device)

    m_sim = float(np.random.default_rng(seed + 1).uniform(8.0, 12.0))
    par_sim = _quadcopter_params(m_sim)
    rhs_sim = _quadcopter_rhs(par_sim)
    w_h = np.sqrt(2 * m_sim * par_sim["g"] / (par_sim["A"] * par_sim["Cl"] * par_sim["rho"]) / 4)

    def simulate(x, u):
        # plant input = hover speed + delta (MPC controls deltas around hover)
        return rk4_step(rhs_sim, _f64(x), _f64(u) + w_h, par_sim["Ts"], 5).numpy()

    return BenchmarkModel(qp=qp, x0=np.asarray(x0), xref=np.zeros((1, nx)),
                          weights=dict(dQ=dQ, dR=dR, dP=dP), Ts=par_sim["Ts"],
                          simulate=simulate)


def _linear_models(rhs_of, params, nx, nu, Ts):
    """Each parameter's rhs linearized at the origin and discretized:
    stacked (A, B) [len(params), nx, nx / nu]."""
    AB = [discretize(*linearize(rhs_of(p), np.zeros(nx), np.zeros(nu)), Ts) for p in params]
    return np.stack([ab[0] for ab in AB]), np.stack([ab[1] for ab in AB])


def _crane_rhs(b, g=9.81):
    def rhs(x, u):
        p, v, phi, omega = x.unbind()
        a = u[0]
        return torch.stack([v, a, omega,
                            -g * torch.sin(phi) - a * torch.cos(phi) - b * omega])

    return rhs


def crane(md=3, Nr=2, Nh=10, x0=None, sim_b=None, seed=0, device="cuda"):
    """Overhead crane robust-MPC tree QP, uncertain friction b in [0.1, 0.3]
    (initialize_crane.m; md realizations linspace over the range). nx=4
    (position, velocity, angle, angular velocity), nu=1 (the trolley's
    acceleration), Ts=0.2; the reference xref = [0.2, 0, 0, 0] folded into
    the linear terms. The same data and plant as ``benchmarks.models.crane``
    for the same arguments: ``simulate`` integrates the nonlinear model (RK4,
    5 substeps, f64 on the CPU) at the true friction, ``sim_b`` or drawn
    from ``seed``. The QP's tensors are made on ``device``."""
    nx, nu = 4, 1
    Ts = 0.2
    bs = np.linspace(0.1, 0.3, md) if md > 1 else np.array([0.2])
    A, B = _linear_models(_crane_rhs, bs, nx, nu, Ts)
    bvec = np.zeros((md, nx))

    inf = 1e12
    dQ = np.array([10.0, 1, 1, 1])
    dR = np.array([0.1])
    xmin = np.array([-inf, -0.2, -inf, -0.4])
    xmax = -xmin
    xref = np.array([0.2, 0, 0, 0])
    if x0 is None:
        x0 = np.zeros(nx)

    topo = TreeStructure.multistage(md=md, Nr=Nr, Nh=Nh, nx=nx, nu=nu)
    qp = TreeQPIn.lti_diag_weights(
        topo, A, B, bvec, dQ=dQ, dq=-dQ * xref, dP=dQ, dp=-dQ * xref,
        dR=dR, dr=np.zeros(nu), xmin=xmin, xmax=xmax,
        umin=[-0.5], umax=[0.5], x0=x0, device=device)

    b_sim = sim_b if sim_b is not None else float(
        np.random.default_rng(seed).uniform(0.1, 0.3))
    rhs_sim = _crane_rhs(b_sim)

    def simulate(x, u):
        return rk4_step(rhs_sim, _f64(x), _f64(u), Ts, 5).numpy()

    return BenchmarkModel(qp=qp, x0=np.asarray(x0), xref=xref[None],
                          weights=dict(dQ=dQ, dR=dR, dP=dQ), Ts=Ts, simulate=simulate)


def _linear_chain_rhs(nm, nu_count, k):
    T = (np.diag(-2.0 * np.ones(nm)) + np.diag(np.ones(nm - 1), -1)
         + np.diag(np.ones(nm - 1), 1))
    # the controls act as velocity inputs on the first nu_count masses
    Bv = np.zeros((nm, nu_count))
    for i in range(nu_count):
        Bv[i, i] = 1.0
    Tk, Bt = _f64(k * T), _f64(Bv)

    def rhs(x, u):
        return torch.cat([x[nm:], Tk @ x[:nm] + Bt @ u])

    return rhs


def linear_chain(nm=4, nu_count=3, md=3, Nr=2, Nh=10, sim_k=None, seed=0, device="cuda"):
    """Chain of ``nm`` masses on springs, ``nu_count`` of them actuated,
    uncertain spring constant k in [4, 8] (initialize_linear_chain.m; md
    realizations linspace over the range). nx = 2 nm, nu = nu_count,
    Ts=0.05; x0 at rest but for velocity 2.0 on the first uncontrolled
    mass. The same data and plant as ``benchmarks.models.linear_chain`` for
    the same arguments: ``simulate`` integrates the model (RK4, 5 substeps,
    f64 on the CPU) at the true constant, ``sim_k`` or drawn from ``seed``.
    The QP's tensors are made on ``device``."""
    nx = 2 * nm
    Ts = 0.05
    ks = np.linspace(4.0, 8.0, md) if md > 1 else np.array([6.0])
    A, B = _linear_models(lambda k: _linear_chain_rhs(nm, nu_count, k), ks, nx, nu_count, Ts)
    bvec = np.zeros((md, nx))

    x0 = np.zeros(nx)
    x0[nm + min(nu_count, nm - 1)] = 2.0  # initial velocity on an uncontrolled mass

    topo = TreeStructure.multistage(md=md, Nr=Nr, Nh=Nh, nx=nx, nu=nu_count)
    qp = TreeQPIn.lti_diag_weights(
        topo, A, B, bvec, dQ=10 * np.ones(nx), dq=np.zeros(nx),
        dP=10 * np.ones(nx), dp=np.zeros(nx),
        dR=np.ones(nu_count), dr=np.zeros(nu_count),
        xmin=-2.0 * np.ones(nx), xmax=2.0 * np.ones(nx),
        umin=-2.0 * np.ones(nu_count), umax=2.0 * np.ones(nu_count), x0=x0, device=device)

    k_sim = sim_k if sim_k is not None else float(
        np.random.default_rng(seed).uniform(4.0, 8.0))
    rhs_sim = _linear_chain_rhs(nm, nu_count, k_sim)

    def simulate(x, u):
        return rk4_step(rhs_sim, _f64(x), _f64(u), Ts, 5).numpy()

    return BenchmarkModel(qp=qp, x0=x0, xref=np.zeros((1, nx)),
                          weights=dict(dQ=10 * np.ones(nx), dR=np.ones(nu_count),
                                       dP=10 * np.ones(nx)), Ts=Ts, simulate=simulate)


def pruned(qp, nscen, seed=0):
    """The full scenario tree QP ``qp`` pruned to ``nscen`` scenarios with
    leaf probabilities drawn from a flat Dirichlet (numpy, ``seed``): the
    pruned controllers of ``benchmarks/fault_tolerance.py:84-107``. On
    ``qp``'s device."""
    from treeqp_tpu_torch.utils.pruning import prune_scenario_tree
    n_leaves = int(np.sum(qp.topo.nkids == 0))
    probs = np.random.default_rng(seed).dirichlet(np.ones(n_leaves))
    return prune_scenario_tree(qp, leaf_probs=probs, nscenmax=nscen)[0]


def asym_tree(device="cuda"):
    """The asymmetric thesis-class tree of ``benchmarks/generic_bench.py``
    (``build("asym_speed")``): the root branches three ways and the
    branches chain to depths 2, 5 and 9 (20 nodes); nx=8, nu=3, diagonal
    weights and box bounds, data from numpy's generator with seed 3. Made
    on ``device``."""
    rng = np.random.default_rng(3)
    parent, tips = [-1, 0, 0, 0], [1, 2, 3]
    for d, depth in zip((1, 2, 3), (2, 5, 9)):
        for _ in range(depth):
            parent.append(tips[d - 1])
            tips[d - 1] = len(parent) - 1
    Nn, nx, nu = len(parent), 8, 3
    topo = TreeStructure.from_parent(parent, [nx] * Nn, [nu] * Nn, [0] * Nn)
    Qd = 1.0 + rng.random((Nn, nx))
    Rd = 1.0 + rng.random((Nn, nu))
    data = dict(Q=np.einsum("ni,ij->nij", Qd, np.eye(nx)),
                R=np.einsum("ni,ij->nij", Rd, np.eye(nu)),
                q=rng.standard_normal((Nn, nx)), r=rng.standard_normal((Nn, nu)),
                A=rng.standard_normal((Nn, nx, nx)) * 0.3,
                B=rng.standard_normal((Nn, nx, nu)) * 0.3,
                b=rng.standard_normal((Nn, nx)) * 0.1,
                xmin=np.full((Nn, nx), -0.9), xmax=np.full((Nn, nx), 0.9),
                umin=np.full((Nn, nu), -0.7), umax=np.full((Nn, nu), 0.7))
    for k in ("A", "B", "b"):
        data[k][0] = 0.0
    return TreeQPIn.zeros(topo, device=device).replace(
        **{k: torch.tensor(v, dtype=torch.float64, device=device) for k, v in data.items()})


def spring_mass_dynamics(nm: int, k: float, dt: float, substeps: int = 10):
    """Discretized chain of ``nm`` masses coupled by springs of stiffness
    ``k`` (wall-mass-...-mass-wall), control = force on the last mass.

    States: [positions; velocities] (nx = 2 nm), RK4 with ``substeps``, in
    numpy f64: the same matrices as ``benchmarks.models.spring_mass_dynamics``.
    """
    nx = 2 * nm
    K = np.zeros((nm, nm))
    for i in range(nm):
        K[i, i] = -2.0 * k
        if i > 0:
            K[i, i - 1] = k
        if i < nm - 1:
            K[i, i + 1] = k
    Ac = np.zeros((nx, nx))
    Ac[:nm, nm:] = np.eye(nm)
    Ac[nm:, :nm] = K
    Bc = np.zeros((nx, 1))
    Bc[-1, 0] = 1.0

    def f(M, N):
        return Ac @ M, Ac @ N + Bc

    h = dt / substeps
    Ad = np.eye(nx)
    Bd = np.zeros((nx, 1))
    for _ in range(substeps):
        # one RK4 step of [x' = Ac x + Bc u] with u held constant
        k1A, k1B = f(Ad, Bd)
        k2A, k2B = f(Ad + h / 2 * k1A, Bd + h / 2 * k1B)
        k3A, k3B = f(Ad + h / 2 * k2A, Bd + h / 2 * k2B)
        k4A, k4B = f(Ad + h * k3A, Bd + h * k3B)
        Ad = Ad + h / 6 * (k1A + 2 * k2A + 2 * k3A + k4A)
        Bd = Bd + h / 6 * (k1B + 2 * k2B + 2 * k3B + k4B)
    return Ad, Bd


def spring_mass_chain(nm: int = 2, md: int = 3, Nr: int = 2, Nh: int = 10,
                      dt: float = 0.1, k_nominal: float = 2.0, k_spread: float = 1.0,
                      umax: float = 1.0, xmax_pos: float = 1.2, x0=None, device="cuda"):
    """Robust-MPC scenario-tree QP over the spring-mass chain: ``md``
    realizations of the spring constant in [k_nominal - k_spread,
    k_nominal + k_spread], probability-scaled stage weights. The same data
    as ``benchmarks.models.spring_mass_chain`` for the same arguments, made
    on ``device`` (the card unless the caller passes ``device="cpu"``).
    Returns (qp, x0)."""
    nx, nu = 2 * nm, 1
    ks = np.linspace(k_nominal - k_spread, k_nominal + k_spread, md)
    AB = [spring_mass_dynamics(nm, k, dt) for k in ks]
    A = np.stack([ab[0] for ab in AB])
    B = np.stack([ab[1] for ab in AB])
    b = np.zeros((md, nx))

    if x0 is None:
        rng = np.random.default_rng(42)
        x0 = 0.5 * rng.standard_normal(nx)
        x0[nm:] = 0.0

    dQ = np.ones(nx)
    dQ[:nm] = 10.0
    dP = 10.0 * dQ
    dR = 0.1 * np.ones(nu)
    xmin = np.full(nx, -1e12)
    xmax = np.full(nx, 1e12)
    xmax[:nm] = xmax_pos

    topo = TreeStructure.multistage(md=md, Nr=Nr, Nh=Nh, nx=nx, nu=nu)
    qp = TreeQPIn.lti_diag_weights(
        topo, A, B, b, dQ=dQ, dq=np.zeros(nx), dP=dP, dp=np.zeros(nx),
        dR=dR, dr=np.zeros(nu), xmin=xmin, xmax=xmax,
        umin=[-umax], umax=[umax], x0=x0, scale_by_stage=True, device=device)
    return qp, x0


def _with_rows(qp, rows, C_of, D_of, cmax):
    """``qp`` with one general row dmin <= C x + D u <= dmax on each node
    where ``rows`` is 1 (C_of(i), D_of(i): the node's row), +-cmax on those
    rows and +-1e12 on the padding."""
    t = qp.topo
    topo = TreeStructure.from_parent(t.parent, t.nx, t.nu, rows)
    Nn, ncm = topo.Nn, topo.ncm
    C = np.zeros((Nn, ncm, topo.nxm))
    D = np.zeros((Nn, ncm, topo.num))
    dmin = np.full((Nn, ncm), -1e12)
    dmax = np.full((Nn, ncm), 1e12)
    for i in range(Nn):
        if rows[i]:
            C[i, 0], D[i, 0] = C_of(i), D_of(i)
            dmin[i, 0], dmax[i, 0] = -cmax, cmax
    kw = dict(dtype=qp.dtype, device=qp.device)
    return qp.replace(C=torch.tensor(C, **kw), D=torch.tensor(D, **kw),
                      dmin=torch.tensor(dmin, **kw), dmax=torch.tensor(dmax, **kw),
                      topo=topo)


def with_general_rows(qp, cmax=0.3):
    """``qp`` with one general constraint row on every node,
    -cmax <= sum_i x_i + 0.5 u_0 <= cmax (the C/D rows of
    ``benchmarks.models.with_general_rows``), on ``qp``'s device."""
    t = qp.topo
    xm, um = t.x_mask, t.u_mask
    return _with_rows(qp, [1] * t.Nn, lambda i: xm[i],
                      lambda i: np.eye(t.num)[0] * 0.5 * um[i, 0], cmax)


def with_sparse_rows(qp, cmax=0.6):
    """``qp`` with a general row on every third non-root node only,
    -cmax <= sum_i x_i + 0.5 sum_j u_j <= cmax: the instance of
    general_cd_bench's mixed mode (``general_cd_bench.py:58-77``), whose
    other nodes keep clipping stage QPs."""
    t = qp.topo
    rows = [1 if (i % 3 == 0 and i > 0) else 0 for i in range(t.Nn)]
    return _with_rows(qp, rows, lambda i: t.x_mask[i], lambda i: 0.5 * t.u_mask[i], cmax)


def general_cd(mode="qpgen", nm=4, md=4, Nr=4, Nh=20, device="cuda"):
    """The tree of ``benchmarks/general_cd_bench.py``'s tdunes modes:
    ``spring_mass_chain(nm, md, Nr, Nh)`` (by default the bench's 256
    scenarios, 4437 nodes, nx=8, nu=1) with a row -0.6 <= sum x + 0.5 u <= 0.6
    on every node (``mode="qpgen"``) or on every third non-root node
    (``mode="mixed"``). Made on ``device``."""
    qp, _ = spring_mass_chain(nm=nm, md=md, Nr=Nr, Nh=Nh, device=device)
    if mode == "qpgen":
        return with_general_rows(qp, cmax=0.6)
    if mode == "mixed":
        return with_sparse_rows(qp)
    raise ValueError(f"general_cd: unknown mode {mode!r}")

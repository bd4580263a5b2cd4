"""Benchmark problem generators (port of ``benchmarks/models.py``), and the
generic-tree solver's instances and options of ``benchmarks/generic_bench.py``
and ``benchmarks/fault_tolerance.py``.

Only the quadcopter family is ported: attitude model with uncertain mass
(8-12 kg), Ts=0.05 (benchmark/quadcopter/dynamics_quadcopter_mpc.m +
default params), linearized around hover with ``torch.autograd`` (in place
of jax.jacobian / CasADi, common/linearize_model.m) and exactly discretized
with the augmented matrix exponential (common/discretize_model.m). Model
construction is host-side work: it runs in f64 on the CPU, and the
returned QP is moved to the requested device at the end. The nonlinear
plant simulator of the JAX version is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TreeQPIn
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["BenchmarkModel", "quadcopter", "linearize", "discretize", "GENERIC_SPEED_OPTS",
           "asym_tree", "pruned"]

# the generic-tree solver's options, generic_bench.speed_opts(on_tpu=True),
# as TdunesOpts fields
GENERIC_SPEED_OPTS = dict(stage_solver="clipping", tol=1e-8, max_iter=120,
                          factor_dtype="float32", refine_steps=1,
                          refine_safeguard=False, chain_backend="pallas",
                          reg_type="always", reg_value=1e-6, f32_phase_tol=1e-4,
                          f32_patience=3, df64_phase=False)


def linearize(rhs, xlin, ulin):
    """Jacobians (A, B) of a continuous-time rhs at a point, f64 on the CPU."""
    x = torch.as_tensor(np.asarray(xlin, np.float64))
    u = torch.as_tensor(np.asarray(ulin, np.float64))
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


@dataclasses.dataclass
class BenchmarkModel:
    """A robust-MPC benchmark instance (the plant simulator is not ported)."""

    qp: TreeQPIn
    x0: np.ndarray
    xref: np.ndarray  # [NSIM, nx] reference trajectory
    weights: dict  # dQ, dR, dP diagonals (for online q/r updates)
    Ts: float


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
    Same data as ``benchmarks.models.quadcopter`` for the same arguments.
    The QP's tensors are made on ``device``: the card unless the caller
    passes ``device="cpu"``.
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
    return BenchmarkModel(qp=qp, x0=np.asarray(x0), xref=np.zeros((1, nx)),
                          weights=dict(dQ=dQ, dR=dR, dP=dP),
                          Ts=_quadcopter_params()["Ts"])


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

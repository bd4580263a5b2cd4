"""PyTorch port, sdunes' two kernels: the plain twins of the CUDA kernels
chain_full_solve_mat and jay_cr_solve (what the wrappers run on CPU
tensors) against the JAX Pallas kernels in interpret mode, on the same
numpy-seeded f32 operands; the Jay twin also against the JAX package's
batched cyclic reduction (``ops/tridiag.py``) beyond the Pallas kernel's
caps. Each interpret-mode Jay solve takes 7-15 s on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from treeqp_tpu.ops import chain_kernels as jck
from treeqp_tpu.ops import jay_kernel as jjk
from treeqp_tpu.ops.tridiag import tridiag_cr_solve

import chip_smoke

from treeqp_tpu_torch.ops import chain_kernels as ck
from treeqp_tpu_torch.ops import jay_kernel as jk

torch.set_num_threads(1)

# f32 on both sides, the same per-element order, FMA-free on the CPU:
# factors to 1e-5 x max(1, max|ref|), solves to 1e-4 relative
FACTOR_RTOL, SOLVE_RTOL = 1e-5, 1e-4


def close(got, ref, rtol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    err = np.abs(got - ref).max()
    assert err <= rtol * max(1.0, np.abs(ref).max()), (what, err)


def chain_blocks(S, L, n, seed):
    """Equilibrated-like SPD chain blocks W and couplings Ut with Ut_0 = 0
    (self-contained chains), f32."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((S, L, n, n))
    W = G @ G.transpose(0, 1, 3, 2) / n + 4.0 * np.eye(n)  # dominates the couplings
    Ut = 0.3 * rng.standard_normal((S, L, n, n))
    Ut[:, 0] = 0.0
    return W.astype(np.float32), Ut.astype(np.float32)


@pytest.mark.parametrize("S,L,n,m", [(5, 6, 4, 5), (16, 8, 8, 1), (3, 1, 8, 5),
                                     (16, 8, 4, 17), (5, 2, 9, 5), (3, 2, 16, 1)])
def test_chain_full_solve_mat_matches_pallas(S, L, n, m):
    """The chains factored by the Pallas chain_factor (kernel layout), then
    solved by the Pallas full solve and by the twin on the same factors;
    the twin's chain_factor against the Pallas one. The last two at the
    CUDA kernel's edges (chip_smoke.FULL_EDGES): n = 9 and 16 (16 lanes a
    chain and column), two steps (fewer than its ring holds)."""
    W, Ut = chain_blocks(S, L, n, seed=S + L + n + m)
    rhs = np.random.default_rng(m).standard_normal((S, L, n, m)).astype(np.float32)
    Lt, CUt, _ = jck.chain_factor(jnp.asarray(W), jnp.asarray(Ut))
    zj = np.asarray(jck.chain_full_solve_mat(Lt, CUt, jnp.asarray(rhs)))
    to_port = lambda v: torch.tensor(np.ascontiguousarray(
        np.transpose(np.asarray(v)[..., :S], (3, 0, 1, 2))))
    Ls, CUs = to_port(Lt), to_port(CUt)
    z = ck.chain_full_solve_mat(Ls, CUs, torch.tensor(rhs))
    close(z, zj, SOLVE_RTOL, "z")
    Ls2, CUs2, _ = ck.chain_factor(torch.tensor(W), torch.tensor(Ut))
    close(Ls2, Ls, FACTOR_RTOL, "Ls")
    close(CUs2, CUs, FACTOR_RTOL, "CUs")
    assert float(CUs2[:, 0].abs().max()) == 0.0


def test_chain_full_solve_mat_solves_the_banded_system():
    """z solves the banded system whose blocks were factored: in the chain
    order j, M z = rhs with diagonal blocks W_j and off-diagonal blocks
    M[j-1, j] = Ut_j, M[j, j-1] = Ut_j', checked in f64."""
    S, L, n, m = 4, 5, 4, 3
    W, Ut = chain_blocks(S, L, n, seed=1)
    rhs = np.random.default_rng(2).standard_normal((S, L, n, m)).astype(np.float32)
    Ls, CUs, _ = ck.chain_factor(torch.tensor(W), torch.tensor(Ut))
    z = ck.chain_full_solve_mat(Ls, CUs, torch.tensor(rhs)).double().numpy()
    Wd, Ud = W.astype(np.float64), Ut.astype(np.float64)
    Mz = np.einsum("slij,sljc->slic", Wd, z)
    Mz[:, 1:] += np.einsum("slji,sljc->slic", Ud[:, 1:], z[:, :-1])
    Mz[:, :-1] += np.einsum("slij,sljc->slic", Ud[:, 1:], z[:, 1:])
    assert np.abs(Mz - rhs).max() < 1e-4 * max(1.0, np.abs(rhs).max())


def jay_system(P, b, seed, singular=False):
    """The construction of tests/test_jay_kernel.py: SPD diagonal blocks,
    small off-diagonal blocks, one exactly singular row on request (a fully
    clipped coordinate zeroes its couplings too)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(P, b, b))
    diag = A @ A.transpose(0, 2, 1) + 3.0 * b * np.eye(b)
    off = 0.3 * rng.normal(size=(max(P - 1, 0), b, b))
    rhs = rng.normal(size=(P, b))
    if singular and P > 2:
        m = P // 2
        diag[m, 0, :] = 0.0
        diag[m, :, 0] = 0.0
        off[m, :, 0] = 0.0
        off[m - 1, 0, :] = 0.0
    return [v.astype(np.float32) for v in (diag, off, rhs)]


JAY_CASES = {"P7_b3_none": (7, 3, "none"), "P7_b4_always": (7, 4, "always"),
             "P7_b4_fly_singular": (7, 4, "fly"), "P100_b3_none": (100, 3, "none"),
             "P100_b4_always": (100, 4, "always"), "P100_b3_fly_singular": (100, 3, "fly"),
             # the CUDA kernel's edges within the Pallas kernel's b <= 8: the
             # root alone, one and two levels, 64 and 65 blocks; b = 1 (a
             # lane group of 4 with three idle rows) and b = 8 (a full group)
             "P1_b1_none": (1, 1, "none"), "P1_b8_always": (1, 8, "always"),
             "P2_b1_fly": (2, 1, "fly"), "P2_b8_always": (2, 8, "always"),
             "P3_b1_fly_singular": (3, 1, "fly"), "P3_b8_none": (3, 8, "none"),
             "P64_b1_none": (64, 1, "none"), "P64_b8_fly_singular": (64, 8, "fly"),
             "P65_b1_always": (65, 1, "always"), "P65_b8_fly_singular": (65, 8, "fly")}


@pytest.mark.parametrize("case", sorted(JAY_CASES))
def test_jay_cr_solve_matches_pallas(case):
    """The twin against the interpret-mode Pallas kernel: no shift, the
    shift always on, and on the fly with an exactly singular block (whose
    pivot triggers the shift)."""
    P, b, mode = JAY_CASES[case]
    diag, off, rhs = jay_system(P, b, seed=P + b, singular=mode == "fly")
    shift = None if mode == "none" else np.full((P, b), 1e-2, np.float32)
    reg_tol = 1e-6 if mode == "fly" else -1.0
    xj = np.asarray(jjk.jay_cr_solve(jnp.asarray(diag), jnp.asarray(off), jnp.asarray(rhs),
                                     shift=None if shift is None else jnp.asarray(shift),
                                     reg_tol=reg_tol))
    t = lambda v: None if v is None else torch.tensor(v)
    x = jk.jay_cr_solve(t(diag), t(off), t(rhs), t(shift), reg_tol)
    close(x, xj, SOLVE_RTOL, case)


@pytest.mark.parametrize("P,b", [(300, 16), (1, 4), (2, 3), (1, 16), (2, 16), (3, 16),
                                 (64, 16), (65, 16)])
def test_jay_cr_solve_matches_tridiag(P, b):
    """Beyond the Pallas kernel's caps (b = 16, the CUDA kernel's lane
    groups of 16, at P = 1, 2, 3, 64, 65 and 300; and P = 1, the root solve
    alone) against the JAX package's batched cyclic reduction on a
    well-conditioned system, shift always on."""
    diag, off, rhs = jay_system(P, b, seed=P * b)
    shift = np.full((P, b), 1e-3, np.float32)
    xr = np.asarray(tridiag_cr_solve(jnp.asarray(diag), jnp.asarray(off), jnp.asarray(rhs),
                                     shift=jnp.asarray(shift), reg_tol=-1.0))
    x = jk.jay_cr_solve(*(torch.tensor(v) for v in (diag, off, rhs, shift)), -1.0)
    close(x, xr, SOLVE_RTOL, (P, b))


def test_jay_cr_solve_solves_the_system():
    """x solves the block-tridiagonal system to f32 accuracy (f64 check)."""
    P, b = 37, 5
    diag, off, rhs = jay_system(P, b, seed=5)
    x = jk.jay_cr_solve(*(torch.tensor(v) for v in (diag, off, rhs))).double().numpy()
    d, o = diag.astype(np.float64), off.astype(np.float64)
    r = np.einsum("pij,pj->pi", d, x)
    r[1:] += np.einsum("pij,pj->pi", o, x[:-1])
    r[:-1] += np.einsum("pji,pj->pi", o, x[1:])
    assert np.abs(r - rhs).max() < 1e-4 * max(1.0, np.abs(rhs).max())


@pytest.mark.parametrize("P,b,reg_tol,singular", [(7, 3, None, False), (64, 8, -1.0, True),
                                                  (65, 4, 1e-6, True), (1, 16, -1.0, False)])
def test_jay_matrix_yardstick(P, b, reg_tol, singular):
    """chip_smoke's library call of jay_cr_solve: torch.linalg.solve of the
    dense f32 Jay matrix (``chip_smoke.jay_matrix``, the shift by the
    kernel's rule) equals the twin to SOLVE_RTOL on ``chip_smoke.jay_operands``
    (no shift, always, on the fly with the singular block)."""
    cpu = torch.device("cpu")
    j = chip_smoke.jay_operands(torch, P, b, P + b, cpu, singular=singular)
    if reg_tol is None:
        j[3] = None
    tol = -1.0 if reg_tol is None else reg_tol
    x = jk.jay_cr_solve_ref(*j, tol)
    M = chip_smoke.jay_matrix(torch, j[0], j[1], j[3], tol)
    assert M.dtype == torch.float32 and M.shape == (P * b, P * b)
    xl = torch.linalg.solve(M, j[2].reshape(-1)).reshape(P, b)
    close(xl, x, chip_smoke.SOLVE_RTOL, (P, b, reg_tol))

"""PyTorch port: where the cold sdunes solve's iteration count parts from
JAX's, and why that is rounding.

On spring_mass_chain(4, 4, 3, 20) (64 scenarios) at sdunes_bench's
options (``models.SDUNES_OPTS``) JAX's Pallas path takes 19 iterations and
the port 13; at Nr = 4, 57 and 94 (card) / 101 (CPU).
``scripts/replay_torch_sdunes_depth.py`` records every carry of JAX's two
Newton loops (lam, mu, it, err, status, ls_it, best, noimp, boost) and runs
the port's loop body (``solvers.sdunes._sd_iteration``) once from each:
from JAX's states the port takes JAX's stall bookkeeping (noimp, boost,
the shift) and status at every k, and its line-search count wherever it
differs from JAX's is one that JAX's own step takes under a 1/2-ulp
perturbation of its f32 banded blocks (or the port's perturbed steps take
JAX's); with JAX's three Pallas kernels in place of the port's twins, the
port takes JAX's count there too.

This test replays the first iterations of that solve, up to the first
one where the two part (the third coarse iteration: 31 backtracks in
JAX's solve, 35 in the port's): the same decisions at the first two, and
at the third the same bookkeeping, with line-search counts that each
package's rounding reaches from the same state. ~50 s on the CPU, most of
it the compile of JAX's loop body with its Pallas kernels interpreted.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import replay_torch_sdunes_depth as rp  # noqa: E402

torch.set_num_threads(1)

TREE = (4, 4, 3, 20)  # nm, md, Nr, Nh
PARTS_AT = 2          # the coarse iteration where the two solves part
# steps from the parting state with the f32 blocks perturbed by 1/2 ulp:
# JAX's (a compiled body run each) and the port's (a plain-twin step each)
JAX_PERTURBED, PORT_PERTURBED = 2, 16
ERR_RTOL = 1e-5  # the error at a state: f32 residuals (~10 terms) summed in two orders


@functools.lru_cache(maxsize=None)
def recorded():
    """JAX's cold solve stopped after PARTS_AT + 1 coarse iterations, its
    carries recorded, and the port's scenario data."""
    sqp_j, sqp = rp.instance(*TREE)
    rec, info = rp.record(sqp_j, max_iter=PARTS_AT + 1)
    assert int(info["iter"]) == PARTS_AT + 1
    assert len(rec.phases[0]["carries"]) == PARTS_AT + 2
    return rec, sqp


@pytest.mark.parametrize("k", range(PARTS_AT + 1))
def test_port_takes_jax_decisions_from_jax_states(k):
    rec, sqp = recorded()
    phase = rec.phases[0]
    parts = k == PARTS_AT
    row = rp.replay_step(rec, phase, k, sqp, perturb=JAX_PERTURBED if parts else 0,
                         rng=np.random.default_rng(k),
                         perturb_port=PORT_PERTURBED if parts else 0)
    print(rp.fmt(row))
    (err_j, err_p), (ni_j, ni_p), (bo_j, bo_p) = row["err"], row["noimp"], row["boost"]
    assert abs(err_p - err_j) <= ERR_RTOL * max(1.0, err_j)
    assert ni_p == ni_j and bo_p == bo_j and not row["fallback"]
    ls_j, ls_p = row["ls"]
    if not parts:
        assert row["same"] and ls_p == ls_j
        return
    # the paths part here: another line-search count, which rounding
    # reaches from the same state in one package or the other
    assert ls_p != ls_j
    assert set(row["ls_jax"]) & set(row["ls_port"]), (row["ls_jax"], row["ls_port"])

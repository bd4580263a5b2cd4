"""Minimal 6-node asymmetric-tree walkthrough, on the PyTorch + CUDA port.

The exact instance of the reference's examples/thesis_example.c:51-95
(children counts nk = [2,2,1,0,0,0], nx = 2, nu = 1 on internal nodes,
two alternating dynamics realizations, x0 pinned by equality bounds,
|u| <= 1), solved with dual Newton + clipping and with the tree IPM,
cross-checked by the KKT oracle.

Run from the repo root:

    python examples_torch/thesis_example.py               # on the card
    python examples_torch/thesis_example.py --device cpu  # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from treeqp_tpu_torch import (IpmOpts, TdunesOpts, TreeQPIn, TreeStructure,  # noqa: E402
                              ipm_solve, max_kkt_residual, tdunes_solve)
from treeqp_tpu_torch.interfaces.cli import resolve_device  # noqa: E402
from treeqp_tpu_torch.utils.printing import tree_qp_out_print  # noqa: E402


def build_qp(device="cuda") -> TreeQPIn:
    # tree from children counts (thesis_example.c:51: nk = {2,2,1,0,0,0})
    topo = TreeStructure.from_nkids([2, 2, 1, 0, 0, 0],
                                    nx=[2] * 6, nu=[1, 1, 1, 0, 0, 0])
    A1 = np.array([[1.1, 2.2], [3.3, 4.4]])
    A2 = np.array([[5.5, 6.6], [7.7, 8.8]])
    B1 = np.array([[1.0], [2.0]])
    B2 = np.array([[3.0], [4.0]])
    b1 = np.zeros(2)
    b2 = np.ones(2)
    x0 = np.array([2.1, 2.1])

    nodes = []
    for i in range(6):
        nd = dict(Q=np.diag([2.0, 2.0]), q=np.zeros(2))
        if topo.nu[i]:
            nd.update(R=np.eye(1), r=np.zeros(1),
                      umin=np.array([-1.0]), umax=np.array([1.0]))
        if i == 0:  # x0 as equality bounds (thesis_example.c:87-88)
            nd.update(xmin=x0, xmax=x0)
        nodes.append(nd)
    # edges into children 1..5 (thesis_example.c:70-74)
    edges = {1: dict(A=A1, B=B1, b=b1), 2: dict(A=A2, B=B2, b=b2),
             3: dict(A=A1, B=B1, b=b1), 4: dict(A=A2, B=B2, b=b2),
             5: dict(A=A2, B=B2, b=b2)}
    return TreeQPIn.from_node_edge_lists(topo, nodes, edges, device=device)


def main(device="cuda"):
    """Both solves on ``device``, printed and asserted. Returns
    {"tdunes": out, "ipm": out}."""
    qp = build_qp(resolve_device(device, "thesis_example"))
    out = tdunes_solve(qp, None, TdunesOpts(stage_solver="clipping", max_iter=100))
    tree_qp_out_print(qp.topo, out)
    kkt = max_kkt_residual(qp, out)
    print(f"tdunes: status={out.info['status']} iter={out.info['iter']} KKT={kkt:.2e}")

    out2 = ipm_solve(qp, IpmOpts())
    kkt2 = max_kkt_residual(qp, out2)
    dx = float((out.x - out2.x).abs().max())
    print(f"ipm:    status={out2.info['status']} iter={out2.info['iter']} KKT={kkt2:.2e}  "
          f"max|x_tdunes - x_ipm| = {dx:.2e}")
    assert kkt < 1e-10 and kkt2 < 1e-8 and dx < 1e-7
    return {"tdunes": out, "ipm": out2}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)

"""Scenario-tree pruning.

Port of ``treeqp_tpu/utils/pruning.py``: keep the highest-probability
leaves, the nodes on their root paths, rebuild the (generally asymmetric)
topology, and re-normalize the probability-weighted objective so that the
pruned tree QP is the exact conditional expectation over the kept
scenarios (the reference's pruned-tree controller, fault_tolerance.c:57-62,
:93-95). The selection runs in numpy on the topology; the data is cut and
scaled in torch on the device of the input tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from treeqp_tpu_torch.core.qp_data import TreeQPIn
from treeqp_tpu_torch.utils.tree import TreeStructure

__all__ = ["prune_scenario_tree"]


def _subtree_leaf_probsum(topo: TreeStructure, leaf_w, keep_mask_nodes=None):
    """Sum of leaf weights under each node (the node itself if a leaf),
    optionally restricted to kept nodes. With uniform weights this is the
    leaf count; with probabilities it is p(node)."""
    sums = np.zeros(topo.Nn, dtype=np.float64)
    leaves = np.nonzero(topo.nkids == 0)[0]
    leaf_of = {int(n): i for i, n in enumerate(leaves)}
    for i in range(topo.Nn - 1, -1, -1):
        if keep_mask_nodes is not None and not keep_mask_nodes[i]:
            continue
        if topo.nkids[i] == 0:
            sums[i] = leaf_w[leaf_of[i]]
        if i > 0:
            sums[topo.parent[i]] += sums[i]
    return sums


def prune_scenario_tree(qp: TreeQPIn, leaf_probs=None, nscenmax=None,
                        pcov=None):
    """Prune a tree QP to the most likely scenarios.

    ``leaf_probs``: probability per leaf (node order); uniform if None.
    Keeps the smallest top-probability set with at most ``nscenmax`` leaves
    and cumulative probability >= ``pcov`` (whichever binds). Returns
    (pruned TreeQPIn on ``qp``'s device, kept-node index array into the
    original tree).
    """
    topo = qp.topo
    leaves = np.nonzero(topo.nkids == 0)[0]
    n_leaves = len(leaves)
    if leaf_probs is None:
        leaf_probs = np.full(n_leaves, 1.0 / n_leaves)
    leaf_probs = np.asarray(leaf_probs, dtype=np.float64)
    assert len(leaf_probs) == n_leaves

    order = np.argsort(-leaf_probs, kind="stable")
    nmax = nscenmax if nscenmax is not None else n_leaves
    kept_leaf_idx = []
    cum = 0.0
    for li in order:
        if len(kept_leaf_idx) >= nmax:
            break
        kept_leaf_idx.append(li)
        cum += leaf_probs[li]
        # either criterion stops accumulation (whichever binds first)
        if pcov is not None and cum >= pcov:
            break
    kept_leaf_idx = sorted(kept_leaf_idx)
    assert kept_leaf_idx, "pruning removed every scenario"

    keep = np.zeros(topo.Nn, dtype=bool)
    for li in kept_leaf_idx:
        n = int(leaves[li])
        while n >= 0:
            keep[n] = True
            n = topo.parent[n]

    kept_nodes = np.nonzero(keep)[0]
    new_id = -np.ones(topo.Nn, dtype=np.int64)
    new_id[kept_nodes] = np.arange(len(kept_nodes))
    new_parent = [-1] + [int(new_id[topo.parent[n]]) for n in kept_nodes[1:]]
    new_topo = TreeStructure.from_parent(
        new_parent,
        [topo.nx[n] for n in kept_nodes],
        [topo.nu[n] for n in kept_nodes],
        [topo.nc[n] for n in kept_nodes])

    # objective re-normalization: node weights encode p(node); pruning
    # rescales them by the conditional probability share
    # p_kept(node) / (p_orig(node) * p_keep_total) — exact conditional
    # expectation for uniform AND non-uniform leaf probabilities
    orig_under = _subtree_leaf_probsum(topo, leaf_probs)
    kept_under = _subtree_leaf_probsum(topo, leaf_probs, keep)
    p_kept = float(np.sum(leaf_probs[kept_leaf_idx]))
    scale = np.ones(topo.Nn)
    nz = orig_under > 0
    scale[nz] = (kept_under[nz] / orig_under[nz]) / p_kept

    idx = torch.as_tensor(kept_nodes, dtype=torch.long, device=qp.device)
    sc = torch.as_tensor(scale[kept_nodes], dtype=qp.dtype, device=qp.device)
    take = lambda a: a[idx]
    pruned = TreeQPIn(
        Q=take(qp.Q) * sc[:, None, None], R=take(qp.R) * sc[:, None, None],
        S=take(qp.S) * sc[:, None, None],
        q=take(qp.q) * sc[:, None], r=take(qp.r) * sc[:, None],
        xmin=take(qp.xmin), xmax=take(qp.xmax),
        umin=take(qp.umin), umax=take(qp.umax),
        C=take(qp.C), D=take(qp.D), dmin=take(qp.dmin), dmax=take(qp.dmax),
        A=take(qp.A), B=take(qp.B), b=take(qp.b),
        topo=new_topo)
    return pruned, kept_nodes

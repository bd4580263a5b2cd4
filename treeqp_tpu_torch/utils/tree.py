"""Tree topology for tree-structured QPs.

Copied from ``treeqp_tpu/utils/tree.py`` (numpy only, no framework): the
JAX package's module cannot be imported here because importing anything
under ``treeqp_tpu`` runs its ``__init__``, which imports jax. The one
difference is ``from_nkids``, which always takes the pure-Python builder
(the JAX package may use its native C graph builder; both give the same
parent vector).

TPU-native re-design of the reference topology layer
(``treeqp/utils/tree.{h,c}`` — ``struct node`` at tree.h:41-51, ``tree_create``
at tree.c:171-243, ``setup_multistage_tree`` at tree.c:247-280,
``calculate_number_of_nodes`` at tree.c:36-48).

Instead of a linked node structure walked sequentially, we store the topology
as a frozen, hashable dataclass of tuples (so it can ride along a JAX pytree
as static metadata and key jit caches), plus cached numpy index arrays that
turn every per-node loop of the reference into one batched gather/scatter:

* nodes are topologically ordered (``parent[i] < i``),
* per-depth node index lists make level-synchronous sweeps (tree Cholesky,
  tree Riccati) batched per depth,
* the "λ-group" layout groups the dual variables of all children of a parent
  into fixed-size slots (``Kmax`` slots of ``nxm`` entries) so that the dual
  Newton block factorization operates on dense padded ``[num_groups, G, G]``
  batches.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = ["TreeStructure", "number_of_nodes_multistage"]


def number_of_nodes_multistage(md: int, Nr: int, Nh: int) -> int:
    """Node count of a multistage (robust-MPC) tree.

    Mirrors ``calculate_number_of_nodes`` (reference tree.c:36-48):
    branch ``md``-ways for the first ``Nr`` stages, then single chains up to
    horizon ``Nh``.
    """
    if md == 1 or Nr == 0:
        return Nh + 1
    n_branch = (md ** (Nr + 1) - 1) // (md - 1)  # full md-ary tree of depth Nr
    return (Nh - Nr) * md**Nr + n_branch


@dataclasses.dataclass(frozen=True)
class TreeStructure:
    """Static topology + per-node dimensions of a tree QP.

    ``parent[i]`` is the parent node of ``i`` (``parent[0] == -1``); nodes
    must be topologically ordered (``parent[i] < i``). ``nx/nu/nc`` are the
    per-node state/control/general-constraint dimensions (reference
    tree_qp_common.h:88-90 allows these to vary per node).
    """

    parent: tuple
    nx: tuple
    nu: tuple
    nc: tuple

    def __post_init__(self):
        assert len(self.parent) == len(self.nx) == len(self.nu) == len(self.nc)
        assert self.parent[0] == -1
        for i in range(1, self.Nn):
            assert 0 <= self.parent[i] < i, "nodes must be topologically ordered"

    # ------------------------------------------------------------------ sizes

    @property
    def Nn(self) -> int:
        return len(self.parent)

    @cached_property
    def nxm(self) -> int:
        return max(self.nx) if self.Nn else 0

    @cached_property
    def num(self) -> int:
        return max(max(self.nu), 1)

    @cached_property
    def ncm(self) -> int:
        return max(max(self.nc), 1)

    @cached_property
    def nzm(self) -> int:
        return self.nxm + self.num

    # ------------------------------------------------------- derived topology

    @cached_property
    def parent_np(self) -> np.ndarray:
        return np.asarray(self.parent, dtype=np.int32)

    @cached_property
    def nx_np(self) -> np.ndarray:
        return np.asarray(self.nx, dtype=np.int32)

    @cached_property
    def nu_np(self) -> np.ndarray:
        return np.asarray(self.nu, dtype=np.int32)

    @cached_property
    def nc_np(self) -> np.ndarray:
        return np.asarray(self.nc, dtype=np.int32)

    @cached_property
    def stage(self) -> np.ndarray:
        """Depth of each node (root = 0)."""
        st = np.zeros(self.Nn, dtype=np.int32)
        for i in range(1, self.Nn):
            st[i] = st[self.parent[i]] + 1
        return st

    @cached_property
    def Nh(self) -> int:
        """Prediction horizon = maximum stage (reference get_prediction_horizon)."""
        return int(self.stage.max()) if self.Nn > 1 else 0

    @cached_property
    def nkids(self) -> np.ndarray:
        nk = np.zeros(self.Nn, dtype=np.int32)
        for i in range(1, self.Nn):
            nk[self.parent[i]] += 1
        return nk

    @cached_property
    def kids(self) -> tuple:
        """kids[i] = ordered tuple of children of node i."""
        out = [[] for _ in range(self.Nn)]
        for i in range(1, self.Nn):
            out[self.parent[i]].append(i)
        return tuple(tuple(k) for k in out)

    @cached_property
    def sib_index(self) -> np.ndarray:
        """Position of each node among its siblings (reference node.idxkid)."""
        out = np.zeros(self.Nn, dtype=np.int32)
        for p, ks in enumerate(self.kids):
            for j, c in enumerate(ks):
                out[c] = j
        return out

    @cached_property
    def Kmax(self) -> int:
        """Max branching factor — the slot count of the λ-group layout."""
        return int(self.nkids.max()) if self.Nn > 1 else 0

    # ------------------------------------------------- λ-group (parent) layout
    # The dual variables λ_c (one per non-root node c, dim nx[c]) are grouped
    # by parent, following the reference's W-block layout
    # (dual_Newton_tree.c:180-215 idxpos / maximum_hessian_block_dimension).
    # Group g corresponds to the g-th node with children ("parent node"),
    # groups ordered by node index (hence by stage for BFS-ordered trees).

    @cached_property
    def group_nodes(self) -> np.ndarray:
        """Node ids that have children, in node order (W-block owners)."""
        return np.nonzero(self.nkids > 0)[0].astype(np.int32)

    @cached_property
    def num_groups(self) -> int:
        return len(self.group_nodes)

    @cached_property
    def group_of_parent(self) -> np.ndarray:
        """Map node id -> its group index if it is a parent node, else -1."""
        g = -np.ones(self.Nn, dtype=np.int32)
        g[self.group_nodes] = np.arange(self.num_groups, dtype=np.int32)
        return g

    @cached_property
    def group_of_node(self) -> np.ndarray:
        """For node c>0: the group (W-block) its λ_c lives in = group of parent."""
        g = np.zeros(self.Nn, dtype=np.int32)
        g[1:] = self.group_of_parent[self.parent_np[1:]]
        return g

    @cached_property
    def kids_padded(self) -> np.ndarray:
        """[num_groups, Kmax] children node ids, padded with 0 (see kids_valid)."""
        out = np.zeros((self.num_groups, self.Kmax), dtype=np.int32)
        for g, p in enumerate(self.group_nodes):
            ks = self.kids[p]
            out[g, : len(ks)] = ks
        return out

    @cached_property
    def kids_valid(self) -> np.ndarray:
        """[num_groups, Kmax] 1.0 where the slot holds a real child."""
        out = np.zeros((self.num_groups, self.Kmax), dtype=np.float64)
        for g, p in enumerate(self.group_nodes):
            out[g, : len(self.kids[p])] = 1.0
        return out

    @cached_property
    def group_stage(self) -> np.ndarray:
        """Stage of each group's parent node."""
        return self.stage[self.group_nodes]

    @cached_property
    def groups_by_stage(self) -> tuple:
        """groups_by_stage[s] = np.array of group indices whose node is at stage s."""
        out = []
        for s in range(self.Nh):  # parents live at stages 0 .. Nh-1
            out.append(np.nonzero(self.group_stage == s)[0].astype(np.int32))
        return tuple(out)

    # Block-tree structure over groups: group g (parent node p) couples to the
    # group of p's own parent, at slot sib_index[p].
    @cached_property
    def group_dad(self) -> np.ndarray:
        """Group index of the parent-group of each group (-1 for the root group)."""
        out = -np.ones(self.num_groups, dtype=np.int32)
        for g, p in enumerate(self.group_nodes):
            if p != 0:
                out[g] = self.group_of_node[p]
        return out

    @cached_property
    def group_slot(self) -> np.ndarray:
        """Slot of the group's parent node inside its dad group."""
        return self.sib_index[self.group_nodes]

    # ------------------------------------------------------------------ masks

    @cached_property
    def x_mask(self) -> np.ndarray:
        """[Nn, nxm] 1.0 on real state entries."""
        return (np.arange(self.nxm)[None, :] < self.nx_np[:, None]).astype(np.float64)

    @cached_property
    def u_mask(self) -> np.ndarray:
        return (np.arange(self.num)[None, :] < self.nu_np[:, None]).astype(np.float64)

    @cached_property
    def c_mask(self) -> np.ndarray:
        return (np.arange(self.ncm)[None, :] < self.nc_np[:, None]).astype(np.float64)

    @cached_property
    def nonroot_x_mask(self) -> np.ndarray:
        """x_mask with row 0 zeroed — the support of λ / dynamics residuals."""
        m = self.x_mask.copy()
        m[0] = 0.0
        return m

    # ----------------------------------------------------------- constructors

    @classmethod
    def from_parent(cls, parent, nx, nu, nc=None) -> "TreeStructure":
        parent = tuple(int(p) for p in parent)
        nx = tuple(int(v) for v in nx)
        nu = tuple(int(v) for v in nu)
        nc = tuple(int(v) for v in nc) if nc is not None else (0,) * len(parent)
        return cls(parent, nx, nu, nc)

    @classmethod
    def from_nkids(cls, nk, nx, nu, nc=None) -> "TreeStructure":
        """Build from children counts, mirroring ``tree_create`` (tree.c:171-243).

        Children of node i are the next unassigned nodes, giving the same
        BFS / stage-contiguous numbering as the reference.
        """
        Nn = len(nk)
        parent = [-1] * Nn
        next_free = 1
        for i in range(Nn):
            for _ in range(nk[i]):
                assert next_free < Nn, "inconsistent nk vector"
                parent[next_free] = i
                next_free += 1
        assert next_free == Nn, "inconsistent nk vector"
        return cls.from_parent(parent, nx, nu, nc)

    @classmethod
    def multistage(cls, md: int, Nr: int, Nh: int, nx: int, nu: int, nc: int = 0) -> "TreeStructure":
        """Robust-MPC scenario tree (``setup_multistage_tree``, tree.c:247-280).

        Branch ``md``-ways for the first ``Nr`` stages, then chains to ``Nh``.
        Leaves get ``nu = 0`` (reference spring_mass.c:137-147 convention).
        """
        Nn = number_of_nodes_multistage(md, Nr, Nh)
        nk = []
        nodes_in_stage = 1
        for kk in range(Nh):
            nk += [md if kk < Nr else 1] * nodes_in_stage
            nodes_in_stage *= md if kk < Nr else 1
        nk += [0] * nodes_in_stage
        assert len(nk) == Nn
        nxs = [nx] * Nn
        nus = [nu if k > 0 else 0 for k in nk]
        ncs = [nc] * Nn
        return cls.from_nkids(nk, nxs, nus, ncs)

    @cached_property
    def realization(self) -> np.ndarray:
        """LTI realization index per node (reference node.real, tree.c:224-240).

        Children of a branching node get 0..md-1; chain children inherit.
        """
        real = -np.ones(self.Nn, dtype=np.int32)
        for p, ks in enumerate(self.kids):
            for j, c in enumerate(ks):
                if len(ks) > 1:
                    real[c] = j
                else:
                    real[c] = real[p] if p > 0 else 0
        return real

    # --------------------------------------------------- multistage structure

    @cached_property
    def multistage_params(self):
        """Detect (md, Nr, Nh) if this is a multistage scenario tree
        (crown branching md for Nr stages, then chains to Nh); else None.

        The scenario-sharded solver requires this shape: S = md**Nr chains of
        length Nh - Nr >= 1 hanging off the stage-Nr crown nodes.
        """
        if self.Nn <= 1:
            return None
        nk = self.nkids
        st = self.stage
        Nh = self.Nh
        md = int(nk[0])
        if md < 1:
            return None
        # Nr = last stage whose nodes all branch md ways
        Nr = 0
        for s in range(Nh):
            nodes = np.nonzero(st == s)[0]
            if np.all(nk[nodes] == md) and md > 1:
                Nr = s + 1
            else:
                break
        if Nr == 0 and md == 1:
            Nr = 0  # pure chain
        # remaining stages must be chains (nkids == 1, then 0 at Nh)
        for s in range(Nr, Nh):
            nodes = np.nonzero(st == s)[0]
            if not np.all(nk[nodes] == 1):
                return None
        if not np.all(nk[np.nonzero(st == Nh)[0]] == 0):
            return None
        if Nh <= Nr:  # need chains of length >= 1
            return None
        # uniform dims along chains required for the [S, L] layout
        chain_nodes = np.nonzero(st > Nr)[0]
        if len(set(self.nx[i] for i in chain_nodes)) > 1:
            return None
        return md, Nr, Nh

    @cached_property
    def stage_start(self) -> np.ndarray:
        """First node id of each stage (nodes are stage-contiguous for
        from_nkids/multistage construction)."""
        st = self.stage
        starts = np.zeros(self.Nh + 2, dtype=np.int32)
        for s in range(1, self.Nh + 1):
            starts[s] = int(np.searchsorted(st, s))
        starts[self.Nh + 1] = self.Nn
        return starts

    def __hash__(self):
        return hash((self.parent, self.nx, self.nu, self.nc))

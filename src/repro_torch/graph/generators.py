"""Synthetic graph generators (numpy, host-side data pipeline).

Mirrors the paper's dataset families (Table III): power-law web/social
graphs (R-MAT), chains, random rooted trees, road-network-like grids, and
weighted power-law graphs for MSF.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class EdgeList:
    """A host-side graph: n vertices, edges (E, 2) int64, optional weights."""

    n: int
    edges: np.ndarray  # (E, 2) int64 (src, dst)
    weights: Optional[np.ndarray] = None  # (E,) float32
    directed: bool = True
    name: str = "graph"

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    def symmetrized(self) -> "EdgeList":
        """Undirected view: both directions present, self-loops removed."""
        e = self.edges
        w = self.weights
        rev = e[:, ::-1]
        edges = np.concatenate([e, rev], axis=0)
        weights = None if w is None else np.concatenate([w, w], axis=0)
        return dedup(EdgeList(self.n, edges, weights, directed=False,
                              name=self.name + "+sym"))

    def reversed(self) -> "EdgeList":
        return EdgeList(self.n, self.edges[:, ::-1].copy(), self.weights,
                        self.directed, self.name + "+rev")


def dedup(g: EdgeList) -> EdgeList:
    """Remove duplicate edges and self-loops (keeping min weight)."""
    e = g.edges
    keep = e[:, 0] != e[:, 1]
    e = e[keep]
    w = None if g.weights is None else g.weights[keep]
    key = e[:, 0] * np.int64(g.n) + e[:, 1]
    order = np.argsort(key, kind="stable")
    key, e = key[order], e[order]
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    if w is not None:
        w = np.minimum.reduceat(w[order], np.flatnonzero(first)) if len(key) else w
    return EdgeList(g.n, e[first], w, g.directed, g.name)


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    weighted: bool = False,
    directed: bool = True,
) -> EdgeList:
    """R-MAT power-law graph: n = 2**scale, E = n * edge_factor."""
    n = 1 << scale
    e = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(e, dtype=np.int64)
    dst = np.zeros(e, dtype=np.int64)
    for level in range(scale):
        r = rng.random(e)
        # quadrant probabilities (a, b, c, d)
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src = (src << 1) | go_down.astype(np.int64)
        dst = (dst << 1) | go_right.astype(np.int64)
    edges = np.stack([src, dst], axis=1)
    w = rng.random(e).astype(np.float32) if weighted else None
    g = dedup(EdgeList(n, edges, w, directed, name=f"rmat{scale}"))
    return g


def chain(n: int, directed: bool = False) -> EdgeList:
    """Path graph 0-1-...-(n-1); the paper's worst case for propagation."""
    i = np.arange(n - 1, dtype=np.int64)
    edges = np.stack([i, i + 1], axis=1)
    g = EdgeList(n, edges, None, directed, name=f"chain{n}")
    return g if directed else g.symmetrized()


def parent_chain(n: int, seed: int = 0, shuffle: bool = True) -> np.ndarray:
    """Pointer-jumping input: parents forming one long chain (D[i] = i-1
    under a random relabeling). Returns parent array (n,)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n) if shuffle else np.arange(n)
    par = np.empty(n, dtype=np.int64)
    par[perm[0]] = perm[0]
    par[perm[1:]] = perm[:-1]
    return par


def random_tree_parents(n: int, seed: int = 0) -> np.ndarray:
    """Random recursive tree parents (vertex i attaches to U[0, i))."""
    rng = np.random.default_rng(seed)
    par = np.zeros(n, dtype=np.int64)
    if n > 1:
        par[1:] = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    perm = rng.permutation(n)
    out = np.empty(n, dtype=np.int64)
    out[perm] = perm[par]
    return out


def random_tree(n: int, seed: int = 0) -> EdgeList:
    """Random rooted tree as an edge list child->parent (directed)."""
    par = random_tree_parents(n, seed)
    v = np.arange(n, dtype=np.int64)
    keep = par != v
    edges = np.stack([v[keep], par[keep]], axis=1)
    return EdgeList(n, edges, None, True, name=f"tree{n}")


def grid2d(side: int, directed: bool = False) -> EdgeList:
    """side x side grid — road-network stand-in (large diameter, low degree)."""
    n = side * side
    idx = np.arange(n, dtype=np.int64).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    edges = np.concatenate([right, down], axis=0)
    g = EdgeList(n, edges, None, directed, name=f"grid{side}x{side}")
    return g if directed else g.symmetrized()


def uniform_random(n: int, e: int, seed: int = 0, weighted: bool = False,
                   directed: bool = True) -> EdgeList:
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2), dtype=np.int64)
    w = rng.random(e).astype(np.float32) if weighted else None
    return dedup(EdgeList(n, edges, w, directed, name=f"rand{n}"))


def components_ground_truth(g: EdgeList) -> np.ndarray:
    """Connected-component labels, each vertex's smallest vertex id in its
    component (oracle for WCC/S-V tests): scipy's ``connected_components``
    over the edges taken as undirected, every component then named by its
    first vertex."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    e = np.asarray(g.edges, dtype=np.int64).reshape(-1, 2)
    adj = coo_matrix((np.ones(len(e), np.float32), (e[:, 0], e[:, 1])),
                     shape=(g.n, g.n)).tocsr()
    _, comp = connected_components(adj, directed=False)
    # np.unique's first index of each component number: its smallest vertex
    _, first = np.unique(comp, return_index=True)
    return first[comp].astype(np.int64)

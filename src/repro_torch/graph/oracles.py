"""Host-side (numpy, and scipy for the MSF) oracles for algorithm tests."""
from __future__ import annotations

import numpy as np

from repro_torch.graph.generators import EdgeList


def pagerank_oracle(g: EdgeList, iters: int = 20, damping: float = 0.85):
    n = g.n
    out_deg = np.zeros(n, np.int64)
    np.add.at(out_deg, g.edges[:, 0], 1)
    pr = np.full(n, 1.0 / n)
    src, dst = g.edges[:, 0], g.edges[:, 1]
    for _ in range(iters):
        contrib = np.where(out_deg > 0, pr / np.maximum(out_deg, 1), 0.0)
        incoming = np.zeros(n)
        np.add.at(incoming, dst, contrib[src])
        sink = pr[out_deg == 0].sum()
        pr = (1 - damping) / n + damping * (incoming + sink / n)
    return pr


def personalized_pagerank_oracle(g: EdgeList, source: int, iters: int = 20,
                                 damping: float = 0.85):
    """Personalized PageRank: teleport and sink mass go to ``source``."""
    n = g.n
    out_deg = np.zeros(n, np.int64)
    np.add.at(out_deg, g.edges[:, 0], 1)
    e = np.zeros(n)
    e[source] = 1.0
    pr = e.copy()
    src, dst = g.edges[:, 0], g.edges[:, 1]
    for _ in range(iters):
        contrib = np.where(out_deg > 0, pr / np.maximum(out_deg, 1), 0.0)
        incoming = np.zeros(n)
        np.add.at(incoming, dst, contrib[src])
        sink = pr[out_deg == 0].sum()
        pr = (1 - damping) * e + damping * (incoming + sink * e)
    return pr


def sssp_oracle(g: EdgeList, source: int):
    """Bellman-Ford (weights default 1)."""
    n = g.n
    w = g.weights if g.weights is not None else np.ones(len(g.edges), np.float32)
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    src, dst = g.edges[:, 0], g.edges[:, 1]
    for _ in range(n):
        new = dist.copy()
        np.minimum.at(new, dst, dist[src] + w)
        if np.array_equal(
            new, dist, equal_nan=True
        ) or np.all((new == dist) | (np.isinf(new) & np.isinf(dist))):
            break
        dist = new
    return dist


def scc_oracle(g: EdgeList) -> np.ndarray:
    """Kosaraju SCC labels (min vertex id per SCC), iterative."""
    n = g.n
    adj = [[] for _ in range(n)]
    radj = [[] for _ in range(n)]
    for s, d in g.edges:
        adj[s].append(int(d))
        radj[d].append(int(s))
    visited = np.zeros(n, bool)
    order = []
    for s in range(n):
        if visited[s]:
            continue
        stack = [(s, 0)]
        visited[s] = True
        while stack:
            u, i = stack[-1]
            if i < len(adj[u]):
                stack[-1] = (u, i + 1)
                v = adj[u][i]
                if not visited[v]:
                    visited[v] = True
                    stack.append((v, 0))
            else:
                order.append(u)
                stack.pop()
    label = np.full(n, -1, np.int64)
    for s in reversed(order):
        if label[s] >= 0:
            continue
        comp = [s]
        label[s] = s
        while comp:
            u = comp.pop()
            for v in radj[u]:
                if label[v] < 0:
                    label[v] = s
                    comp.append(v)
    # canonicalize to min id per SCC
    mins = {}
    for v in range(n):
        mins[label[v]] = min(mins.get(label[v], n), v)
    return np.array([mins[label[v]] for v in range(n)], np.int64)


def msf_weight_oracle(g: EdgeList) -> float:
    """Total weight of the minimum spanning forest: each vertex pair's
    lightest edge (self-loops dropped), scipy's ``minimum_spanning_tree``
    over those. The weights are shifted to start at 1 first (scipy reads a
    0 as no edge; every spanning forest of a graph has the same number of
    edges, so the shift picks the same forest) and the shift is taken off
    the total."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree

    assert g.weights is not None
    e = np.asarray(g.edges, dtype=np.int64).reshape(-1, 2)
    w = np.asarray(g.weights, dtype=np.float64)
    lo, hi = e.min(axis=1), e.max(axis=1)
    keep = lo != hi
    lo, hi, w = lo[keep], hi[keep], w[keep]
    if not len(w):
        return 0.0
    order = np.lexsort((w, hi, lo))  # by pair, lightest first
    lo, hi, w = lo[order], hi[order], w[order]
    first = np.ones(len(w), dtype=bool)
    first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    shift = 1.0 - float(w.min())
    tree = minimum_spanning_tree(coo_matrix(
        (w[first] + shift, (lo[first], hi[first])), shape=(g.n, g.n)).tocsr())
    return float(tree.data.sum() - shift * tree.nnz)

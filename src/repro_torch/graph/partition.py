"""Vertex partitioners.

A partitioner returns a relabeling permutation ``new_of_old`` such that
worker(v) = new_of_old[v] // n_loc (contiguous block ownership in the new
id space). Because ownership is by contiguous block, a partitioner never
chooses *how many* vertices a worker owns — the block sizes are fixed by
(n, n_workers, align) — only *which* vertices co-reside:

  - ``block`` / ``random``: the degree-blind baselines (identity order and
    a uniform shuffle). On power-law inputs both concentrate hub edge mass
    on whichever worker draws the hubs, which inflates every per-worker
    plan cap (caps are maxima over workers).
  - ``bfs_blocks``: locality order (METIS stand-in used for the paper's
    "Wikipedia (P)" partitioned experiments) — consecutive BFS ids land on
    the same worker.
  - ``degree``: degree-aware balance — greedy longest-processing-time
    assignment on the degree-sorted vertex order, so each worker's block
    carries ~equal total degree. This is the R-MAT/power-law regime fix:
    the handful of super-hubs are dealt to distinct workers first, then
    the tail fills the blocks back to level. Pairs with hub mirroring
    (``pgraph.partition_graph(mirror_threshold=...)``).
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.graph.generators import EdgeList


def _block_sizes(n: int, n_workers: int, align: int = 8):
    """The fixed contiguous-block capacity of every worker — must mirror
    ``pgraph.partition_graph``'s ``n_loc = round_up(ceil(n/W), align)``
    (same ``align`` default)."""
    n_loc = (-(-n // n_workers) + align - 1) // align * align
    return n_loc, [max(0, min(n_loc, n - w * n_loc)) for w in range(n_workers)]


def block(g: EdgeList, n_workers: int, seed: int = 0) -> np.ndarray:
    return np.arange(g.n, dtype=np.int64)


def random(g: EdgeList, n_workers: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.n).astype(np.int64)
    return perm


def degrees(g: EdgeList) -> np.ndarray:
    """(n,) total degree (out + in) — the per-vertex communication mass a
    partitioner should balance."""
    deg = np.zeros(g.n, np.int64)
    e = g.edges
    if len(e):
        deg += np.bincount(e[:, 0], minlength=g.n)
        deg += np.bincount(e[:, 1], minlength=g.n)
    return deg


def degree(g: EdgeList, n_workers: int, seed: int = 0) -> np.ndarray:
    """Degree-aware blocks: greedy LPT over the degree-sorted vertices.

    Vertices are visited in descending total-degree order; each goes to
    the least-loaded worker that still has block slots free (load = total
    degree assigned so far). The block counts are fixed (contiguous
    ownership), so the only freedom — which vertices co-reside — is spent
    leveling degree mass: on R-MAT the few super-hubs land on distinct
    workers before the power-law tail refills the blocks evenly, keeping
    every per-worker plan cap (``e_cap`` / ``slot_cap`` / the routed
    ``route_cap``) near the mean instead of the hub-induced max.
    Deterministic (ties break by vertex id; ``seed`` is unused).
    """
    n, W = g.n, n_workers
    deg = degrees(g)
    n_loc, caps = _block_sizes(n, W)
    order = np.argsort(-deg, kind="stable")  # hubs first, ties by id

    assign = np.empty(n, np.int64)
    fill = [0] * W
    heap = [(0, w) for w in range(W) if caps[w]]
    heapq.heapify(heap)
    for v in order:
        load, w = heapq.heappop(heap)
        assign[v] = w
        fill[w] += 1
        if fill[w] < caps[w]:
            heapq.heappush(heap, (load + int(deg[v]) + 1, w))

    # within a block keep ascending old-id order (locality-neutral,
    # stable); the blocks tile [0, n) exactly (only the last non-empty
    # block is partial), so this is a permutation of [0, n)
    new_of_old = np.empty(n, np.int64)
    for w in range(W):
        mine = np.flatnonzero(assign == w)
        new_of_old[mine] = w * n_loc + np.arange(len(mine))
    return new_of_old


def bfs_blocks(g: EdgeList, n_workers: int, seed: int = 0) -> np.ndarray:
    """Locality-preserving order: BFS visit order over the undirected view.

    Consecutive BFS ids land on the same worker, so partition-internal
    subgraphs are connected-ish — the property the propagation channel
    exploits (paper §IV-C3, 'users should preprocess the graph by tagging
    a partition ID').

    The BFS is a vectorized level-synchronous frontier sweep over the CSR
    arrays (gather all frontier adjacencies at once, first-occurrence
    dedup) — the interpreter-bound deque version took minutes at scale
    >= 18, which blocked the weak-scaling sweeps.
    """
    n = g.n
    # build undirected CSR
    e = g.edges
    both = np.concatenate([e, e[:, ::-1]], axis=0)
    order = np.argsort(both[:, 0], kind="stable")
    both = both[order]
    offsets = np.searchsorted(both[:, 0], np.arange(n + 1))
    nbrs = both[:, 1]

    visited = np.zeros(n, bool)
    visit_order = np.empty(n, np.int64)
    nxt = 0
    rng = np.random.default_rng(seed)
    start_order = rng.permutation(n)

    for s in start_order:
        if visited[s]:
            continue
        frontier = np.array([s], dtype=np.int64)
        visited[s] = True
        while frontier.size:
            visit_order[nxt:nxt + frontier.size] = frontier
            nxt += frontier.size
            # gather every frontier vertex's adjacency range in one shot
            starts = offsets[frontier]
            cnts = offsets[frontier + 1] - starts
            total = int(cnts.sum())
            if not total:
                break
            base = np.repeat(starts - np.concatenate(([0], np.cumsum(cnts)[:-1])), cnts)
            cand = nbrs[base + np.arange(total)]
            cand = cand[~visited[cand]]
            if not cand.size:
                break
            # first-occurrence dedup keeps the deque visit order
            # (parent order major, adjacency order minor)
            _, first = np.unique(cand, return_index=True)
            frontier = cand[np.sort(first)]
            visited[frontier] = True
    assert nxt == n
    new_of_old = np.empty(n, np.int64)
    new_of_old[visit_order] = np.arange(n, dtype=np.int64)
    return new_of_old


PARTITIONERS = {
    "block": block,
    "random": random,
    "bfs": bfs_blocks,
    "degree": degree,
}

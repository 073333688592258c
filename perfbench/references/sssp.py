"""Single-source shortest paths, plainly, in float64: Bellman-Ford over
every edge until no distance moves; unreachable vertices stay infinite.
"""
from __future__ import annotations

import math

import torch


def distances(graph, root: int, dtype=torch.float64):
    w = graph.weight.to(dtype)
    dist = torch.full((graph.n,), math.inf, dtype=dtype,
                      device=graph.src.device)
    dist[root] = 0
    while True:
        new = dist.scatter_reduce(0, graph.dst, dist[graph.src] + w, "amin")
        if torch.equal(new, dist):
            return dist
        dist = new


def reference(graph, query, knobs):
    return distances(graph, query)


def control(graph, query, knobs):
    """The same relaxation in bfloat16, the precision below the float32
    the configuration's weights and distances are in."""
    return distances(graph, query, torch.bfloat16).float().cpu().numpy()


def compare(graph, got, want) -> dict:
    """``reach_mismatch``: vertices reachable on one side only;
    ``dist_rel_gap``: the largest |got - want| / want over vertices both
    reach (the root's own gap is |got|)."""
    got = torch.as_tensor(got, device=want.device).to(want.dtype)
    inf_got, inf_want = torch.isinf(got), torch.isinf(want)
    both = ~inf_got & ~inf_want
    gap = (got - want).abs()[both] / torch.where(want > 0, want, 1.0)[both]
    return {"reach_mismatch": int((inf_got != inf_want).sum()),
            "dist_rel_gap": float(gap.max()) if gap.numel() else 0.0}

"""PageRank, plainly, in float64: ``iters`` rounds from 1/n on every
vertex; each round a vertex sends its rank over its out-degree to each
out-neighbour, the rank of vertices without out-edges is spread over all
n, and ``pr = (1 - damping) / n + damping * (incoming + sink / n)``.
"""
from __future__ import annotations

import torch


def ranks(graph, iters: int, damping: float, dtype=torch.float64):
    n, src, dst = graph.n, graph.src, graph.dst
    deg = torch.bincount(src, minlength=n).to(dtype)
    sink = deg == 0
    pr = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    for _ in range(iters):
        contrib = torch.where(sink, 0.0, pr / deg.clamp(min=1))
        inc = torch.zeros_like(pr).index_add_(0, dst, contrib[src])
        lost = pr[sink].sum()
        pr = (1 - damping) / n + damping * (inc + lost / n)
    return pr


def reference(graph, query, knobs):
    return ranks(graph, knobs["iters"], knobs["damping"])


def control(graph, query, knobs):
    """The same rounds in bfloat16, the precision below the float32 the
    configuration's ranks are in."""
    return ranks(graph, knobs["iters"], knobs["damping"],
                 torch.bfloat16).float().cpu().numpy()


def compare(graph, got, want) -> dict:
    """``rank_rel_gap``: the largest |got - want| / want over vertices
    (every rank is at least (1 - damping) / n)."""
    got = torch.as_tensor(got, device=want.device).to(want.dtype)
    return {"rank_rel_gap": float(((got - want).abs() / want).max())}

"""Connected components, plainly: every vertex's label is the smallest
vertex id of its component (minimum-label propagation over the symmetric
edge list, each round followed by pointer jumping, until no label moves).

An answer is judged by the partition it names: two vertices share a label
in the answer exactly where they share one here. Labels themselves may be
any ids (the program's are ids in its own relabelled space).
"""
from __future__ import annotations

from typing import Optional

import torch


def labels(graph, max_rounds: Optional[int] = None):
    """(labels (n,) int64 on the graph's device, rounds that moved a
    label); ``max_rounds`` stops the propagation early."""
    lab = torch.arange(graph.n, device=graph.src.device)
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = lab.scatter_reduce(0, graph.dst, lab[graph.src], "amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            break
        lab = new
        rounds += 1
    return lab, rounds


def canonical(lab: torch.Tensor) -> torch.Tensor:
    """Each vertex's label replaced by the first vertex that carries it,
    so two labellings of one partition read the same."""
    _, inv = torch.unique(lab.long(), return_inverse=True)
    first = torch.full_like(inv, inv.numel())
    first.scatter_reduce_(0, inv, torch.arange(inv.numel(),
                                               device=inv.device), "amin")
    return first[inv]


def reference(graph, query, knobs):
    return canonical(labels(graph)[0])


def control(graph, query, knobs):
    """The guarantee broken: propagation stopped one round before it
    settles (the answer of a run that halts a superstep early)."""
    _, rounds = labels(graph)
    return labels(graph, max_rounds=max(rounds - 1, 0))[0].cpu().numpy()


def compare(graph, got, want) -> dict:
    """``label_mismatch``: vertices whose component differs."""
    got = torch.as_tensor(got, device=want.device)
    return {"label_mismatch": int((canonical(got) != want).sum())}

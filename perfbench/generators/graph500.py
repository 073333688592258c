"""The Graph500 Kronecker generator, on the device from the run's seed.

The specification's generator (its reference code, ``kronecker_generator``):
``M = edgefactor * 2^scale`` edges, each placed by ``scale`` independent
choices of a quadrant of the adjacency matrix with probabilities A, B,
C and D = 1 - A - B - C; then the vertex labels are permuted at random
and the edge list shuffled. Weights, where the configuration asks for
them, are the SSSP kernel's: uniform in [0, 1), one a generated edge.

The configuration says whether the graph is symmetrised (both directions
of every edge, self-loops removed, duplicates merged, the smallest weight
of a duplicated pair kept) and how many search roots a set holds: the
specification draws them among the vertices of nonzero degree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from perfbench import yardstick


@dataclasses.dataclass
class Graph:
    """An edge list on the device: ``n`` vertices, ``src``/``dst`` (E,)
    int64, ``weight`` (E,) float32 or None."""

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    weight: Optional[torch.Tensor]
    symmetric: bool

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())

    def out_degree(self) -> torch.Tensor:
        return torch.bincount(self.src, minlength=self.n)


def kronecker_bits(scale: int, edgefactor: int, a: float, b: float,
                   c: float, gen: torch.Generator, device) -> tuple:
    """(src, dst) int64 of the ``edgefactor * 2^scale`` generated edges
    before relabelling: at every bit, (src, dst) = (0, 0), (0, 1), (1, 0),
    (1, 1) with probabilities A, B, C, 1 - A - B - C."""
    m = edgefactor << scale
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        jj = torch.rand(m, generator=gen, device=device) > torch.where(
            ii, c_norm, a_norm)
        src |= ii.to(torch.int64) << bit
        dst |= jj.to(torch.int64) << bit
    return src, dst


def kronecker(scale: int, edgefactor: int, a: float, b: float, c: float,
              gen: torch.Generator, device) -> tuple:
    """(src, dst) int64 of the ``edgefactor * 2^scale`` generated edges,
    labels permuted and edges shuffled as the specification's code does."""
    n, m = 1 << scale, edgefactor << scale
    src, dst = kronecker_bits(scale, edgefactor, a, b, c, gen, device)
    perm = torch.randperm(n, generator=gen, device=device)
    src, dst = perm[src], perm[dst]
    order = torch.randperm(m, generator=gen, device=device)
    return src[order], dst[order]


def symmetrised(n: int, src, dst, weight):
    """Both directions of every edge, self-loops removed, each (src, dst)
    once, sorted by (src, dst); a duplicated pair keeps its smallest
    weight, so both directions of an undirected edge weigh the same."""
    s, d = torch.cat([src, dst]), torch.cat([dst, src])
    keep = s != d
    key = s[keep] * n + d[keep]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    w = None
    if weight is not None:
        w = torch.full((uniq.numel(),), float("inf"), dtype=weight.dtype,
                       device=weight.device).scatter_reduce_(
            0, inv, torch.cat([weight, weight])[keep], "amin")
    return uniq // n, uniq % n, w


def make(config: dict, seed: int, device) -> Graph:
    """The configuration's graph, the same for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(yardstick.substream(seed, 1))
    src, dst = kronecker(config["scale"], config["edgefactor"], config["A"],
                         config["B"], config["C"], gen, device)
    n = 1 << config["scale"]
    weight = None
    if config["weights"] == "uniform01":
        weight = torch.rand(src.numel(), generator=gen, device=device,
                            dtype=torch.float32)
    elif config["weights"] is not None:
        raise ValueError(f"unknown weights {config['weights']!r}")
    if not config["symmetric"]:
        raise ValueError("only symmetrised Graph500 graphs are configured")
    src, dst, weight = symmetrised(n, src, dst, weight)
    return Graph(n, src, dst, weight, True)


def roots(graph: Graph, count: int, seed: int) -> list:
    """``count`` distinct vertices of nonzero degree, drawn from
    ``seed`` (one set of the specification's search keys)."""
    cand = torch.nonzero(graph.out_degree() > 0).flatten()
    if cand.numel() < count:
        raise ValueError(f"{count} roots asked, {cand.numel()} vertices "
                         "have an edge")
    gen = torch.Generator(device=cand.device)
    gen.manual_seed(seed)
    pick = torch.randperm(cand.numel(), generator=gen,
                          device=cand.device)[:count]
    return cand[pick].tolist()

#!/usr/bin/env python3
"""Count tied edge weights in the MSF programs' registry graphs.

    PYTHONPATH=src python scripts/msf_weight_ties.py --scales 7,12,16

Boruvka assumes unique weights. The registry recipe of ``msf:*``
(``rmat(scale, 4, seed=9, weighted=True).symmetrized()``) draws float64
uniforms and stores them as float32, so weights collide as the graph
grows. For each scale this prints the undirected edges, the weight
values that two or more undirected edges share, and the edges that
share their weight with another. Host-only (numpy); no device.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.algorithms import REGISTRY


def weight_ties(graph) -> dict:
    """Undirected edges, weight values shared by two or more of them, and
    the edges holding such a value."""
    und = graph.edges[:, 0] < graph.edges[:, 1]
    _, counts = np.unique(graph.weights[und], return_counts=True)
    return dict(undirected_edges=int(und.sum()),
                shared_values=int((counts > 1).sum()),
                edges_sharing=int(counts[counts > 1].sum()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scales", default="7,12,16")
    args = ap.parse_args(argv)
    spec = REGISTRY["msf:channels"]
    for scale in (int(s) for s in args.scales.split(",")):
        ties = weight_ties(spec.make_graph(scale, 0))
        print(f"scale {scale}: {ties['undirected_edges']} undirected edges, "
              f"{ties['shared_values']} weight values shared by two or more, "
              f"{ties['edges_sharing']} edges sharing their weight")


if __name__ == "__main__":
    main()

"""The port's algorithm registry: ``"algorithm:variant"`` → program
factory plus its problem recipe, as in ``repro.algorithms``, for the
programs ported so far (``wcc:basic``, ``pagerank:scatter``).

    from repro_torch.algorithms import REGISTRY, get_program
    spec = REGISTRY["pagerank:scatter"]
    prog = get_program("pagerank:scatter", iters=10)

The recipes (default graphs, oracle checks) are the JAX registry's. The
``wcc:basic`` recipe builds ``("scatter_out", "raw_out")``: the JAX one
also builds ``prop_out``, which the port has not yet, and which neither
the program nor ``route_cap`` depends on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.algorithms import pagerank, wcc
from repro_torch.graph import generators as gen, oracles
from repro_torch.pregel.program import VertexProgram


def _canon(x):
    first: Dict[Any, int] = {}
    return np.array([first.setdefault(v, i) for i, v in enumerate(x)])


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One registry entry: a program factory plus its problem recipe.

    factory: ``factory(**knobs) -> VertexProgram`` (variant pre-bound).
    build: the ``partition_graph(build=...)`` plans the program needs.
    make_graph: ``(scale, seed) -> EdgeList`` default problem graph.
    check: ``(graph, pg, res, inputs) -> None`` — asserts a run's
      ``res.output`` against the host oracle.
    """

    key: str
    algorithm: str
    variant: str
    factory: Callable[..., VertexProgram]
    build: Tuple[str, ...]
    make_graph: Callable[[int, int], gen.EdgeList]
    check: Optional[Callable] = None


def _sym_rmat(scale, seed):
    return gen.rmat(scale, edge_factor=4, seed=2 + seed).symmetrized()


def _directed_rmat(scale, seed):
    return gen.rmat(scale, edge_factor=4, seed=2 + seed)


def _check_components(graph, pg, res, inputs=None):
    truth = gen.components_ground_truth(graph)
    np.testing.assert_array_equal(_canon(res.output), _canon(truth))


def _check_pagerank(graph, pg, res, inputs=None):
    want = oracles.pagerank_oracle(graph, iters=res.steps)
    np.testing.assert_allclose(res.output, want, rtol=1e-4, atol=1e-7)


def _bind(program_fn, variant):
    return lambda **kw: program_fn(variant=variant, **kw)


REGISTRY: Dict[str, ProgramSpec] = {
    "wcc:basic": ProgramSpec(
        key="wcc:basic", algorithm="wcc", variant="basic",
        factory=_bind(wcc.program, "basic"),
        build=("scatter_out", "raw_out"),
        make_graph=_sym_rmat, check=_check_components),
    "pagerank:scatter": ProgramSpec(
        key="pagerank:scatter", algorithm="pagerank", variant="scatter",
        factory=_bind(pagerank.program, "scatter"),
        build=("scatter_out", "raw_out"),
        make_graph=_directed_rmat, check=_check_pagerank),
}


def resolve(name: str) -> ProgramSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown or not yet ported program {name!r}; ported: "
            f"{', '.join(sorted(REGISTRY))}") from None


def get_program(key: str, **knobs) -> VertexProgram:
    """The registered program ``key`` built with ``knobs`` (no compile
    cache to share in the port, so no memo)."""
    return resolve(key).factory(**knobs)

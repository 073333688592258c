"""The port's algorithm registry: ``"algorithm:variant"`` → program
factory plus its problem recipe, as in ``repro.algorithms``: all 21 JAX
registry programs (``wcc:basic``/``prop``/``switch``,
``pagerank:basic``/``scatter``/``personal``, ``reach:basic``,
``sssp:basic``/``prop``, the six ``sv`` variants, ``pj:basic``/
``reqresp``, ``msf:channels``/``monolithic`` and ``scc:basic``/``prop``).

    from repro_torch.algorithms import REGISTRY, get_program
    spec = REGISTRY["pagerank:scatter"]
    prog = get_program("pagerank:scatter", iters=10)

The recipes (default graphs, built plans, problem inputs, query batches,
oracle checks) are the JAX registry's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.algorithms import (msf, pagerank, pointer_jumping,
                                    reachability, scc, sssp, sv, wcc)
from repro_torch.graph import generators as gen, oracles
from repro_torch.graph.pgraph import PLANS as ALL_PLANS
from repro_torch.pregel.program import VertexProgram
from repro_torch.pregel.serve import poisson_arrivals


def _canon(x):
    first: Dict[Any, int] = {}
    return np.array([first.setdefault(v, i) for i, v in enumerate(x)])


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One registry entry: a program factory plus its problem recipe.

    factory: ``factory(**knobs) -> VertexProgram`` (variant pre-bound).
    build: the ``partition_graph(build=...)`` plans the program needs.
    make_graph: ``(scale, seed) -> EdgeList`` default problem graph.
    make_inputs: optional ``(graph, seed) -> knobs`` problem inputs that
      must reach the factory (e.g. a SSSP source).
    check: ``(graph, pg, res, inputs) -> None`` — asserts a run's
      ``res.output`` against the host oracle.
    make_queries: optional ``(graph, seed, q) -> list`` of Q query values
      for the program's query axis (``Engine.run_batch``) — set iff the
      factory's programs declare ``query_init``.
    query_knob: the factory knob one query value binds to (e.g.
      ``"source"``) — how a batched query is replayed as a solo run.
    channel_class: ``"static"`` (plan-driven channels) or ``"routed"``
      (bucket-routed channels, the ones the batched plane shares one
      union route pass across).
    test_scale: graph scale the tests default to.
    """

    key: str
    algorithm: str
    variant: str
    factory: Callable[..., VertexProgram]
    build: Tuple[str, ...]
    make_graph: Callable[[int, int], gen.EdgeList]
    make_inputs: Optional[Callable] = None
    check: Optional[Callable] = None
    make_queries: Optional[Callable] = None
    query_knob: Optional[str] = None
    channel_class: str = "static"
    test_scale: int = 8

    def inputs(self, graph: gen.EdgeList, seed: int = 0) -> Dict[str, Any]:
        return dict(self.make_inputs(graph, seed)) if self.make_inputs else {}

    def queries(self, graph: gen.EdgeList, seed: int = 0,
                q: int = 8) -> list:
        if self.make_queries is None:
            raise ValueError(f"{self.key} has no query axis")
        return list(self.make_queries(graph, seed, q))

    def stream(self, graph: gen.EdgeList, seed: int = 0, q: int = 8,
               rate: float = 1.0) -> list:
        """A serving workload for the program's query axis:
        ``(arrival_superstep, query)`` pairs — :meth:`queries` zipped with
        a seeded Poisson arrival process at ``rate`` expected arrivals a
        superstep. Feed it to ``QueryQueue.from_schedule`` /
        ``Engine.serve``."""
        return list(zip(poisson_arrivals(q, rate, seed),
                        self.queries(graph, seed, q)))


def _sym_rmat(scale, seed):
    return gen.rmat(scale, edge_factor=4, seed=2 + seed).symmetrized()


def _directed_rmat(scale, seed):
    return gen.rmat(scale, edge_factor=4, seed=2 + seed)


def _weighted_rmat(scale, seed):
    return gen.rmat(scale, edge_factor=4, seed=5 + seed, weighted=True)


def _weighted_sym_rmat(scale, seed):
    return gen.rmat(scale, edge_factor=4, seed=9 + seed,
                    weighted=True).symmetrized()


def _scc_rmat(scale, seed):
    return gen.rmat(scale, edge_factor=3, seed=7 + seed)


def _forest_graph(scale, seed):
    n = 1 << scale
    return gen.EdgeList(n, np.zeros((0, 2), np.int64), None, True, "pj")


def _forest_inputs(graph, seed):
    return {"parents": gen.random_tree_parents(graph.n, seed=1 + seed)}


def _random_sources(graph, seed, q):
    """Q distinct source vertices — the default query batch (landmark
    distances / reachability fan-out)."""
    rng = np.random.default_rng(33 + seed)
    return rng.choice(graph.n, size=min(q, graph.n),
                      replace=False).astype(int).tolist()


def _forest_queries(graph, seed, q):
    """Q distinct random forests over the same vertex set — the
    pointer-jumping query batch (per-label pointer structures)."""
    return [gen.random_tree_parents(graph.n, seed=100 + seed * 997 + i)
            for i in range(q)]


def _source0(graph, seed):
    return {"source": 0}


def _check_components(graph, pg, res, inputs=None):
    truth = gen.components_ground_truth(graph)
    np.testing.assert_array_equal(_canon(res.output), _canon(truth))


def _check_pagerank(graph, pg, res, inputs=None):
    want = oracles.pagerank_oracle(graph, iters=res.steps)
    np.testing.assert_allclose(res.output, want, rtol=1e-4, atol=1e-7)


def _check_ppr(graph, pg, res, inputs):
    want = oracles.personalized_pagerank_oracle(
        graph, source=inputs.get("source", 0), iters=res.steps)
    np.testing.assert_allclose(res.output, want, rtol=1e-4, atol=1e-7)


def _check_reach(graph, pg, res, inputs):
    want = reachability.bfs_oracle(graph, source=inputs.get("source", 0))
    np.testing.assert_array_equal(res.output, want)


def _check_sssp(graph, pg, res, inputs):
    want = oracles.sssp_oracle(graph, source=inputs.get("source", 0))
    finite = ~np.isinf(want)
    np.testing.assert_allclose(res.output[finite], want[finite], rtol=1e-5)
    assert np.isinf(res.output[~finite]).all()


def _check_scc(graph, pg, res, inputs=None):
    want = oracles.scc_oracle(graph)
    np.testing.assert_array_equal(_canon(res.output), _canon(want))


def _check_msf(graph, pg, res, inputs=None):
    want_w = oracles.msf_weight_oracle(graph)
    assert abs(res.output["weight"] - want_w) < 1e-2
    truth = gen.components_ground_truth(graph)
    assert res.output["edges"] == graph.n - len(set(truth.tolist()))


def _check_pj(graph, pg, res, inputs):
    p = inputs["parents"].copy()
    for _ in range(graph.n):
        nxt = p[p]
        if (nxt == p).all():
            break
        p = nxt
    np.testing.assert_array_equal(res.output, pg.new_of_old[p])
    assert res.halted


def _bind(program_fn, variant):
    return lambda **kw: program_fn(variant=variant, **kw)


REGISTRY: Dict[str, ProgramSpec] = {
    **{f"wcc:{v}": ProgramSpec(
        key=f"wcc:{v}", algorithm="wcc", variant=v,
        factory=_bind(wcc.program, v),
        build=("scatter_out", "prop_out", "raw_out"),
        make_graph=_sym_rmat, check=_check_components)
       for v in wcc.VARIANTS},
    **{f"sv:{v}": ProgramSpec(
        key=f"sv:{v}", algorithm="sv", variant=v,
        factory=_bind(sv.program, v),
        build=("scatter_out", "prop_out", "raw_out"),
        make_graph=_sym_rmat, check=_check_components)
       for v in sv.VARIANTS},
    # pj:reqresp carries a query axis: one query = one forest over the
    # same vertex set (distinct random trees)
    **{f"pj:{v}": ProgramSpec(
        key=f"pj:{v}", algorithm="pj", variant=v,
        factory=_bind(pointer_jumping.program, v),
        build=(), make_graph=_forest_graph, make_inputs=_forest_inputs,
        check=_check_pj, channel_class="routed", test_scale=9,
        make_queries=_forest_queries if v == "reqresp" else None,
        query_knob="parents" if v == "reqresp" else None)
       for v in pointer_jumping.VARIANTS},
    **{f"pagerank:{v}": ProgramSpec(
        key=f"pagerank:{v}", algorithm="pagerank", variant=v,
        factory=_bind(pagerank.program, v),
        build=("scatter_out", "raw_out"),
        make_graph=_directed_rmat, check=_check_pagerank)
       for v in pagerank.VARIANTS if v != "personal"},
    "pagerank:personal": ProgramSpec(
        key="pagerank:personal", algorithm="pagerank", variant="personal",
        factory=_bind(pagerank.program, "personal"),
        build=("scatter_out",),
        make_graph=_directed_rmat, make_inputs=_source0, check=_check_ppr,
        make_queries=_random_sources, query_knob="source",
        channel_class="static"),
    **{f"msf:{v}": ProgramSpec(
        key=f"msf:{v}", algorithm="msf", variant=v,
        factory=_bind(msf.program, v), build=("raw_out",),
        make_graph=_weighted_sym_rmat, check=_check_msf, test_scale=7)
       for v in msf.VARIANTS},
    "reach:basic": ProgramSpec(
        key="reach:basic", algorithm="reach", variant="basic",
        factory=_bind(reachability.program, "basic"),
        build=("raw_out",),
        make_graph=_directed_rmat, make_inputs=_source0, check=_check_reach,
        make_queries=_random_sources, query_knob="source",
        channel_class="routed"),
    **{f"sssp:{v}": ProgramSpec(
        key=f"sssp:{v}", algorithm="sssp", variant=v,
        factory=_bind(sssp.program, v),
        build=("prop_out", "raw_out"),
        make_graph=_weighted_rmat, make_inputs=_source0, check=_check_sssp,
        make_queries=_random_sources, query_knob="source",
        channel_class="routed" if v == "basic" else "static")
       for v in sssp.VARIANTS},
    **{f"scc:{v}": ProgramSpec(
        key=f"scc:{v}", algorithm="scc", variant=v,
        factory=_bind(scc.program, v), build=ALL_PLANS,
        make_graph=_scc_rmat, check=_check_scc, test_scale=7)
       for v in scc.VARIANTS},
}

#: the variant ``python -m repro_torch run <algorithm>`` picks when no
#: variant is given — the JAX registry's choice (each algorithm's
#: optimized-channel showcase)
DEFAULT_VARIANT: Dict[str, str] = {
    "wcc": "prop",
    "sv": "both",
    "msf": "channels",
    "scc": "prop",
    "sssp": "basic",
    "pagerank": "scatter",
    "pj": "reqresp",
    "reach": "basic",
}

ALGORITHMS: Tuple[str, ...] = tuple(sorted(DEFAULT_VARIANT))

#: specs with a query axis — what ``Engine.run_batch``, ``Engine.serve``
#: and ``python -m repro_torch bench-batch`` run, under either
#: ``route_batch`` (the JAX ``BATCHED``)
BATCHED: Tuple[str, ...] = tuple(
    sorted(k for k, s in REGISTRY.items() if s.make_queries is not None))

#: the abstract channel kinds a program may declare
CHANNEL_CLASSES: Tuple[str, ...] = ("static", "routed")


def channel_class_of(program_name: str) -> str:
    """The data-plane family of a registered program (``"static"`` for
    an unregistered name), as the JAX registry gives it."""
    spec = REGISTRY.get(program_name)
    return spec.channel_class if spec is not None else "static"


def resolve(name: str) -> ProgramSpec:
    """``"wcc"`` (default variant) or ``"wcc:switch"`` -> ProgramSpec."""
    key = name if ":" in name else f"{name}:{DEFAULT_VARIANT.get(name, '')}"
    try:
        return REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown or not yet ported program {name!r}; ported: "
            f"{', '.join(sorted(REGISTRY))}") from None


def get_program(key: str, **knobs) -> VertexProgram:
    """The registered program ``key`` built with ``knobs`` (no compile
    cache to share in the port, so no memo)."""
    return resolve(key).factory(**knobs)

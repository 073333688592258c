"""The port's host-side graph pipeline (repro_torch.graph) against the
JAX package: generators, partitioners and every plan table, bit for bit.

``jax_tables`` hands a JAX ``PartitionedGraph``'s leaves over as numpy
in the form ``repro_torch.graph.pgraph.from_arrays`` takes; the other
port parity tests import it to feed both packages the identical plan.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.graph import oracles as joracles
from repro.graph import partition as jpart
from repro.graph import pgraph as jpgraph
from repro_torch.core import routing
from repro_torch.graph import generators as gen
from repro_torch.graph import oracles, partition, pgraph
from repro_torch.pregel.errors import PlanRangeError

ALL_PLANS = pgraph.PLANS


def _plan_arrays(plan):
    """(tables, statics) of one JAX plan; a nested plan (a PropPlan's
    ``cut``) becomes a nested pair of dicts under its field name."""
    t, s = {}, {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if dataclasses.is_dataclass(v):
            t[f.name], s[f.name] = _plan_arrays(v)
        elif f.metadata.get("static"):
            s[f.name] = v
        else:
            t[f.name] = None if v is None else np.asarray(v)
    return t, s


def jax_tables(pg):
    """(tables, statics) of a JAX PartitionedGraph, as host numpy."""
    tables = {"v_mask": np.asarray(pg.v_mask),
              "deg_out": np.asarray(pg.deg_out)}
    statics = dict(n=pg.n, num_workers=pg.num_workers, n_loc=pg.n_loc,
                   directed=pg.directed, name=pg.name,
                   new_of_old=pg.new_of_old.arr, route_cap=pg.route_cap)
    for p in ALL_PLANS:
        plan = getattr(pg, p)
        if plan is not None:
            tables[p], statics[p] = _plan_arrays(plan)
    return tables, statics


def _same_plan_tables(got_t, got_s, want_t, want_s, path):
    """Every table and static of a plan, bit for bit, nested plans
    included, except the TPU tiling tables the port does not build."""
    for k in set(want_t) - set(pgraph._TPU_ONLY):
        w = want_t[k]
        if isinstance(w, dict):
            _same_plan_tables(got_t[k], got_s[k], w, want_s[k],
                              f"{path}.{k}")
        elif w is None:
            assert got_t[k] is None, (path, k)
        else:
            assert got_t[k].dtype == w.dtype, (path, k)
            np.testing.assert_array_equal(got_t[k], w, err_msg=f"{path}.{k}")
    want_statics = {k: v for k, v in want_s.items()
                    if k not in pgraph._TPU_ONLY and k not in want_t}
    assert {k: v for k, v in got_s.items() if k not in got_t} \
        == want_statics, path


def _graph(directed):
    g = gen.rmat(8, edge_factor=6, seed=3)
    return g if directed else g.symmetrized()


@pytest.mark.parametrize("make", [
    lambda m: m.rmat(9, edge_factor=5, seed=4),
    lambda m: m.rmat(7, edge_factor=3, seed=5, weighted=True).symmetrized(),
    lambda m: m.chain(33),
    lambda m: m.grid2d(6),
    lambda m: m.uniform_random(100, 400, seed=6, weighted=True),
    lambda m: m.random_tree(50, seed=7),
], ids=["rmat", "rmat_weighted_sym", "chain", "grid", "uniform", "tree"])
def test_generators_match_jax(make):
    got, want = make(gen), make(jgen)
    assert (got.n, got.directed, got.name) == (want.n, want.directed,
                                               want.name)
    np.testing.assert_array_equal(got.edges, want.edges)
    if want.weights is None:
        assert got.weights is None
    else:
        np.testing.assert_array_equal(got.weights, want.weights)


@pytest.mark.parametrize("name", sorted(jpart.PARTITIONERS))
def test_partitioners_match_jax(name):
    g = _graph(directed=False)
    assert sorted(partition.PARTITIONERS) == sorted(jpart.PARTITIONERS)
    np.testing.assert_array_equal(
        partition.PARTITIONERS[name](g, 4, seed=1),
        jpart.PARTITIONERS[name](g, 4, seed=1))


@pytest.mark.parametrize("mirror", [None, 12])
@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("name", sorted(jpart.PARTITIONERS))
def test_plan_tables_match_jax(name, directed, mirror):
    """Every table and static of every plan, bit for bit, except the TPU
    tiling tables the port does not build."""
    g = _graph(directed)
    want_t, want_s = jax_tables(jpgraph.partition_graph(
        g, 4, name, seed=2, build=ALL_PLANS, mirror_threshold=mirror))
    got_t, got_s = pgraph.partition_tables(
        g, 4, name, seed=2, build=ALL_PLANS, mirror_threshold=mirror)
    for key in ("v_mask", "deg_out"):
        np.testing.assert_array_equal(got_t[key], want_t[key])
    np.testing.assert_array_equal(got_s.pop("new_of_old"),
                                  want_s.pop("new_of_old"))
    for p in ALL_PLANS:
        _same_plan_tables(got_t[p], got_s.pop(p), want_t[p], want_s.pop(p),
                          p)
    assert got_s == want_s
    if mirror is not None:  # the mirrored case exercises hub mirroring
        assert want_t["scatter_out"]["hub_local"] is not None
        assert want_t["prop_out"]["cut"]["hub_local"] is not None


def test_from_arrays_of_jax_plan_equals_port_build():
    g = _graph(directed=True)
    jpg = jpgraph.partition_graph(g, 4, "degree", build=ALL_PLANS,
                                  mirror_threshold=12)
    via_jax = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    own = pgraph.partition_graph(g, 4, "degree", build=ALL_PLANS,
                                 mirror_threshold=12, device="cpu")

    def same(a, b, path):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=path)
        elif dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                same(getattr(a, f.name), getattr(b, f.name),
                     f"{path}.{f.name}")
        else:
            assert a == b, path

    same(via_jax, own, "pg")


def test_recv_tables_are_a_stable_sort_of_recv_local():
    pg = pgraph.partition_graph(_graph(directed=True), 4, build=ALL_PLANS,
                                device="cpu")
    for plan in (pg.scatter_out, pg.scatter_in, pg.prop_out.cut,
                 pg.prop_in.cut):
        flat = plan.recv_local.reshape(4, -1)
        assert torch.equal(flat.gather(1, plan.recv_order.long()),
                           plan.recv_sorted)
        assert bool((plan.recv_sorted[:, 1:] >= plan.recv_sorted[:, :-1]).all())
        for row, order in zip(flat, plan.recv_order):
            want = np.argsort(row.numpy(), kind="stable")
            np.testing.assert_array_equal(order.numpy(), want)


def test_default_device_is_the_card():
    """device=None means CUDA and raises without it — never a silent CPU
    run."""
    if torch.cuda.is_available():
        pg = pgraph.partition_graph(_graph(False), 4)
        assert pg.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pgraph.partition_graph(_graph(False), 4)


def test_local_global_views_match_jax():
    g = _graph(directed=True)
    jpg = jpgraph.partition_graph(g, 4, "random", build=("raw_out",))
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    x = np.random.default_rng(1).normal(size=(g.n, 2)).astype(np.float32)
    loc = pg.to_local(x)
    np.testing.assert_array_equal(loc.numpy(), np.asarray(jpg.to_local(x)))
    np.testing.assert_array_equal(pg.to_global(loc), x)
    np.testing.assert_array_equal(pg.global_ids().numpy(),
                                  np.asarray(jpg.global_ids()))


def test_int32_extents_raise_plan_range_errors():
    with pytest.raises(PlanRangeError):
        pgraph._check_int32_extent("x", 2**31)
    with pytest.raises(PlanRangeError):
        routing._check_slot_range(2**16, 2**15)
    routing._check_slot_range(2**16, 2**15 - 1)


def test_oracles_match_jax():
    g = _graph(directed=True)
    np.testing.assert_array_equal(oracles.pagerank_oracle(g, iters=7),
                                  joracles.pagerank_oracle(g, iters=7))
    gs = _graph(directed=False)
    np.testing.assert_array_equal(gen.components_ground_truth(gs),
                                  jgen.components_ground_truth(gs))


def _weighted_cases():
    """The registry's weighted R-MAT at two scales, and a hand-made graph
    with repeated pairs, self-loops, tied, zero and negative weights and
    isolated vertices."""
    from repro_torch.algorithms import REGISTRY

    rng = np.random.default_rng(0)
    e = rng.integers(0, 40, (300, 2)).astype(np.int64)
    w = rng.choice([0.0, 0.5, 1.0, -0.25, 2.0], 300).astype(np.float32)
    return [REGISTRY["msf:channels"].make_graph(9, 0),
            REGISTRY["msf:channels"].make_graph(12, 1),
            gen.EdgeList(50, e, w, directed=False)]


@pytest.mark.parametrize("case", range(3))
def test_msf_and_components_oracles_match_jax(case):
    """The port's scipy-based oracles against the JAX package's Kruskal and
    union-find: the forest's total weight within 1e-9 (another summation
    order), the component labels exactly."""
    g = _weighted_cases()[case]
    np.testing.assert_allclose(oracles.msf_weight_oracle(g),
                               joracles.msf_weight_oracle(g), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_array_equal(gen.components_ground_truth(g),
                                  jgen.components_ground_truth(g))

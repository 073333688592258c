"""The Propagation slice: ``PropPlan``, ``propagate``, ``cm_propagate``
and the programs on them (``wcc:prop``, ``sssp:prop``, ``scc:basic``/
``prop``) against the JAX package.

The channel functions run per worker under ``jax.vmap(axis_name=...)``
in the reference and with the W workers as the leading dim in the port,
on the same plan (the JAX plan's leaves handed to
``pgraph.from_arrays``) and the same numpy inputs from a seed. The
programs run through both packages' host-mode ``Engine``. Every check is
exact: labels and outputs, outer rounds, per-worker local iterations,
supersteps, halts, and bytes and messages per channel. Every combine is
a ``min`` (int32 or float32), which is exact in any order, so the
tolerance is zero throughout.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import algorithms as jalgorithms
from repro.algorithms import common as jcommon
from repro.core import propagation as jprop
from repro.core.channel import ChannelContext as JContext
from repro.graph import generators as jgen
from repro.graph import oracles as joracles
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro_torch import __main__ as cli
from repro_torch.algorithms import (DEFAULT_VARIANT, REGISTRY, common,
                                    get_program, sssp)
from repro_torch.core import propagation as prop
from repro_torch.core.channel import ChannelContext
from repro_torch.graph import generators as gen, oracles, pgraph
from repro_torch.pregel.engine import Engine
from test_torch_graph import jax_tables

AXIS = "w"
INT32_MAX = 2**31 - 1
KEYS = ("wcc:prop", "sssp:prop", "scc:basic", "scc:prop")


def _canon(x):
    first = {}
    return np.array([first.setdefault(v, i) for i, v in enumerate(x)])


def _both(g, w, build, partitioner="random", mirror=None):
    """The JAX graph and the port's graph of the identical plan."""
    jpg = jpgraph.partition_graph(g, w, partitioner, build=build,
                                  mirror_threshold=mirror)
    return jpg, pgraph.from_arrays(*jax_tables(jpg), device="cpu")


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# PropPlan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make,mirror", [
    (lambda m: m.rmat(8, edge_factor=5, seed=3), None),
    (lambda m: m.rmat(8, edge_factor=4, seed=5, weighted=True), None),
    (lambda m: m.rmat(8, edge_factor=6, seed=3).symmetrized(), 10),
    (lambda m: m.rmat(8, edge_factor=4, seed=6, weighted=True), 8),
], ids=["directed", "weighted", "mirrored", "weighted_mirrored"])
@pytest.mark.parametrize("partitioner", ["random", "degree"])
def test_prop_plan_from_jax_leaves_equals_port_build(make, mirror,
                                                     partitioner):
    """``from_arrays`` of the JAX PropPlan leaves (the cut plan nested
    under ``cut``) gives the port's own build, table for table, the cut
    plan's ``recv_order``/``recv_sorted`` included."""
    g = make(gen)
    build = ("prop_out", "prop_in")
    _, via_jax = _both(make(jgen), 4, build, partitioner, mirror)
    own = pgraph.partition_graph(g, 4, partitioner, build=build,
                                 mirror_threshold=mirror, device="cpu")
    for p in build:
        a, b = getattr(via_jax, p), getattr(own, p)
        assert a.ei_cap == b.ei_cap
        assert (a.int_w is None) == (b.int_w is None) == (g.weights is None)
        for k in ("int_src", "int_dst", "int_w"):
            x, y = getattr(a, k), getattr(b, k)
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), (p, k)
        for f in ("edge_src", "edge_seg", "edge_w", "pack_slot",
                  "recv_local", "send_count", "recv_order", "recv_sorted",
                  "hub_local", "u_cap", "slot_cap", "hub_cap",
                  "mirrored_edges", "remote_entries", "total_edges"):
            x, y = getattr(a.cut, f), getattr(b.cut, f)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (p, f)
            else:
                assert x == y, (p, f)
        # the internal CSR's ids are sorted (the kernel's contract),
        # padded with n_loc
        dst = b.int_dst
        assert bool((dst[:, 1:] >= dst[:, :-1]).all())
        assert bool((dst <= own.n_loc).all())
    if mirror is not None:
        assert own.prop_out.cut.hub_cap > 0


def test_prop_plan_unknown_field_is_refused():
    tables, statics = pgraph.partition_tables(gen.chain(20), 2,
                                              build=("prop_out",))
    tables["prop_out"]["bogus"] = np.zeros(3)
    with pytest.raises(ValueError, match="bogus"):
        pgraph.from_arrays(tables, statics, device="cpu")


# ---------------------------------------------------------------------------
# propagate and cm_propagate under jax.vmap
# ---------------------------------------------------------------------------


def _graph(case):
    if case in ("f32", "f32_mirrored"):
        return lambda m: m.rmat(8, edge_factor=4, seed=5, weighted=True)
    if case == "masked":
        return lambda m: m.rmat(8, edge_factor=3, seed=7)
    return lambda m: m.rmat(8, edge_factor=4, seed=2).symmetrized()


def _labels(case, pg, rng):
    """(W, n_loc[, D]) initial labels as numpy."""
    w, n_loc = pg.num_workers, pg.n_loc
    ids = np.arange(w * n_loc, dtype=np.int32).reshape(w, n_loc)
    mask = np.asarray(pg.v_mask)
    if case in ("f32", "f32_mirrored"):
        return np.where(ids == 3, 0.0, np.inf).astype(np.float32)
    if case == "d2":
        vals = rng.integers(0, 1000, (w, n_loc, 2)).astype(np.int32)
        return np.where(mask[..., None], vals, INT32_MAX).astype(np.int32)
    return np.where(mask, ids, INT32_MAX).astype(np.int32)


CASES = {
    # name: (mirror threshold, propagate kwargs)
    "int_min": (None, {}),
    "d2": (None, {}),
    "f32": (None, {"edge_transform": True}),
    "masked": (None, {"masks": True}),
    "mirrored": (6, {}),
    "f32_mirrored": (6, {"edge_transform": True}),
    "max_inner": (None, {"max_inner": 2}),
    "max_outer": (None, {"max_outer": 2}),
}


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_propagate_matches_jax(case, w):
    mirror, kw = CASES[case]
    jpg, pg = _both(_graph(case)(jgen), w, ("prop_out",), mirror=mirror)
    rng = np.random.default_rng(11)
    lab0 = _labels(case, pg, rng)
    alive = rng.random(lab0.shape[:2]) < 0.7
    limits = {k: kw[k] for k in ("max_inner", "max_outer") if k in kw}

    def jax_kw(alive_w):
        out = dict(limits)
        if kw.get("edge_transform"):
            out["edge_transform"] = lambda v, ew: v + (
                ew[:, None] if v.ndim == 2 else ew)
        if kw.get("masks"):
            am = lambda lab: alive_w.reshape(alive_w.shape + (1,) * (
                lab.ndim - 1))
            out["update"] = lambda lab, inc: jnp.where(
                am(lab), jnp.minimum(lab, inc), lab)
            out["src_values"] = lambda lab: jnp.where(am(lab), lab,
                                                      INT32_MAX)
        return out

    def shard(plan, lab, alive_w):
        c = JContext(AXIS, w, jpg.n_loc)
        out, rounds, iters = jprop.propagate(c, plan, lab, "min",
                                             name="p", **jax_kw(alive_w))
        return out, rounds, iters, c.stats_bytes["p"], c.stats_msgs["p"]

    want = jax.vmap(shard, axis_name=AXIS)(jpg.prop_out, lab0, alive)

    port_kw = dict(limits)
    if kw.get("edge_transform"):
        port_kw["edge_transform"] = lambda v, ew: v + ew[..., None]
    if kw.get("masks"):
        am = torch.from_numpy(alive)[..., None]
        port_kw["update"] = lambda lab, inc: torch.where(
            am, torch.minimum(lab, inc), lab)
        port_kw["src_values"] = lambda lab: torch.where(am, lab, INT32_MAX)
    c = ChannelContext(w, pg.n_loc, torch.device("cpu"))
    out, rounds, iters = prop.propagate(c, pg.prop_out,
                                        torch.from_numpy(lab0), "min",
                                        name="p", **port_kw)
    assert out.shape == lab0.shape and out.dtype == torch.from_numpy(
        lab0).dtype
    _same(out, want[0])
    assert [rounds] * w == np.asarray(want[1]).tolist()
    assert iters.dtype == torch.int32
    _same(iters, want[2])
    _same(c.stats_bytes["p"], want[3])
    _same(c.stats_msgs["p"], want[4])
    if case == "max_inner":
        assert int(iters.max()) <= 2 * rounds
    if case == "max_outer":
        assert rounds == 2
    if case.endswith("mirrored"):
        assert pg.prop_out.cut.hub_cap > 0


@pytest.mark.parametrize("direction", ["raw_out", "raw_in"])
def test_cm_propagate_matches_jax(direction):
    """The CombinedMessage baseline with scc's masked update: labels, the
    iteration count and the traffic of every iteration, the last
    (unchanged) one included."""
    w = 4
    jpg, pg = _both(jgen.rmat(8, edge_factor=3, seed=7), w,
                    ("raw_out", "raw_in"))
    rng = np.random.default_rng(3)
    alive = (rng.random((w, pg.n_loc)) < 0.8) & np.asarray(pg.v_mask)
    ids = np.arange(w * pg.n_loc, dtype=np.int32).reshape(w, pg.n_loc)
    lab0 = np.where(alive, ids, INT32_MAX).astype(np.int32)

    def shard(raw, lab, al):
        c = JContext(AXIS, w, jpg.n_loc)
        c.route_cap = jpg.route_cap
        out, it = jcommon.cm_propagate(
            c, raw, lab, "min", active0=al,
            update=lambda lab, inc, got: jnp.where(
                al, jnp.minimum(lab, inc), lab), name="b")
        return out, it, c.stats_bytes["b"], c.stats_msgs["b"]

    want = jax.vmap(shard, axis_name=AXIS)(getattr(jpg, direction), lab0,
                                           alive)
    al = torch.from_numpy(alive)
    c = ChannelContext(w, pg.n_loc, torch.device("cpu"),
                       route_cap=pg.route_cap)
    out, iters = common.cm_propagate(
        c, getattr(pg, direction), torch.from_numpy(lab0), "min",
        active0=al, update=lambda lab, inc, got: torch.where(
            al, torch.minimum(lab, inc), lab), name="b")
    _same(out, want[0])
    assert [iters] * w == np.asarray(want[1]).tolist() and iters > 2
    _same(c.stats_bytes["b"], want[2])
    _same(c.stats_msgs["b"], want[3])


# ---------------------------------------------------------------------------
# the programs through the Engine
# ---------------------------------------------------------------------------


def _settings(key):
    return [(4, 7), (8, 9)] if key.startswith("scc") else [(4, 9), (8, 8)]


@pytest.mark.parametrize("key,w,scale", [
    (k, w, s) for k in KEYS for w, s in _settings(k)])
def test_program_matches_jax_engine(key, w, scale):
    spec = REGISTRY[key]
    g = spec.make_graph(scale, 0)
    jpg, pg = _both(g, w, spec.build)
    inputs = spec.inputs(g, 0)
    want = JEngine(mode="host").run(
        jalgorithms.get_program(key, **inputs), jpg)
    got = Engine(mode="host", device="cpu").run(spec.factory(**inputs), pg)

    assert (got.steps, got.halted) == (want.steps, want.halted)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel
    np.testing.assert_array_equal(got.output, want.output)
    counter = "iters" if key.startswith("scc") else "info"
    assert got.state[counter].dtype == torch.int32
    _same(got.state[counter], want.state[counter])
    spec.check(g, pg, got, inputs)


def test_registry_matches_jax_for_the_prop_programs():
    for key in KEYS + ("wcc:basic", "wcc:switch", "sv:composed",
                       "sssp:basic"):
        got, want = REGISTRY[key], jalgorithms.REGISTRY[key]
        assert got.build == want.build, key
        assert got.test_scale == want.test_scale, key
        assert got.channel_class == want.channel_class, key
        assert got.query_knob == want.query_knob, key
        a, b = got.make_graph(6, 1), want.make_graph(6, 1)
        np.testing.assert_array_equal(a.edges, b.edges)
        assert got.inputs(a, 0) == want.inputs(b, 0)
    assert DEFAULT_VARIANT == jalgorithms.DEFAULT_VARIANT
    assert set(REGISTRY) == set(jalgorithms.REGISTRY)
    assert len(REGISTRY) == 21


def test_sssp_rejects_negative_weights_in_the_prop_plans():
    """The prop plan alone carries the weights: its internal and its cut
    edges are both read."""
    g = gen.rmat(7, edge_factor=4, seed=5, weighted=True)
    for bad in (0, len(g.edges) - 1):
        w = g.weights.copy()
        w[bad] = -1.0
        neg = gen.EdgeList(g.n, g.edges, w, g.directed, g.name)
        pg = pgraph.partition_graph(neg, 4, build=("prop_out",),
                                    device="cpu")
        with pytest.raises(ValueError, match="non-negative"):
            Engine(mode="host", device="cpu").run(sssp.program("prop"), pg)


def test_scc_oracle_matches_jax():
    g = gen.rmat(8, edge_factor=3, seed=7)
    np.testing.assert_array_equal(
        oracles.scc_oracle(g),
        joracles.scc_oracle(jgen.rmat(8, edge_factor=3, seed=7)))


# the JAX package's property tests (tests/test_algorithms.py), on the port


def test_wcc_prop_fewer_global_rounds():
    g = gen.grid2d(20)
    pg = pgraph.partition_graph(g, 4, "bfs", build=("prop_out", "raw_out"),
                                device="cpu")
    eng = Engine(mode="host", device="cpu")
    res_b = eng.run(get_program("wcc:basic"), pg)
    res_p = eng.run(get_program("wcc:prop"), pg)
    rounds = int(res_p.state["info"][:, 0].max())
    assert rounds < res_b.steps  # block-centric effect
    assert res_p.total_bytes < res_b.total_bytes
    truth = gen.components_ground_truth(g)
    np.testing.assert_array_equal(_canon(res_p.output), _canon(truth))


def test_partitioners_all_give_correct_wcc():
    g = gen.rmat(9, edge_factor=4, seed=2).symmetrized()
    truth = gen.components_ground_truth(g)
    prog = get_program("wcc:prop")
    eng = Engine(mode="host", device="cpu")
    for part in ("block", "random", "bfs"):
        pg = pgraph.partition_graph(g, 3, part, build=("prop_out",),
                                    device="cpu")
        res = eng.run(prog, pg)
        np.testing.assert_array_equal(_canon(res.output), _canon(truth))


def test_scc_prop_fewer_bytes_than_basic():
    spec = REGISTRY["scc:prop"]
    g = spec.make_graph(9, 0)
    pg = pgraph.partition_graph(g, 8, build=spec.build, device="cpu")
    eng = Engine(mode="host", device="cpu")
    res_p = eng.run(get_program("scc:prop"), pg)
    res_b = eng.run(get_program("scc:basic"), pg)
    np.testing.assert_array_equal(res_p.output, res_b.output)
    assert res_p.total_bytes < res_b.total_bytes


@pytest.mark.parametrize("program", ["wcc", "scc", "sssp:prop"])
def test_cli_runs_the_prop_programs(capsys, program):
    assert cli.main(["run", program, "--scale", "7", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "oracle: ok" in out
    want = {"wcc": "wcc:prop", "scc": "scc:prop"}.get(program, program)
    assert f"== {want} " in out

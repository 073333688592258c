"""The Propagation channel under the batched query plane: batched
``sssp:prop`` against the JAX package.

``propagate`` with a query axis is held to the JAX ``propagate`` under
``jax.vmap`` over the workers (``axis_name``) of ``jax.vmap`` over the
lanes, as the JAX runtime nests them: int32 and float32 ``min``, masked
updates, mirrored cut plans, and ``max_inner``/``max_outer`` limits hit
by some lanes only (a lane of constant labels converges in one round).
The program runs through both packages' ``Engine.run_batch`` in host,
fused and chunked (K = 2, 3) modes at (W, scale) = (4, 8) and (8, 7):
outputs, per-query steps, halts, bytes and messages, and each lane's
``info`` rows (rounds, local iterations). Every lane equals its own solo
run, pad lanes charge nothing, and a served session equals the JAX
``Engine(mode="chunked").serve`` on the same schedule. Every combine is
a ``min``, exact in any order, so every check is exact.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import algorithms as jalgorithms
from repro.core import propagation as jprop
from repro.core.channel import ChannelContext as JContext
from repro.graph import generators as jgen
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro.pregel.serve import QueryQueue as JQueryQueue
from repro_torch.algorithms import BATCHED, REGISTRY
from repro_torch.core import propagation as prop
from repro_torch.core.channel import ChannelContext
from repro_torch.graph import pgraph
from repro_torch.pregel.engine import Engine
from repro_torch.pregel.serve import QueryQueue
from test_torch_graph import jax_tables

AXIS = "w"
INT32_MAX = 2**31 - 1
KEY = "sssp:prop"
SEED = 0
Q = 3  # lanes of the channel-level cases


def _both(g, w, build, mirror=None):
    jpg = jpgraph.partition_graph(g, w, "random", build=build,
                                  mirror_threshold=mirror)
    return jpg, pgraph.from_arrays(*jax_tables(jpg), device="cpu")


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# propagate with a query axis, against jax.vmap(jax.vmap(propagate))
# ---------------------------------------------------------------------------

CASES = {
    # name: (graph, mirror threshold, kwargs)
    "int_min": ("sym", None, {}),
    "f32": ("weighted", None, {"edge_transform": True}),
    "masked": ("directed", None, {"masks": True}),
    "mirrored": ("sym", 6, {}),
    "f32_mirrored": ("weighted", 6, {"edge_transform": True}),
    "d2": ("sym", None, {"d": 2}),
    "max_inner": ("sym", None, {"max_inner": 2}),
    "max_outer": ("sym", None, {"max_outer": 2}),
}


def _graph(kind):
    if kind == "weighted":
        return jgen.rmat(8, edge_factor=4, seed=5, weighted=True)
    if kind == "directed":
        return jgen.rmat(8, edge_factor=3, seed=7)
    return jgen.rmat(8, edge_factor=4, seed=2).symmetrized()


def _lane_labels(kind, pg, rng, d):
    """(W, Q, n_loc[, D]) labels: lane 0 constant (it converges in one
    round and one local iteration), the others from different seeds."""
    w, n_loc = pg.num_workers, pg.n_loc
    ids = np.arange(w * n_loc, dtype=np.int64).reshape(w, n_loc)
    mask = np.asarray(pg.v_mask)
    lanes = []
    for lane in range(Q):
        if kind == "weighted":
            src = rng.integers(0, w * n_loc)
            lab = np.where(ids == src, 0.0, np.inf).astype(np.float32)
            if lane == 0:
                lab = np.full((w, n_loc), np.inf, np.float32)
        else:
            perm = rng.permutation(w * n_loc).reshape(w, n_loc)
            lab = np.where(mask, perm, INT32_MAX).astype(np.int32)
            if lane == 0:
                lab = np.full((w, n_loc), 5, np.int32)
            if d == 2:
                lab = np.stack([lab, np.flip(lab, axis=1)], axis=-1)
        lanes.append(lab)
    return np.stack(lanes, axis=1)


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_propagate_matches_jax_query_vmap(case, w):
    kind, mirror, kw = CASES[case]
    d = kw.get("d", 1)
    jpg, pg = _both(_graph(kind), w, ("prop_out",), mirror=mirror)
    rng = np.random.default_rng(21)
    lab0 = _lane_labels(kind, pg, rng, d)
    alive = rng.random((w, pg.n_loc)) < 0.7
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

    lanes = jax.vmap(shard, in_axes=(None, 0, None))
    want = jax.vmap(lanes, axis_name=AXIS)(jpg.prop_out, lab0, alive)

    port_kw = dict(limits)
    if kw.get("edge_transform"):
        port_kw["edge_transform"] = lambda v, ew: v + ew[..., None]
    if kw.get("masks"):
        am = torch.from_numpy(alive)[..., None]
        port_kw["update"] = lambda lab, inc: torch.where(
            am, torch.minimum(lab, inc), lab)
        port_kw["src_values"] = lambda lab: torch.where(am, lab, INT32_MAX)
    c = ChannelContext(w, pg.n_loc, torch.device("cpu"), num_queries=Q)
    out, rounds, iters = prop.propagate(c, pg.prop_out,
                                        torch.from_numpy(lab0), "min",
                                        name="p", **port_kw)
    assert out.shape == lab0.shape
    _same(out, want[0])
    assert rounds.shape == (Q,)
    _same(rounds.expand(w, Q), want[1])
    _same(iters, want[2])
    _same(c.stats_bytes["p"], want[3])
    _same(c.stats_msgs["p"], want[4])
    # the constant lane converges at once while the others go on
    assert int(rounds[0]) == 1 and int(rounds.max()) > 1
    if case in ("max_inner", "max_outer"):
        assert int(iters[:, 0].max()) == 1
    if case == "max_inner":
        assert int(iters[:, 1:].max()) > int(rounds[1:].max())
    if case == "max_outer":
        assert rounds[1:].tolist() == [2] * (Q - 1)


def test_batched_propagate_lanes_not_live_run_nothing():
    """A lane that is not live at the step (a pad lane, or one that has
    halted) runs no round: its labels stay, it counts no round and no
    iteration and charges nothing; the live lanes equal a batch of only
    them."""
    jpg, pg = _both(_graph("sym"), 4, ("prop_out",))
    lab0 = torch.from_numpy(_lane_labels("sym", pg,
                                         np.random.default_rng(3), 1))
    live = torch.tensor([True, False, True])
    c = ChannelContext(4, pg.n_loc, torch.device("cpu"), num_queries=Q,
                       query_live=live)
    out, rounds, iters = prop.propagate(c, pg.prop_out, lab0, "min")
    assert torch.equal(out[:, 1], lab0[:, 1])
    assert int(rounds[1]) == 0 and int(iters[:, 1].abs().sum()) == 0
    assert int(c.stats_bytes["propagation"][:, 1].abs().sum()) == 0
    assert int(c.stats_msgs["propagation"][:, 1].abs().sum()) == 0
    two = ChannelContext(4, pg.n_loc, torch.device("cpu"), num_queries=2)
    want, wr, wi = prop.propagate(two, pg.prop_out, lab0[:, [0, 2]], "min")
    assert torch.equal(out[:, [0, 2]], want)
    assert torch.equal(rounds[[0, 2]], wr)
    assert torch.equal(iters[:, [0, 2]], wi)
    assert torch.equal(c.stats_bytes["propagation"][:, [0, 2]],
                       two.stats_bytes["propagation"])


# ---------------------------------------------------------------------------
# batched sssp:prop against the JAX run_batch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def problem(w, scale, nq=5):
    """(graph, JAX partition, port partition, nq sources)."""
    spec = REGISTRY[KEY]
    graph = spec.make_graph(scale, SEED)
    jpg = jpgraph.partition_graph(graph, w, "random",
                                  build=jalgorithms.REGISTRY[KEY].build)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    return graph, jpg, pg, [int(s) for s in spec.queries(graph, SEED, nq)]


@functools.lru_cache(maxsize=None)
def solo(w, scale, source):
    _, _, pg, _ = problem(w, scale)
    return Engine(mode="host", device="cpu").run(
        REGISTRY[KEY].factory(source=source), pg)


MODE_CASES = [("host", 64), ("fused", 64), ("chunked", 2), ("chunked", 3)]


def test_sssp_prop_is_batched_like_jax():
    assert KEY in BATCHED
    assert set(BATCHED) == set(jalgorithms.BATCHED)


@pytest.mark.parametrize("w,scale", [(4, 8), (8, 7)])
@pytest.mark.parametrize("mode,k", MODE_CASES)
def test_batched_sssp_prop_matches_jax_run_batch(mode, k, w, scale):
    graph, jpg, pg, queries = problem(w, scale)
    want = JEngine(mode=mode, chunk_size=k).run_batch(
        jalgorithms.REGISTRY[KEY].factory(), jpg, queries)
    got = Engine(mode=mode, chunk_size=k, device="cpu").run_batch(
        REGISTRY[KEY].factory(), pg, queries)
    q = len(queries)
    assert got.num_queries == q and got.steps == want.steps
    for qi in range(q):
        _same(got.outputs[qi], want.outputs[qi])
    _same(got.query_steps, want.query_steps)
    _same(got.query_halted, want.query_halted)
    assert sorted(got.query_bytes_by_channel) == sorted(
        want.query_bytes_by_channel)
    for name in want.query_bytes_by_channel:
        _same(got.query_bytes_by_channel[name],
              want.query_bytes_by_channel[name])
        _same(got.query_msgs_by_channel[name],
              want.query_msgs_by_channel[name])
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel
    _same(got.state["info"][:, :q], np.asarray(want.state["info"])[:, :q])
    # the audit: pad lanes never stepped and were charged nothing
    assert got.num_pad_lanes == want.num_pad_lanes == 3
    assert (got.pad_steps, got.pad_bytes, got.pad_msgs) == (0, 0, 0)


@pytest.mark.parametrize("mode,k", MODE_CASES)
def test_every_batched_lane_equals_its_solo_run(mode, k):
    _, _, pg, queries = problem(4, 8)
    got = Engine(mode=mode, chunk_size=k, device="cpu").run_batch(
        REGISTRY[KEY].factory(), pg, queries)
    for qi, source in enumerate(queries):
        ref = solo(4, 8, source)
        _same(got.outputs[qi], ref.output)
        _same(got.state["info"][:, qi], ref.state["info"])
        assert got.query_bytes(qi) == ref.bytes_by_channel
        assert got.query_msgs(qi) == ref.msgs_by_channel
        assert int(got.query_steps[qi]) == ref.steps
        assert bool(got.query_halted[qi]) == ref.halted


def test_padded_batch_replays_the_bucket_loop():
    """Q=5 and Q=7 share the cap-8 bucket's loop; the pad lanes are an
    input of each run."""
    _, _, pg, queries = problem(4, 8, 7)
    eng, prog = Engine(mode="fused", device="cpu"), REGISTRY[KEY].factory()
    a = eng.run_batch(prog, pg, queries)
    b = eng.run_batch(prog, pg, queries[:5])
    assert b.cache_hit and eng.compiles == 1
    for qi in range(5):
        _same(b.outputs[qi], a.outputs[qi])
        assert b.query_bytes(qi) == a.query_bytes(qi)
    assert (a.num_pad_lanes, b.num_pad_lanes) == (1, 3)
    assert (b.pad_bytes, b.pad_msgs, b.pad_steps) == (0, 0, 0)


def test_served_session_matches_jax_serve():
    graph, jpg, pg, queries = problem(4, 8, 6)
    schedule = REGISTRY[KEY].stream(graph, SEED, 6)
    schedule = [(t, queries[i]) for i, (t, _) in enumerate(schedule)]
    want = JEngine(mode="chunked", chunk_size=2).serve(
        jalgorithms.REGISTRY[KEY].factory(), jpg,
        JQueryQueue.from_schedule(schedule), num_lanes=3)
    got = Engine(mode="chunked", chunk_size=2, device="cpu").serve(
        REGISTRY[KEY].factory(), pg, QueryQueue.from_schedule(schedule),
        num_lanes=3)
    assert len(got.records) == len(want.records) == 6
    for r, j in zip(got.records, want.records):
        for field in ("qid", "query", "lane", "arrival", "admitted",
                      "finished", "steps", "halted", "bytes_by_channel",
                      "msgs_by_channel", "status"):
            assert getattr(r, field) == getattr(j, field), (r.qid, field)
        _same(r.output, j.output)
        ref = solo(4, 8, r.query)
        _same(r.output, ref.output)
        assert r.bytes_by_channel == ref.bytes_by_channel
    assert (got.supersteps, got.clock, got.dispatches) == (
        want.supersteps, want.clock, want.dispatches)
    assert got.bytes_by_channel == want.bytes_by_channel

"""The port's batched query plane (``Engine.run_batch``) against the JAX
package's, for ``reach:basic`` and ``sssp:basic``, plus its building
blocks: the batched ``ChannelContext``, ``union_dedup``, the union
CombinedMessage and the batched runtime's failure contract.

The same numpy graph and query sources go through both packages (the
port's graph is built from the JAX graph's tables). Per-query outputs,
steps, halt flags and per-channel bytes/msgs must be identical: the
combiner is ``min``, exact in any order, so the tolerance is 0. W=4,
test scale 8, NQ=5 queries (padded into the cap-8 bucket: three pad
lanes).
"""
import functools

import numpy as np
import pytest
import torch

from repro import algorithms as jalgorithms
from repro.core import message as jmsg
from repro.core import routing as jrouting
from repro.graph import pgraph as jpgraph
from repro.pregel import errors as jerrors
from repro.pregel.engine import Engine as JEngine
from repro.pregel.program import VertexProgram as JVertexProgram
from repro_torch.algorithms import BATCHED, REGISTRY, get_program, sssp
from repro_torch.core import aggregator, routing
from repro_torch.core import message as msg
from repro_torch.core import propagation as prop
from repro_torch.core.channel import ChannelContext
from repro_torch.graph import pgraph
from repro_torch.pregel import errors, runtime
from repro_torch.pregel.engine import Engine, bucket_queries
from repro_torch.pregel.program import VertexProgram, gather_local, lane_view
from test_torch_graph import jax_tables

SEED = 0
W = 4
NQ = 5
#: the union CombinedMessage programs, exact against the JAX package (the
#: other batched programs: tests/test_torch_personal.py and
#: tests/test_torch_batch_routed.py)
KEYS = ("reach:basic", "sssp:basic")


@functools.lru_cache(maxsize=None)
def problem(key):
    """(graph, JAX pg, port pg, queries) for a batched registry key."""
    spec = REGISTRY[key]
    graph = spec.make_graph(spec.test_scale, SEED)
    jpg = jpgraph.partition_graph(graph, W, "random",
                                  build=jalgorithms.REGISTRY[key].build)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    return graph, jpg, pg, spec.queries(graph, SEED, NQ)


@functools.lru_cache(maxsize=None)
def batched_runs(key):
    """(JAX host-mode run_batch, port run_batch) on the same problem."""
    graph, jpg, pg, queries = problem(key)
    jspec, spec = jalgorithms.REGISTRY[key], REGISTRY[key]
    want = JEngine(mode="host").run_batch(
        jspec.factory(**jspec.inputs(graph, SEED)), jpg, queries)
    got = Engine(mode="host", device="cpu").run_batch(
        spec.factory(**spec.inputs(graph, SEED)), pg, queries)
    return want, got


def test_registry_batched_keys():
    """Every JAX batched program, with the JAX recipes."""
    assert BATCHED == ("pagerank:personal", "pj:reqresp", "reach:basic",
                       "sssp:basic", "sssp:prop")
    assert set(BATCHED) == set(jalgorithms.BATCHED)
    for key in BATCHED:
        spec, jspec = REGISTRY[key], jalgorithms.REGISTRY[key]
        assert (spec.query_knob, spec.channel_class, spec.test_scale,
                spec.build) == (jspec.query_knob, jspec.channel_class,
                                jspec.test_scale, jspec.build)
        graph = spec.make_graph(7, SEED)
        np.testing.assert_array_equal(
            graph.edges, jspec.make_graph(7, SEED).edges)
        got, want = spec.queries(graph, SEED, 6), jspec.queries(graph, SEED,
                                                                  6)
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        a, b = spec.inputs(graph, SEED), jspec.inputs(graph, SEED)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# (c) run_batch against the JAX package's run_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", KEYS)
def test_run_batch_matches_jax_run_batch(key):
    want, got = batched_runs(key)
    assert got.num_queries == want.num_queries == NQ
    assert got.steps == want.steps and got.halted == want.halted
    np.testing.assert_array_equal(got.query_steps,
                                  np.asarray(want.query_steps))
    np.testing.assert_array_equal(got.query_halted,
                                  np.asarray(want.query_halted))
    for qi in range(NQ):
        np.testing.assert_array_equal(got.outputs[qi],
                                      np.asarray(want.outputs[qi]))
        assert got.query_bytes(qi) == want.query_bytes(qi)
        assert got.query_msgs(qi) == want.query_msgs(qi)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel


@pytest.mark.parametrize("key", KEYS)
def test_pad_lanes_are_dead_like_jax(key):
    want, got = batched_runs(key)
    audit = (got.num_pad_lanes, got.pad_steps, got.pad_bytes, got.pad_msgs)
    assert audit == (3, 0, 0, 0)
    assert audit == (want.num_pad_lanes, want.pad_steps, want.pad_bytes,
                     want.pad_msgs)
    assert got.state["dist" if key == "sssp:basic" else "hop"].shape[1] == 8
    assert len(got.outputs) == NQ and got.output is got.outputs


# ---------------------------------------------------------------------------
# (d) batched == Q solo port runs; (e) solo port runs == JAX solo runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", KEYS)
def test_run_batch_matches_solo_runs(key):
    graph, _, pg, queries = problem(key)
    _, got = batched_runs(key)
    spec = REGISTRY[key]
    eng = Engine(mode="host", device="cpu")
    for qi, source in enumerate(queries):
        solo = eng.run(spec.factory(**{spec.query_knob: source}), pg)
        np.testing.assert_array_equal(got.outputs[qi], solo.output)
        assert int(got.query_steps[qi]) == solo.steps
        assert bool(got.query_halted[qi]) == solo.halted
        assert got.query_bytes(qi) == solo.bytes_by_channel
        assert got.query_msgs(qi) == solo.msgs_by_channel
    for name, per_q in got.query_bytes_by_channel.items():
        assert got.bytes_by_channel[name] == int(per_q.sum())


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("which", [0, 1])
def test_solo_run_matches_jax_engine(key, which):
    graph, jpg, pg, queries = problem(key)
    source = queries[which]
    spec, jspec = REGISTRY[key], jalgorithms.REGISTRY[key]
    want = JEngine(mode="host").run(jspec.factory(source=source), jpg)
    got = Engine(mode="host", device="cpu").run(spec.factory(source=source),
                                                pg)
    assert (got.steps, got.halted) == (want.steps, want.halted)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel
    np.testing.assert_array_equal(got.output, np.asarray(want.output))
    spec.check(graph, pg, got, {"source": source})


@pytest.mark.parametrize("key", KEYS)
def test_default_program_passes_its_oracle(key):
    spec = REGISTRY[key]
    graph = spec.make_graph(7, SEED)
    pg = pgraph.partition_graph(graph, W, "degree", build=spec.build,
                                device="cpu")
    inputs = spec.inputs(graph, SEED)
    res = Engine(mode="host", device="cpu").run(get_program(key, **inputs), pg)
    spec.check(graph, pg, res, inputs)


# ---------------------------------------------------------------------------
# (f) the batched failure contract
# ---------------------------------------------------------------------------


def test_run_batch_rejects_programs_without_query_axis():
    spec = REGISTRY["wcc:basic"]
    pg = pgraph.partition_graph(spec.make_graph(6, SEED), W, "random",
                                build=spec.build, device="cpu")
    with pytest.raises(ValueError, match="no query axis"):
        Engine(mode="host", device="cpu").run_batch(
            get_program("wcc:basic"), pg, [0, 1])


def _overflow_programs():
    """The same capacity-1 CombinedMessage program in both packages: a
    lane's source sends its id to every out-neighbor at superstep 0."""

    def jinit(pg, src_old):
        ids = pg.global_ids()
        return {"active": ids == int(pg.new_of_old.arr[src_old])}

    def jstep(ctx, gs, state, i):
        raw = gs.raw_out
        valid = raw.mask & state["active"][raw.src_local]
        _, _, ovf = jmsg.combined_send(ctx, raw.dst_global, valid,
                                       raw.src_local, "min", capacity=1)
        return state, True, ovf

    def init(pg, src_old):
        return {"active": pg.global_ids() == int(pg.new_of_old[src_old])}

    def step(ctx, gs, state, i):
        raw, active = gs.raw_out, state["active"]
        valid = lane_view(raw.mask, active) & gather_local(active,
                                                           raw.src_local)
        vals = lane_view(raw.src_local, active).expand(valid.shape)
        _, _, ovf = msg.combined_send(ctx, raw.dst_global, valid, vals,
                                      "min", capacity=1)
        return state, True, ovf

    return (JVertexProgram("ovf", lambda pg: jinit(pg, 0), jstep,
                           query_init=jinit),
            VertexProgram("ovf", lambda pg: init(pg, 0), step,
                          query_init=init))


def test_batched_overflow_raises_with_qids_like_jax():
    _, jpg, pg, queries = problem("reach:basic")
    jprog, prog = _overflow_programs()
    with pytest.raises(jerrors.ChannelOverflowError) as jerr:
        JEngine(mode="host").run_batch(jprog, jpg, queries)
    with pytest.raises(errors.ChannelOverflowError) as err:
        Engine(mode="host", device="cpu").run_batch(prog, pg, queries)
    assert 0 < len(err.value.qids) < NQ
    assert err.value.qids == jerr.value.qids
    assert err.value.superstep == jerr.value.superstep == 0
    assert err.value.channels == jerr.value.channels == ("combined_message",)
    res, jres = err.value.result, jerr.value.result
    for qi in range(NQ):
        assert res.query_bytes(qi) == jres.query_bytes(qi)


def test_batched_traffic_wrap_raises():
    _, _, pg, _ = problem("reach:basic")

    def step(ctx, gs, state, i):
        ctx.add_traffic("big", 2**31 - 1, 1)
        ctx.add_traffic("big", 2**31 - 1, 1)
        return state, False

    state0 = {"x": pg.v_mask[:, None].expand(W, 2, pg.n_loc).contiguous()}
    with pytest.raises(errors.TrafficWrapError) as err:
        runtime.run_batched_supersteps(pg, step, state0, 2)
    assert err.value.channels == ("big",) and err.value.superstep == 0


def test_batched_halting_freezes_lanes_and_masks_traffic():
    """Lane 0 votes halt at superstep 0, lane 1 at superstep 2: lane 0's
    state stays as it was after its halting step and it is charged for
    that step only; declared channels are enforced as in the solo loop."""
    _, _, pg, _ = problem("reach:basic")

    def step(ctx, gs, state, i):
        ctx.add_traffic("t", 10, 1)
        halt = torch.tensor([True, i >= 2])
        return {"x": state["x"] + 1}, halt

    state0 = {"x": torch.zeros(W, 2, 3, dtype=torch.int32)}
    res = runtime.run_batched_supersteps(pg, step, state0, 2,
                                         channels=("t",))
    assert res.steps == 3 and res.query_steps.tolist() == [1, 3]
    assert res.state["x"][:, 0].unique().tolist() == [1]
    assert res.state["x"][:, 1].unique().tolist() == [3]
    assert res.query_bytes(0) == {"t": 10 * W}
    assert res.query_msgs(1) == {"t": 3 * W}
    with pytest.raises(ValueError, match="never reached"):
        runtime.run_batched_supersteps(pg, step, state0, 2,
                                       channels=("t", "u"))


def test_bucket_queries_pow2():
    assert [bucket_queries(q) for q in (1, 2, 3, 4, 5, 20, 32, 33)] == \
        [1, 2, 4, 4, 8, 32, 32, 64]
    with pytest.raises(ValueError, match="at least one query"):
        bucket_queries(0)


def test_sssp_rejects_negative_weights_and_prop():
    """Negative weights are refused, in a batch of ``sssp:prop`` too
    (its ``query_init`` checks them, as the JAX one does)."""
    spec = REGISTRY["sssp:basic"]
    graph = spec.make_graph(6, SEED)
    pg = pgraph.partition_graph(graph, W, "random", build=spec.build,
                                device="cpu")
    pg.prop_out.int_w[0, 0] = -1.0
    with pytest.raises(ValueError, match="non-negative"):
        Engine(mode="host", device="cpu").run_batch(
            sssp.program("prop"), pg, spec.queries(graph, SEED, 2))
    pg.prop_out.int_w[0, 0] = 0.0
    pg.raw_out.w[0, 0] = -1.0
    with pytest.raises(ValueError, match="non-negative"):
        sssp.program().init(pg)


# ---------------------------------------------------------------------------
# the batched channel layer
# ---------------------------------------------------------------------------


def test_batched_context_stats_are_per_lane():
    ctx = ChannelContext(3, 8, torch.device("cpu"), num_queries=2)
    assert ctx.batched and ctx.stat_shape == (3, 2)
    ctx.add_traffic("a", torch.tensor([[1, 2], [3, 4], [5, 6]]), 1)
    ctx.add_traffic("a", 1, 0)
    ctx.add_overflow("a", torch.tensor([[False, True]] * 3))
    assert ctx.stats_bytes["a"].tolist() == [[2, 3], [4, 5], [6, 7]]
    assert ctx.stats_msgs["a"].tolist() == [[1, 1]] * 3
    assert ctx.stats_ovf["a"].tolist() == [[False, True]] * 3
    assert routing.lane_live(ctx).tolist() == [True, True]
    votes = torch.tensor([[True, False], [True, True], [True, False]])
    assert aggregator.all_halted(ctx, votes).tolist() == [True, False]
    assert aggregator.all_halted(ctx, True).tolist() == [True, True]
    solo = ChannelContext(3, 8, torch.device("cpu"))
    assert not solo.batched and aggregator.all_halted(solo, True).dim() == 0


def test_batched_channels_run_on_the_plane():
    """Every channel runs under the batched plane, the Propagation
    channel too (batched ``sssp:prop``; tests/test_torch_prop_batch.py,
    tests/test_torch_personal.py, tests/test_torch_batch_routed.py)."""
    ctx = ChannelContext(2, 4, torch.device("cpu"), num_queries=2)
    z = torch.zeros(2, 2, 4)
    assert aggregator.aggregate(ctx, z, "sum").shape == (2, 2)
    out, got, ovf = msg.combined_send(ctx, z[:, 0].int(), z > 0, z, "sum",
                                      capacity=4)
    assert out.shape == (2, 2, 4) and not got.any() and not ovf.any()
    spec = REGISTRY["sssp:prop"]
    pg = pgraph.partition_graph(spec.make_graph(5, SEED), 2, "random",
                                build=spec.build, device="cpu")
    ctx = ChannelContext(2, pg.n_loc, torch.device("cpu"), num_queries=3)
    lab = pg.global_ids()[:, None].expand(2, 3, pg.n_loc)
    out, rounds, iters = prop.propagate(ctx, pg.prop_out, lab, "min")
    assert out.shape == (2, 3, pg.n_loc) and rounds.shape == (3,)
    assert iters.shape == (2, 3) and ctx.stats_bytes["propagation"].shape \
        == (2, 3)


@pytest.mark.parametrize("seed,q,m", [(0, 5, 40), (1, 1, 64), (2, 8, 3)])
def test_union_dedup_matches_jax_per_worker(seed, q, m):
    rng = np.random.default_rng(seed)
    w, n_total = 3, 48
    dst = rng.integers(0, n_total, (w, q, m)).astype(np.int32)
    valid = rng.random((w, q, m)) < 0.6
    u_cap = min(q * m, n_total)
    u_dst, pos = routing.union_dedup(torch.from_numpy(dst),
                                     torch.from_numpy(valid), n_total, u_cap)
    for r in range(w):
        j_u, j_pos = jrouting.union_dedup(dst[r], valid[r], n_total, u_cap)
        np.testing.assert_array_equal(u_dst[r].numpy(), np.asarray(j_u))
        occ = np.isin(np.arange(n_total), dst[r][valid[r]])
        np.testing.assert_array_equal(pos[r].numpy()[occ],
                                      np.asarray(j_pos)[occ])


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("shared_dst", [True, False])
def test_union_combined_send_equals_solo_sends_per_lane(dtype, shared_dst):
    """Each lane of the union CombinedMessage (min, and the union-exact
    int32 sum) equals a solo CombinedMessage of that lane — outputs,
    arrivals and per-lane traffic — and a halted lane sends nothing."""
    rng = np.random.default_rng(3)
    w, n_loc, q, m = 4, 16, 3, 60
    shape = (w, m) if shared_dst else (w, q, m)
    dst = torch.from_numpy(rng.integers(0, w * n_loc, shape).astype(np.int32))
    valid = torch.from_numpy(rng.random((w, q, m)) < 0.5)
    vals = torch.from_numpy(rng.integers(-50, 50, (w, q, m, 2))).to(dtype)
    live = torch.tensor([True, False, True])
    comb = "min" if dtype == torch.float32 else "sum"
    cpu = torch.device("cpu")
    ctx = ChannelContext(w, n_loc, cpu, num_queries=q, query_live=live)
    out, got, ovf = msg.combined_send(ctx, dst, valid, vals, comb,
                                      capacity=n_loc)
    assert out.shape == (w, q, n_loc, 2) and got.shape == (w, q, n_loc)
    assert not ovf.any()
    for lane in range(q):
        solo = ChannelContext(w, n_loc, cpu)
        d = dst if shared_dst else dst[:, lane]
        v = valid[:, lane] & bool(live[lane])
        s_out, s_got, _ = msg.combined_send(solo, d, v, vals[:, lane], comb,
                                            capacity=n_loc)
        assert torch.equal(out[:, lane], s_out)
        assert torch.equal(got[:, lane], s_got)
        assert torch.equal(ctx.stats_bytes["combined_message"][:, lane],
                           solo.stats_bytes["combined_message"])
        assert torch.equal(ctx.stats_msgs["combined_message"][:, lane],
                           solo.stats_msgs["combined_message"])
    assert not ctx.stats_msgs["combined_message"][:, 1].any()

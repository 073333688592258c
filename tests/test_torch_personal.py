"""``pagerank:personal`` — the static channels under the batched query
plane — in the port against the JAX package, on the CPU.

The same numpy graph and sources go through both packages (the port's
graph is built from the JAX graph's tables): W=4, the registry's test
scale, NQ=5 queries in the cap-8 bucket (three pad lanes). Float ranks
are held to the JAX package within rtol 1e-4 and atol 1e-7 (float sums
in another order); supersteps, halts, bytes and msgs per channel are
exact, and every batched or served lane equals the port's own solo run
bit for bit. Then the building blocks: ``aggregate`` (every combiner,
``prod`` and ``min_by_first`` against the JAX ``aggregate``, solo and
batched), ``segment_combine`` on Q·D columns (each column the D=1 call
bit for bit), the batched ScatterCombine on a mirrored plan and a
stacked static channel through one ``fused_exchange``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import algorithms as jalgorithms
from repro.core import aggregator as jagg
from repro.core.channel import ChannelContext as JChannelContext
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro.pregel.serve import QueryQueue as JQueryQueue
from repro_torch.algorithms import REGISTRY
from repro_torch.core import aggregator as agg
from repro_torch.core import combiners as cb
from repro_torch.core import compose
from repro_torch.core import scatter_combine as sc
from repro_torch.core.channel import ChannelContext
from repro_torch.graph import pgraph
from repro_torch.kernels import ops as kops
from repro_torch.pregel.engine import Engine
from repro_torch.pregel.serve import QueryQueue
from test_torch_graph import jax_tables

KEY = "pagerank:personal"
SEED, W, NQ = 0, 4, 5
RTOL, ATOL = 1e-4, 1e-7
MODES = [("host", 64), ("fused", 64), ("chunked", 3)]
MODE_IDS = ["host", "fused", "chunked3"]
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def problem(mirror=None):
    """(graph, JAX partition, port partition, NQ sources)."""
    spec = REGISTRY[KEY]
    graph = spec.make_graph(spec.test_scale, SEED)
    jpg = jpgraph.partition_graph(graph, W, "random",
                                  build=jalgorithms.REGISTRY[KEY].build,
                                  mirror_threshold=mirror)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    return graph, jpg, pg, spec.queries(graph, SEED, NQ)


@functools.lru_cache(maxsize=None)
def solo(source, mode="host", k=64):
    _, _, pg, _ = problem()
    return Engine(mode=mode, chunk_size=k, device="cpu").run(
        REGISTRY[KEY].factory(source=source), pg)


def _counts(res):
    return (res.steps, res.halted, res.bytes_by_channel, res.msgs_by_channel)


def _lane(res, qi):
    return (int(res.query_steps[qi]), bool(res.query_halted[qi]),
            res.query_bytes(qi), res.query_msgs(qi))


# ---------------------------------------------------------------------------
# solo, batched and served runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_solo_matches_jax_same_mode_and_its_oracle(mode, k):
    graph, jpg, pg, queries = problem()
    source = queries[1]
    want = JEngine(mode=mode, chunk_size=k).run(
        jalgorithms.REGISTRY[KEY].factory(source=source), jpg)
    got = solo(source, mode, k)
    assert _counts(got) == (want.steps, want.halted, want.bytes_by_channel,
                            want.msgs_by_channel)
    assert got.steps == 30 and set(got.bytes_by_channel) == {
        "aggregator", "scatter_combine"}
    np.testing.assert_allclose(got.output, np.asarray(want.output),
                               rtol=RTOL, atol=ATOL)
    REGISTRY[KEY].check(graph, pg, got, {"source": source})
    host = solo(source)
    assert _counts(got) == _counts(host)
    assert torch.equal(got.state["pr"], host.state["pr"])


@pytest.mark.parametrize("k", [2, 3])
def test_chunked_solo_is_host_mode_bit_for_bit(k):
    _, _, _, queries = problem()
    got, host = solo(queries[0], "chunked", k), solo(queries[0])
    assert _counts(got) == _counts(host)
    assert np.array_equal(got.output, host.output)


@functools.lru_cache(maxsize=None)
def batch(mode, k):
    _, jpg, pg, queries = problem()
    want = JEngine(mode=mode, chunk_size=k).run_batch(
        jalgorithms.REGISTRY[KEY].factory(), jpg, queries)
    got = Engine(mode=mode, chunk_size=k, device="cpu").run_batch(
        REGISTRY[KEY].factory(), pg, queries)
    return want, got


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_run_batch_matches_jax_run_batch(mode, k):
    want, got = batch(mode, k)
    assert got.num_queries == want.num_queries == NQ
    assert (got.steps, got.halted) == (want.steps, want.halted)
    assert got.route_batch == "union"
    for qi in range(NQ):
        assert _lane(got, qi) == (
            int(want.query_steps[qi]), bool(want.query_halted[qi]),
            want.query_bytes(qi), want.query_msgs(qi))
        np.testing.assert_allclose(got.outputs[qi],
                                   np.asarray(want.outputs[qi]),
                                   rtol=RTOL, atol=ATOL)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_every_lane_is_its_solo_run_bit_for_bit(mode, k):
    _, got = batch(mode, k)
    _, _, _, queries = problem()
    for qi, source in enumerate(queries):
        ref = solo(source)
        assert np.array_equal(got.outputs[qi], ref.output), qi
        assert _lane(got, qi) == _counts(ref)
        assert torch.equal(got.state["src"][:, qi], ref.state["src"])


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_pad_lanes_charge_nothing(mode, k):
    want, got = batch(mode, k)
    audit = (got.num_pad_lanes, got.pad_steps, got.pad_bytes, got.pad_msgs)
    assert audit == (3, 0, 0, 0) == (want.num_pad_lanes, want.pad_steps,
                                     want.pad_bytes, want.pad_msgs)
    assert got.state["pr"].shape[1] == got.state["src"].shape[1] == 8


def test_serving_lanes_of_different_ages_match_jax_and_solo_runs():
    """Three lanes at serve chunk 3, queries arriving while others run:
    each lane halts after its own 30 supersteps (the step index is its
    age), and every record equals the JAX chunked session's and its solo
    run."""
    _, jpg, pg, queries = problem()
    schedule = [(0, queries[0]), (0, queries[1]), (4, queries[2]),
                (11, queries[3]), (40, queries[4])]
    got = Engine(mode="chunked", chunk_size=3, device="cpu").serve(
        REGISTRY[KEY].factory(), pg, QueryQueue.from_schedule(schedule),
        num_lanes=3)
    want = JEngine(mode="chunked", chunk_size=3).serve(
        jalgorithms.REGISTRY[KEY].factory(), jpg,
        JQueryQueue.from_schedule(schedule), num_lanes=3)
    assert got.route_batch == "union"
    assert (got.supersteps, got.clock, got.dispatches) == (
        want.supersteps, want.clock, want.dispatches)
    assert got.bytes_by_channel == want.bytes_by_channel
    for r, j in zip(got.records, want.records, strict=True):
        for field in ("qid", "query", "lane", "arrival", "admitted",
                      "finished", "steps", "halted", "bytes_by_channel",
                      "msgs_by_channel", "status"):
            assert getattr(r, field) == getattr(j, field), (r.qid, field)
        np.testing.assert_allclose(r.output, np.asarray(j.output),
                                   rtol=RTOL, atol=ATOL)
        ref = solo(r.query)
        assert np.array_equal(r.output, ref.output)
        assert (r.steps, r.halted, r.bytes_by_channel) == (
            ref.steps, ref.halted, ref.bytes_by_channel)
    # lanes of different ages ran side by side
    assert any(a.admitted < b.admitted < a.finished
               for a in got.records for b in got.records)


# ---------------------------------------------------------------------------
# the Aggregator
# ---------------------------------------------------------------------------

N_LOC = 37  # not a power of two: the tree pads


def _jax_aggregate(values, combiner, valid=None):
    """The JAX ``aggregate`` of (W, n_loc, ...) numpy values, per worker
    under the worker ``vmap``."""
    def shard(v, m):
        ctx = JChannelContext("w", W, values.shape[1])
        return jagg.aggregate(ctx, v, combiner, m)

    mask = np.ones(values.shape[:2], bool) if valid is None else valid
    return np.asarray(jax.vmap(shard, axis_name="w")(
        jnp.asarray(values), jnp.asarray(mask)))


def _values(combiner, rng, q=None):
    lead = (W,) if q is None else (W, q)
    if combiner == "min_by_first":
        # keys with ties (a few values), -0.0/0.0, +inf and NaN
        keys = rng.choice(np.array([0.0, -0.0, 1.5, 2.0, np.inf, np.nan],
                                   np.float32), lead + (N_LOC, 1))
        return np.concatenate([keys, rng.normal(size=lead + (N_LOC, 2))
                               .astype(np.float32)], axis=-1)
    if combiner == "prod":
        return rng.uniform(0.9, 1.1, lead + (N_LOC,)).astype(np.float32)
    if combiner == "or":
        return rng.random(lead + (N_LOC,)) < 0.05
    return rng.normal(size=lead + (N_LOC,)).astype(np.float32)


def _bits(t):
    """A tensor as integers, so that ``torch.equal`` compares bits."""
    if t.dtype == torch.bool:
        return t
    return t.contiguous().view(torch.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("combiner", ["prod", "min_by_first", "sum", "min",
                                      "max", "or"])
def test_aggregate_matches_jax_solo(combiner):
    rng = np.random.default_rng(11)
    vals = _values(combiner, rng)
    valid = rng.random((W, N_LOC)) < 0.8
    ctx = ChannelContext(W, N_LOC, CPU)
    got = agg.aggregate(ctx, torch.from_numpy(vals), combiner,
                        torch.from_numpy(valid))
    want = _jax_aggregate(vals, combiner, valid)
    if combiner == "min_by_first":  # a choice, not arithmetic: exact
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got.numpy(), want)
    per = vals.dtype.itemsize * (vals.shape[2] if vals.ndim == 3 else 1)
    assert ctx.stats_bytes["aggregator"].tolist() == [2 * (W - 1) * per] * W


@pytest.mark.parametrize("combiner", ["prod", "min_by_first", "sum", "min",
                                      "max", "or"])
def test_batched_aggregate_is_each_lanes_solo_aggregate(combiner):
    """Each lane equals the solo ``aggregate`` of its values bit for bit
    (and the JAX one); a lane that is not live is charged nothing."""
    rng = np.random.default_rng(12)
    q = 3
    vals = _values(combiner, rng, q)
    live = torch.tensor([True, False, True])
    ctx = ChannelContext(W, N_LOC, CPU, num_queries=q, query_live=live)
    got = agg.aggregate(ctx, torch.from_numpy(vals), combiner)
    assert got.shape[:2] == (W, q)
    for lane in range(q):
        solo_ctx = ChannelContext(W, N_LOC, CPU)
        want = agg.aggregate(solo_ctx, torch.from_numpy(vals[:, lane]),
                             combiner)
        assert torch.equal(_bits(got[:, lane]), _bits(want))
        if combiner == "min_by_first":
            np.testing.assert_array_equal(
                got[:, lane].numpy(), _jax_aggregate(vals[:, lane], combiner))
        stats = ctx.stats_bytes["aggregator"][:, lane]
        assert stats.tolist() == (solo_ctx.stats_bytes["aggregator"].tolist()
                                  if live[lane] else [0] * W)


def test_min_by_first_aggregate_follows_the_jax_fold():
    """The fold's corner cases one by one: the first of tied least keys
    wins; a NaN key resets the fold to the entry after it; a NaN in the
    last entry wins; all keys +inf keep the identity (payload 0); -0.0
    ties 0.0. Each row sits on every worker, so the JAX ``aggregate``
    returns its local fold."""
    inf, nan = np.inf, np.nan
    for row in ([2.0, 1.0, 1.0, 3.0], [1.0, nan, 5.0, 4.0],
                [1.0, 0.0, 2.0, nan], [inf, inf, inf, inf],
                [nan, inf, inf, inf], [-0.0, 0.0, -1.0, -1.0]):
        keys = np.broadcast_to(np.array(row, np.float32), (W, 4))
        vals = np.stack([keys, np.broadcast_to(
            np.arange(4, dtype=np.float32) + 10, (W, 4))], axis=-1)
        got = agg._local(torch.from_numpy(vals), 1, cb.MIN_BY_FIRST)
        want = _jax_aggregate(vals, "min_by_first")
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# kernel 2 on Q·D columns, the batched ScatterCombine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combiner,dtype", [("sum", torch.float32),
                                            ("min", torch.int32),
                                            ("max", torch.float32)])
def test_segment_combine_columns_equal_their_d1_calls(combiner, dtype):
    rng = np.random.default_rng(4)
    rows, e, n, cols = 3, 200, 40, 12
    seg = torch.from_numpy(np.sort(rng.integers(0, n + 3, (rows, e)),
                                   axis=1).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(rows, e, cols)) * 100).to(dtype)
    out = kops.segment_combine(vals, seg, n, combiner)
    for j in range(cols):
        one = kops.segment_combine(vals[..., j:j + 1].contiguous(), seg, n,
                                   combiner)
        assert torch.equal(out[..., j:j + 1], one)


@pytest.mark.parametrize("mirror", [None, 4], ids=["plain", "mirrored"])
def test_batched_broadcast_combine_is_each_lanes_solo_combine(mirror):
    _, _, pg, _ = problem(mirror)
    plan = pg.scatter_out
    assert (plan.hub_cap > 0) == (mirror is not None)
    rng = np.random.default_rng(5)
    q = 3
    vals = torch.from_numpy(rng.random((W, q, pg.n_loc, 2)).astype(
        np.float32))
    live = torch.tensor([True, True, False])
    ctx = ChannelContext(W, pg.n_loc, CPU, num_queries=q, query_live=live)
    out = sc.broadcast_combine(ctx, plan, vals, "sum")
    assert out.shape == vals.shape
    for lane in range(q):
        solo_ctx = ChannelContext(W, pg.n_loc, CPU)
        want = sc.broadcast_combine(solo_ctx, plan, vals[:, lane], "sum")
        assert torch.equal(out[:, lane], want)
        for stats in ("stats_bytes", "stats_msgs"):
            got = getattr(ctx, stats)["scatter_combine"][:, lane]
            ref = getattr(solo_ctx, stats)["scatter_combine"]
            assert torch.equal(got, ref if live[lane] else 0 * ref)


def test_stacked_static_channels_share_one_exchange_under_the_plane():
    """Two ScatterCombine parts (``sum`` and ``max``) through one
    ``fused_exchange`` carry their Q-wide payloads in one exchange; each
    lane equals the solo exchange of the same parts."""
    _, _, pg, _ = problem()
    plan = pg.scatter_out
    rng = np.random.default_rng(6)
    q = 4
    a = torch.from_numpy(rng.random((W, q, pg.n_loc)).astype(np.float32))
    b = torch.from_numpy(rng.integers(0, 99, (W, q, pg.n_loc)).astype(
        np.int32))

    def parts(ctx, x, y):
        return [sc.plan_broadcast_combine(ctx, plan, x, "sum", name="s"),
                sc.plan_broadcast_combine(ctx, plan, y, "max", name="m")]

    ctx = ChannelContext(W, pg.n_loc, CPU, num_queries=q)
    out_a, out_b = compose.fused_exchange(ctx, parts(ctx, a, b))
    for lane in range(q):
        solo_ctx = ChannelContext(W, pg.n_loc, CPU)
        want_a, want_b = compose.fused_exchange(
            solo_ctx, parts(solo_ctx, a[:, lane], b[:, lane]))
        assert torch.equal(out_a[:, lane], want_a)
        assert torch.equal(out_b[:, lane], want_b)
        for name in ("s", "m"):
            assert torch.equal(ctx.stats_bytes[name][:, lane],
                               solo_ctx.stats_bytes[name])

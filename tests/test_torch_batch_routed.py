"""The routed channels under the batched query plane in the port, against
the JAX package and against solo runs, on the CPU: the batched
RequestRespond (``pj:reqresp``), ``route_union`` and the batched
DirectMessage, and the ``route_batch="lane"`` baseline.

The same numpy graph and queries go through both packages (the port's
graph is built from the JAX graph's tables): W=4, the registry's test
scales, NQ=5 queries in the cap-8 bucket (three pad lanes). These
programs' combines are exact in any order, so outputs, per-query steps,
halts, bytes and msgs must be identical (tolerance 0), and every lane
equal to its solo run.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import algorithms as jalgorithms
from repro.core import routing as jrouting
from repro.core.channel import ChannelContext as JChannelContext
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro_torch.algorithms import REGISTRY
from repro_torch.core import message as msg
from repro_torch.core import request_respond as rr
from repro_torch.core import routing
from repro_torch.core.channel import ChannelContext
from repro_torch.graph import pgraph
from repro_torch.pregel.engine import Engine
from test_torch_graph import jax_tables

SEED, W, NQ = 0, 4, 5
MODES = [("host", 64), ("fused", 64), ("chunked", 3)]
MODE_IDS = ["host", "fused", "chunked3"]
ROUTED = ("pj:reqresp", "reach:basic", "sssp:basic")
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def problem(key):
    """(graph, JAX partition, port partition, NQ queries)."""
    spec = REGISTRY[key]
    graph = spec.make_graph(spec.test_scale, SEED)
    jpg = jpgraph.partition_graph(graph, W, "random",
                                  build=jalgorithms.REGISTRY[key].build)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    return graph, jpg, pg, spec.queries(graph, SEED, NQ)


def _prog(key, jax_side=False):
    graph = problem(key)[0]
    spec = (jalgorithms.REGISTRY if jax_side else REGISTRY)[key]
    return spec.factory(**spec.inputs(graph, SEED))


@functools.lru_cache(maxsize=None)
def port_batch(key, mode, k, route_batch):
    _, _, pg, queries = problem(key)
    return Engine(mode=mode, chunk_size=k, device="cpu",
                  route_batch=route_batch).run_batch(_prog(key), pg, queries)


@functools.lru_cache(maxsize=None)
def jax_batch(key, mode, k, route_batch):
    _, jpg, _, queries = problem(key)
    return JEngine(mode=mode, chunk_size=k, route_batch=route_batch
                   ).run_batch(_prog(key, True), jpg, queries)


@functools.lru_cache(maxsize=None)
def solo(key, qi):
    _, _, pg, queries = problem(key)
    spec = REGISTRY[key]
    return Engine(mode="host", device="cpu").run(
        spec.factory(**{spec.query_knob: queries[qi]}), pg)


def _lane(res, qi):
    return (int(res.query_steps[qi]), bool(res.query_halted[qi]),
            res.query_bytes(qi), res.query_msgs(qi))


def _same_batches(got, want):
    assert got.num_queries == want.num_queries == NQ
    assert (got.steps, got.halted) == (want.steps, want.halted)
    for qi in range(NQ):
        assert _lane(got, qi) == _lane(want, qi)
        np.testing.assert_array_equal(got.outputs[qi],
                                      np.asarray(want.outputs[qi]))
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel
    assert (got.num_pad_lanes, got.pad_steps, got.pad_bytes,
            got.pad_msgs) == (want.num_pad_lanes, want.pad_steps,
                              want.pad_bytes, want.pad_msgs)


# ---------------------------------------------------------------------------
# batched pj:reqresp (the union RequestRespond)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_batched_reqresp_matches_jax_run_batch(mode, k):
    got = port_batch("pj:reqresp", mode, k, "union")
    _same_batches(got, jax_batch("pj:reqresp", mode, k, "union"))
    assert got.route_batch == "union" and got.num_pad_lanes == 3
    assert set(got.bytes_by_channel) == {"request_respond/request",
                                         "request_respond/respond"}
    for qi in range(NQ):
        ref = solo("pj:reqresp", qi)
        np.testing.assert_array_equal(got.outputs[qi], ref.output)
        assert _lane(got, qi) == (ref.steps, ref.halted,
                                  ref.bytes_by_channel, ref.msgs_by_channel)


def test_batched_reqresp_lanes_pass_their_oracle():
    graph, _, pg, queries = problem("pj:reqresp")
    got = port_batch("pj:reqresp", "host", 64, "union")
    spec = REGISTRY["pj:reqresp"]
    for qi, parents in enumerate(queries):
        one = solo("pj:reqresp", qi)
        one.output = got.outputs[qi]
        spec.check(graph, pg, one, {"parents": parents})


# ---------------------------------------------------------------------------
# route_batch="lane": Q route passes, the measured baseline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,k", [("host", 64), ("fused", 64)],
                         ids=["host", "fused"])
@pytest.mark.parametrize("key", ROUTED)
def test_lane_route_equals_the_union_route_and_jax_lane(key, mode, k):
    got = port_batch(key, mode, k, "lane")
    assert got.route_batch == "lane"
    _same_batches(got, port_batch(key, mode, k, "union"))
    _same_batches(got, jax_batch(key, "host", 64, "lane"))


def test_each_route_batch_takes_its_own_route_pass():
    """A superstep of ``reach:basic`` makes one per-lane ``route`` call
    (the Q passes in one ``bucket_ranks`` launch on the card) and no
    union pass under ``"lane"``, one ``union_ranks`` pass and no per-lane
    route under ``"union"``."""
    calls = {"route": 0, "union_ranks": 0}
    real_route, real_union = routing.route, routing.union_ranks

    def route(*a, **kw):
        calls["route"] += 1
        return real_route(*a, **kw)

    def union_ranks(*a, **kw):
        calls["union_ranks"] += 1
        return real_union(*a, **kw)

    _, _, pg, queries = problem("reach:basic")
    prog = _prog("reach:basic")
    routing.route, routing.union_ranks = route, union_ranks
    try:
        for rb in ("lane", "union"):
            calls.update(route=0, union_ranks=0)
            res = Engine(mode="host", device="cpu", route_batch=rb
                         ).run_batch(prog, pg, queries)
            passes = calls["route"] if rb == "lane" else calls[
                "union_ranks"]
            other = calls["union_ranks"] if rb == "lane" else calls["route"]
            assert (passes, other) == (res.steps, 0), rb
    finally:
        routing.route, routing.union_ranks = real_route, real_union


@pytest.mark.parametrize("route_batch", ["union", "lane"])
def test_float_sum_combined_message_runs_per_lane(route_batch):
    """A float ``sum`` is not union-exact: under the plane it runs the
    serial body once a lane whatever ``route_batch`` says, each lane
    bit-identical to its solo send, a lane that is not live sending
    nothing."""
    rng = np.random.default_rng(7)
    w, n_loc, q, m = 4, 16, 3, 60
    dst = torch.from_numpy(rng.integers(0, w * n_loc, (w, m)).astype(
        np.int32))
    valid = torch.from_numpy(rng.random((w, q, m)) < 0.6)
    vals = torch.from_numpy(rng.normal(size=(w, q, m)).astype(np.float32))
    live = torch.tensor([True, True, False])
    ctx = ChannelContext(w, n_loc, CPU, num_queries=q, query_live=live)
    with routing.batch_scope(route_batch):
        out, got, ovf = msg.combined_send(ctx, dst, valid, vals, "sum",
                                          capacity=n_loc)
    assert out.shape == (w, q, n_loc) and not ovf.any()
    for lane in range(q):
        solo_ctx = ChannelContext(w, n_loc, CPU)
        s_out, s_got, _ = msg.combined_send(
            solo_ctx, dst, valid[:, lane] & bool(live[lane]), vals[:, lane],
            "sum", capacity=n_loc)
        assert torch.equal(out[:, lane].view(torch.int32),
                           s_out.view(torch.int32))
        assert torch.equal(got[:, lane], s_got)
        assert torch.equal(ctx.stats_bytes["combined_message"][:, lane],
                           solo_ctx.stats_bytes["combined_message"])


# ---------------------------------------------------------------------------
# route_union and the batched DirectMessage
# ---------------------------------------------------------------------------

N_LOC, M, Q = 16, 24, 3


def _instance(seed, lane_dst=False):
    rng = np.random.default_rng(seed)
    shape = (W, Q, M) if lane_dst else (W, M)
    dst = rng.integers(0, W * N_LOC, shape).astype(np.int32)
    valid = rng.random((W, Q, M)) < 0.7
    payload = {"f": rng.normal(size=(W, Q, M)).astype(np.float32),
               "i2": rng.integers(-9, 9, (W, Q, M, 2)).astype(np.int32)}
    return dst, valid, payload


def _port_union(dst, valid, payload, cap, live):
    ctx = ChannelContext(W, N_LOC, CPU, num_queries=Q,
                         query_live=torch.tensor(live))
    r = routing.route_union(ctx, torch.from_numpy(dst),
                            torch.from_numpy(valid),
                            {k: torch.from_numpy(v) for k, v in
                             payload.items()}, cap)
    return r


def _jax_union(dst, valid, payload, cap, live):
    """The JAX ``route_union`` under its worker vmap and query vmap, the
    runtime's nesting; fields in the port's (W, Q, ...) layout."""
    lane_dst = dst.ndim == 3

    def shard(d, v, p):
        def lane(qi, di, vi, pi, lvi):
            ctx = JChannelContext("w", W, N_LOC, query_index=qi,
                                  query_live=lvi, num_queries=Q)
            r = jrouting.route_union(ctx, di, vi, pi, cap)
            return r.ids, r.mask, r.payload, r.slot, r.sent_count, r.overflow

        return jax.vmap(lane, in_axes=(0, 0 if lane_dst else None, 0, 0, 0))(
            jnp.arange(Q), d, v, p, jnp.asarray(live))

    return jax.vmap(shard, axis_name="w")(
        jnp.asarray(dst), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in payload.items()})


def _assert_routed_equal(got, want):
    ids, mask, pay, slot, sent, ovf = want
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(got.sent_count.numpy(), np.asarray(sent))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(ovf))
    for k in pay:
        np.testing.assert_array_equal(got.payload[k].numpy(),
                                      np.asarray(pay[k]))


@pytest.mark.parametrize("case", ["plain", "overflow", "halted_lane",
                                  "lane_dst"])
def test_route_union_matches_jax_route_union(case):
    """Every field of the per-lane ``Routed`` views, bit for bit: the
    union pass for a lane-invariant ``dst``, the per-lane fallback for a
    lane-varying one."""
    dst, valid, payload = _instance(5, lane_dst=case == "lane_dst")
    live = [True, case != "halted_lane", True]
    cap = 3 if case == "overflow" else M
    got = _port_union(dst, valid, payload, cap, live)
    _assert_routed_equal(got, _jax_union(dst, valid, payload, cap, live))
    if case == "overflow":
        assert got.overflow.any()
    if case == "halted_lane":
        assert not got.mask[:, 1].any() and not got.sent_count[:, 1].any()


def test_route_union_with_lane_varying_dst_is_q_serial_routes():
    dst, valid, payload = _instance(13, lane_dst=True)
    got = _port_union(dst, valid, payload, M, [True] * Q)
    for lane in range(Q):
        ctx = ChannelContext(W, N_LOC, CPU)
        want = routing.route(ctx, torch.from_numpy(dst[:, lane]),
                             torch.from_numpy(valid[:, lane]),
                             {k: torch.from_numpy(v[:, lane])
                              for k, v in payload.items()}, M)
        for field in ("ids", "mask", "slot", "sent_count", "overflow"):
            assert torch.equal(getattr(got, field)[:, lane],
                               getattr(want, field)), field
        for k in payload:
            assert torch.equal(got.payload[k][:, lane], want.payload[k])


def _rows(mask, dst_local, payload):
    """Sorted (dst, payload...) rows of one worker's delivery — the union
    pass reorders slots, not what arrives."""
    keep = mask.numpy()
    cols = [dst_local.numpy()[keep][:, None].astype(np.float64)]
    for k in sorted(payload):
        a = payload[k].numpy()[keep]
        cols.append(a.reshape(len(a), int(np.prod(a.shape[1:]))).astype(
            np.float64))
    mat = np.concatenate(cols, axis=1)
    return mat[np.lexsort(mat.T[::-1])]


@pytest.mark.parametrize("route_batch", ["union", "lane"])
def test_batched_direct_send_delivers_each_lanes_solo_messages(route_batch):
    dst, valid, payload = _instance(21)
    live = torch.tensor([True, False, True])
    ctx = ChannelContext(W, N_LOC, CPU, num_queries=Q, query_live=live)
    with routing.batch_scope(route_batch):
        deliv = msg.direct_send(ctx, torch.from_numpy(dst),
                                torch.from_numpy(valid),
                                {k: torch.from_numpy(v)
                                 for k, v in payload.items()}, M)
    assert deliv.mask.shape == (W, Q, W * M)
    for lane in range(Q):
        solo_ctx = ChannelContext(W, N_LOC, CPU)
        want = msg.direct_send(
            solo_ctx, torch.from_numpy(dst),
            torch.from_numpy(valid[:, lane]) & bool(live[lane]),
            {k: torch.from_numpy(v[:, lane]) for k, v in payload.items()}, M)
        for w in range(W):
            np.testing.assert_array_equal(
                _rows(deliv.mask[w, lane], deliv.dst_local[w, lane],
                      {k: v[w, lane] for k, v in deliv.payload.items()}),
                _rows(want.mask[w], want.dst_local[w],
                      {k: v[w] for k, v in want.payload.items()}))
        if route_batch == "lane":  # the serial body: positions too
            assert torch.equal(deliv.dst_local[:, lane], want.dst_local)
        for stats in ("stats_bytes", "stats_msgs"):
            assert torch.equal(
                getattr(ctx, stats)["direct_message"][:, lane],
                getattr(solo_ctx, stats)["direct_message"])
    assert not ctx.stats_msgs["direct_message"][:, 1].any()


@pytest.mark.parametrize("route_batch", ["union", "lane"])
@pytest.mark.parametrize("cap", [N_LOC, 2], ids=["fits", "overflows"])
def test_batched_request_is_each_lanes_solo_request(route_batch, cap):
    """The union request (one dedup, one route pass, ids once on the
    wire, a positional (slots, Q·D) reply) and the per-lane body: each
    lane's responses and traffic equal its solo request whenever the
    union pass fits; under overflow the union latch is a superset of the
    solo one."""
    rng = np.random.default_rng(31)
    r = 20
    dst = torch.from_numpy(rng.integers(0, W * N_LOC, (W, Q, r)).astype(
        np.int32))
    valid = torch.from_numpy(rng.random((W, r)) < 0.8)
    vals = torch.from_numpy(rng.normal(size=(W, Q, N_LOC, 2)).astype(
        np.float32))
    live = torch.tensor([True, True, False])
    ctx = ChannelContext(W, N_LOC, CPU, num_queries=Q, query_live=live)
    with routing.batch_scope(route_batch):
        out, ovf = rr.request(ctx, dst, valid, vals, capacity=cap)
    assert out.shape == (W, Q, r, 2) and ovf.shape == (W, Q)
    for lane in range(Q):
        solo_ctx = ChannelContext(W, N_LOC, CPU)
        want, s_ovf = rr.request(solo_ctx, dst[:, lane],
                                 valid & bool(live[lane]), vals[:, lane],
                                 capacity=cap)
        assert bool((ovf[:, lane] >= s_ovf).all())
        if cap == N_LOC or route_batch == "lane":
            assert torch.equal(ovf[:, lane], s_ovf)
            assert torch.equal(out[:, lane], want)
            for key in ("request_respond/request",
                        "request_respond/respond"):
                assert torch.equal(ctx.stats_bytes[key][:, lane],
                                   solo_ctx.stats_bytes[key])
    assert not ctx.stats_msgs["request_respond/request"][:, 2].any()
    if cap == 2:
        assert ovf.any()


# ---------------------------------------------------------------------------
# the route_batch knob
# ---------------------------------------------------------------------------


def test_route_batch_env_scope_and_explicit(monkeypatch):
    monkeypatch.delenv("REPRO_ROUTE_BATCH", raising=False)
    assert routing.resolve_batch() == "union"
    monkeypatch.setenv("REPRO_ROUTE_BATCH", "lane")
    assert routing.resolve_batch() == "lane"
    assert Engine(device="cpu").route_batch == "lane"
    with routing.batch_scope("union"):
        assert routing.resolve_batch() == "union"  # scope beats env
    assert routing.resolve_batch("union") == "union"  # explicit beats env
    with pytest.raises(ValueError, match="unknown route batch strategy"):
        routing.resolve_batch("fleet")
    with pytest.raises(ValueError, match="unknown route batch strategy"):
        Engine(device="cpu", route_batch="fleet")


def test_route_batch_is_part_of_the_cache_key_and_the_results():
    _, _, pg, queries = problem("reach:basic")
    prog = _prog("reach:basic")
    eng = Engine(mode="fused", device="cpu", route_batch="lane")
    solo_res = eng.run(prog, pg)
    assert solo_res.route_batch == ""
    first = eng.run_batch(prog, pg, queries)
    again = eng.run_batch(prog, pg, queries)
    assert (first.cache_hit, again.cache_hit) == (False, True)
    assert first.route_batch == again.route_batch == "lane"
    # the key ends with the resolved Plan's knob tuple, route_batch in it
    knobs = first.plan.key()
    assert first.plan.route_batch == "lane" and "lane" in knobs
    keys = [k for k in eng._cache if "batch" in k]
    assert keys and all(k[-len(knobs):] == knobs for k in keys)
    served = eng.serve(prog, pg, queries[:2], num_lanes=2)
    assert served.route_batch == "lane"

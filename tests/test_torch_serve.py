"""The port's continuous-batching query service (``Engine.serve``) on the
CPU, against the JAX package's ``Engine(mode="chunked").serve`` on the
same schedules and against solo runs.

The cases of ``tests/test_serve.py`` and the serve cases of
``tests/test_resilience.py`` that need neither the lane route nor
shard_map: the all-at-once, trickle (the clock fast-forwards), bursty
and empty schedules, a query halting in its admission chunk, a lane
refilled while its neighbour is mid-flight, a session ending with empty
lanes, budget-exhausted harvests, a fused engine with one lane, session
totals equal to the sum over queries, quarantine, ``on_fault="raise"``,
lane recycling and fault-spec validation; the queue, the arrival
process and ``ProgramSpec.stream``. Every case holds each
``QueryRecord`` field that does not depend on wall time (qid, query,
lane, arrival, admitted, finished, steps, halted, output, bytes and
msgs per channel, status, injected, channels) and the session's
supersteps, clock, dispatches and totals to the JAX session, and every
served answer to a solo host-mode ``Engine.run`` of its query.
``reach:basic`` at (W, scale) = (4, 8), as the JAX tests run it.
"""
import functools

import numpy as np
import pytest

from repro import algorithms as jalgorithms
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro.pregel.serve import FaultSpec as JFaultSpec
from repro.pregel.serve import QueryQueue as JQueryQueue
from repro.pregel.serve import poisson_arrivals as jpoisson_arrivals
from repro_torch.algorithms import REGISTRY
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.graph import pgraph
from repro_torch.pregel import errors
from repro_torch.pregel.engine import Engine
from repro_torch.pregel.serve import (FaultSpec, QueryQueue, ServeResult,
                                      as_faults, poisson_arrivals)
from test_torch_graph import jax_tables

SEED, W = 0, 4
KEY = "reach:basic"
CHUNK = 3
RECORD_FIELDS = ("qid", "query", "lane", "arrival", "admitted", "finished",
                 "steps", "halted", "bytes_by_channel", "msgs_by_channel",
                 "status", "injected", "channels")


@functools.lru_cache(maxsize=None)
def problem():
    """(graph, JAX partition, port partition, JAX program, port program,
    8 sources)."""
    spec = REGISTRY[KEY]
    graph = spec.make_graph(spec.test_scale, SEED)
    jpg = jpgraph.partition_graph(graph, W, "random",
                                  build=jalgorithms.REGISTRY[KEY].build)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    queries = [int(q) for q in spec.queries(graph, SEED, 8)]
    return (graph, jpg, pg, jalgorithms.REGISTRY[KEY].factory(),
            spec.factory(), queries)


@functools.lru_cache(maxsize=None)
def engine():
    """One port engine for the file: its sessions share the loop cache."""
    return Engine(mode="chunked", chunk_size=CHUNK, device="cpu")


@functools.lru_cache(maxsize=None)
def jengine():
    return JEngine(mode="chunked", chunk_size=CHUNK)


@functools.lru_cache(maxsize=None)
def solo(query, max_steps=None):
    """The reference: a solo host-mode run of one query."""
    _, _, pg, _, _, _ = problem()
    return Engine(mode="host", device="cpu").run(
        REGISTRY[KEY].factory(source=query), pg, max_steps=max_steps)


def serve_both(schedule, *, eng=None, jeng=None, **kw):
    """The port's and the JAX package's session over one schedule of
    ``(arrival, query)`` pairs (fault specs passed as tuples)."""
    _, jpg, pg, jprog, prog, _ = problem()
    faults = kw.pop("faults", None)
    got = (eng or engine()).serve(
        prog, pg, QueryQueue.from_schedule(schedule),
        faults=faults and [FaultSpec(*f) for f in faults], **kw)
    want = (jeng or jengine()).serve(
        jprog, jpg, JQueryQueue.from_schedule(schedule),
        faults=faults and [JFaultSpec(*f) for f in faults], **kw)
    return got, want


def at_once(queries):
    return [(0, q) for q in queries]


def assert_matches_jax(got: ServeResult, want):
    assert len(got.records) == len(want.records)
    for r, j in zip(got.records, want.records):
        for field in RECORD_FIELDS:
            assert getattr(r, field) == getattr(j, field), (r.qid, field)
        if j.output is None:
            assert r.output is None
        else:
            np.testing.assert_array_equal(r.output, np.asarray(j.output))
    assert (got.supersteps, got.clock, got.dispatches) == (
        want.supersteps, want.clock, want.dispatches)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel
    assert (got.num_lanes, got.chunk_size, got.max_steps) == (
        want.num_lanes, want.chunk_size, want.max_steps)


def assert_matches_solo(rec, max_steps=None):
    ref = solo(rec.query, max_steps)
    np.testing.assert_array_equal(rec.output, ref.output)
    assert (rec.steps, rec.halted) == (ref.steps, ref.halted), rec.qid
    assert rec.bytes_by_channel == ref.bytes_by_channel, rec.qid
    assert rec.msgs_by_channel == ref.msgs_by_channel, rec.qid


def assert_session_invariants(res: ServeResult, n_queries: int):
    """Every query served once, records in qid order, the session totals
    the sum of the per-tenancy attributions."""
    assert res.num_queries == n_queries
    assert [r.qid for r in res.records] == list(range(n_queries))
    for name, total in res.bytes_by_channel.items():
        assert total == sum(r.bytes_by_channel.get(name, 0)
                            for r in res.records), name
    for name, total in res.msgs_by_channel.items():
        assert total == sum(r.msgs_by_channel.get(name, 0)
                            for r in res.records), name
    for rec in res.records:
        assert rec.arrival <= rec.admitted <= rec.finished
        assert rec.latency_steps >= rec.steps


def check(got, want, n, max_steps=None):
    assert_matches_jax(got, want)
    assert_session_invariants(got, n)
    for rec in got.records:
        if rec.status != "overflow" and not rec.injected:
            assert_matches_solo(rec, max_steps)


# --- schedules -------------------------------------------------------------


def test_all_at_once_schedule():
    queries = problem()[-1]
    got, want = serve_both(at_once(queries), num_lanes=2)
    check(got, want, len(queries))
    assert got.dispatches >= len(queries) // 2  # 2 lanes: forced refills


def test_trickle_schedule_fast_forwards_idle_lanes():
    queries = problem()[-1]
    schedule = [(50 * i, q) for i, q in enumerate(queries[:4])]
    got, want = serve_both(schedule, num_lanes=2)
    check(got, want, 4)
    assert all(r.admitted == r.arrival for r in got.records)
    assert got.clock >= 150                    # the fast-forwards happened
    assert got.supersteps == sum(r.steps for r in got.records)


def test_bursty_schedule():
    queries = problem()[-1]
    schedule = at_once(queries[:4]) + [(30, q) for q in queries[4:8]]
    got, want = serve_both(schedule, num_lanes=2)
    check(got, want, 8)
    assert any(r.admitted > r.arrival for r in got.records)


def test_empty_queue_is_an_empty_session():
    _, jpg, pg, jprog, prog, _ = problem()
    got = engine().serve(prog, pg, [], num_lanes=2)
    want = jengine().serve(jprog, jpg, [], num_lanes=2)
    assert got.records == [] and got.num_queries == 0
    assert (got.dispatches, got.supersteps, got.clock) == (
        want.dispatches, want.supersteps, want.clock) == (0, 0, 0)
    assert got.queries_per_s == 0.0
    assert got.latency_summary() == want.latency_summary()


# --- fixed regression shapes ----------------------------------------------


def test_query_halting_in_its_admission_chunk():
    queries = problem()[-1]
    got, want = serve_both(at_once(queries), num_lanes=2, chunk_size=64)
    check(got, want, len(queries))
    assert all(r.finished - r.admitted <= 64 for r in got.records)
    assert got.dispatches == -(-len(queries) // 2)  # a wave a dispatch


def test_lane_refilled_mid_superstep_window():
    queries = problem()[-1]
    got, want = serve_both(at_once(queries), num_lanes=2, chunk_size=2)
    check(got, want, len(queries))
    assert any(a.admitted < b.admitted < a.finished
               for a in got.records for b in got.records
               if a.qid != b.qid and a.lane != b.lane)


@pytest.mark.parametrize("n,lanes", [(2, 3), (5, 3)])
def test_session_ending_with_unoccupied_lanes(n, lanes):
    queries = problem()[-1]
    got, want = serve_both(at_once(queries[:n]), num_lanes=lanes)
    check(got, want, n)


def test_budget_exhausted_lanes_are_harvested():
    queries = problem()[-1]
    got, want = serve_both(at_once(queries[:4]), num_lanes=2, max_steps=2)
    check(got, want, 4, max_steps=2)
    assert all(r.steps <= 2 for r in got.records)
    assert any(r.status == "exhausted" and not r.halted
               for r in got.records)


def test_serve_through_a_fused_engine_and_one_lane():
    """The engine's own mode does not matter: serve runs the chunked
    substrate; one lane is a serial queue."""
    queries = problem()[-1]
    got, want = serve_both(at_once(queries[:3]),
                           eng=Engine(mode="fused", device="cpu"),
                           jeng=JEngine(mode="fused"), num_lanes=1,
                           chunk_size=CHUNK)
    check(got, want, 3)
    assert all(r.lane == 0 for r in got.records)


def test_refilled_lane_counts_only_its_own_tenancy():
    queries = problem()[-1]
    got, want = serve_both(at_once(queries[:3]), num_lanes=1, chunk_size=2)
    check(got, want, 3)
    r = got.records
    assert r[0].finished <= r[1].admitted <= r[1].finished <= r[2].admitted


def test_session_totals_equal_the_solo_runs_summed():
    queries = problem()[-1]
    got, want = serve_both(at_once(queries), num_lanes=3)
    check(got, want, len(queries))
    for name, total in got.bytes_by_channel.items():
        assert total == sum(solo(r.query).bytes_by_channel[name]
                            for r in got.records)


def test_a_second_session_of_the_same_shape_replays():
    queries = problem()[-1]
    _, _, pg, _, prog, _ = problem()
    eng = Engine(mode="chunked", chunk_size=CHUNK, device="cpu")
    first = eng.serve(prog, pg, queries[:4], num_lanes=2)
    second = eng.serve(prog, pg, queries[:4], num_lanes=2)
    assert not first.cache_hit and second.cache_hit
    assert first.compile_time_s > 0 and second.compile_time_s == 0
    assert (eng.compiles, eng.cache_hits) == (1, 1)
    assert second.engine_compiles == 1 and second.engine_cache_hits == 1
    for a, b in zip(first.records, second.records):
        np.testing.assert_array_equal(a.output, b.output)
        assert (a.lane, a.steps, a.bytes_by_channel) == (
            b.lane, b.steps, b.bytes_by_channel)
    eng.serve(prog, pg, queries[:4], num_lanes=3)  # another shape: a miss
    assert eng.compiles == 2


# --- quarantine and fault injection ----------------------------------------


def test_fault_injection_isolates_failures():
    queries = problem()[-1]
    got, want = serve_both(at_once(queries), num_lanes=3,
                           faults=[(2, 1, "overflow"), (5, 2, "exhaust")])
    check(got, want, len(queries))
    assert got.failed_qids == [2] and got.num_failed == 1
    bad, ex = got.records[2], got.records[5]
    assert bad.status == "overflow" and bad.injected and bad.output is None
    assert not bad.halted and bad.channels == ()
    assert ex.status == "exhausted" and ex.injected and not ex.halted
    assert ex.output is not None and ex.steps >= 2
    assert all(r.status == "ok" for r in got.records if r.qid not in (2, 5))


def test_on_fault_raise_reports_qids():
    queries = problem()[-1]
    _, _, pg, _, prog, _ = problem()
    with pytest.raises(errors.ChannelOverflowError) as err:
        engine().serve(prog, pg, queries, num_lanes=3,
                       faults=[FaultSpec(qid=1, at_step=0)],
                       on_fault="raise")
    assert err.value.qids == (1,)


def test_a_quarantined_lane_is_recycled():
    queries = problem()[-1]
    got, want = serve_both(at_once(queries), num_lanes=2,
                           faults=[(0, 0, "overflow")])
    check(got, want, len(queries))
    assert got.failed_qids == [0]
    assert any(r.lane == got.records[0].lane for r in got.records[1:])


def test_straggler_monitor_reports():
    queries = problem()[-1]
    _, _, pg, _, prog, _ = problem()
    res = engine().serve(prog, pg, queries, num_lanes=3)
    assert isinstance(res.straggler_dispatches, list)
    assert res.dispatch_median_s > 0.0
    mon = StragglerMonitor(min_samples=3)
    assert [mon.record(i, t) for i, t in enumerate([1.0, 1.0, 1.0, 9.0])] \
        == [False, False, False, True]
    assert mon.flags == 1 and mon.median == 1.0


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultSpec(qid=0, at_step=0, kind="meteor")
    with pytest.raises(ValueError, match="at_step"):
        FaultSpec(qid=0, at_step=-1)
    with pytest.raises(ValueError, match="duplicate"):
        as_faults([(0, 1, "overflow"), (0, 2, "exhaust")])
    assert as_faults([(3, 1, "exhaust")]) == {3: FaultSpec(3, 1, "exhaust")}
    _, _, pg, _, prog, queries = problem()
    with pytest.raises(ValueError, match="on_fault"):
        engine().serve(prog, pg, queries, on_fault="panic")


def test_serve_rejects_query_less_programs_and_bad_lanes():
    spec = REGISTRY["wcc:basic"]
    pg = pgraph.partition_graph(spec.make_graph(6, SEED), W, "random",
                                build=spec.build, device="cpu")
    with pytest.raises(ValueError, match="query axis"):
        engine().serve(spec.factory(), pg, [0])
    _, _, pg2, _, prog, queries = problem()
    with pytest.raises(ValueError, match="lane"):
        engine().serve(prog, pg2, queries, num_lanes=0)


# --- queue and schedule plumbing -------------------------------------------


def test_query_queue_order_and_api():
    q = QueryQueue()
    assert q.push("a", 5) == 0 and q.push("b", 5) == 1 and q.push("c") == 2
    assert len(q) == 3 and q.next_arrival() == 0
    assert q.pop_ready(0).query == "c"
    assert q.pop_ready(0) is None
    assert q.next_arrival() == 5 and q.peek_query() == "a"
    first, second = q.pop_ready(5), q.pop_ready(5)
    assert (first.query, second.query) == ("a", "b")  # FIFO tie-break
    with pytest.raises(ValueError):
        q.push("x", -1)


def test_poisson_arrivals_deterministic_and_the_jax_times():
    a = poisson_arrivals(32, rate=0.5, seed=7)
    assert a == poisson_arrivals(32, rate=0.5, seed=7)
    assert a == jpoisson_arrivals(32, rate=0.5, seed=7)
    assert a != poisson_arrivals(32, rate=0.5, seed=8)
    assert all(x <= y for x, y in zip(a, a[1:]))
    with pytest.raises(ValueError):
        poisson_arrivals(4, rate=0.0)


def test_program_spec_stream_is_the_jax_schedule():
    graph = problem()[0]
    s1 = REGISTRY[KEY].stream(graph, seed=3, q=6, rate=0.5)
    assert s1 == REGISTRY[KEY].stream(graph, seed=3, q=6, rate=0.5)
    assert s1 == jalgorithms.REGISTRY[KEY].stream(graph, seed=3, q=6,
                                                  rate=0.5)
    assert [q for _, q in s1] == list(REGISTRY[KEY].queries(graph, 3, 6))


def test_a_poisson_stream_through_sssp():
    """``sssp:basic``'s own recipe, served from its Poisson stream."""
    spec, jspec = REGISTRY["sssp:basic"], jalgorithms.REGISTRY["sssp:basic"]
    graph = spec.make_graph(7, SEED)
    jpg = jpgraph.partition_graph(graph, W, "random", build=jspec.build)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    schedule = spec.stream(graph, SEED, 6, rate=0.5)
    got = Engine(mode="chunked", chunk_size=2, device="cpu").serve(
        spec.factory(), pg, QueryQueue.from_schedule(schedule), num_lanes=2)
    want = JEngine(mode="chunked", chunk_size=2).serve(
        jspec.factory(), jpg, JQueryQueue.from_schedule(schedule),
        num_lanes=2)
    assert_matches_jax(got, want)
    assert_session_invariants(got, 6)
    host = Engine(mode="host", device="cpu")
    for rec in got.records:
        ref = host.run(spec.factory(source=rec.query), pg)
        np.testing.assert_array_equal(rec.output, ref.output)
        assert (rec.steps, rec.bytes_by_channel) == (ref.steps,
                                                     ref.bytes_by_channel)
    lat = got.latency_summary()
    assert lat["p50_steps"] == want.latency_summary()["p50_steps"]
    assert got.queries_per_s > 0

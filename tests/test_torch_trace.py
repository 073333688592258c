"""The port's span recorder (``repro_torch.tracing``) on the CPU.

    PYTHONPATH=src python -m pytest tests/test_torch_trace.py

With recording off nothing is recorded, and a recorded run is bit for
bit the unrecorded one (state, supersteps, bytes, messages, outputs) for
``sv:composed`` and ``sssp:prop`` in host, fused and chunked mode. Spans
nest inside their parents; a served query's spans share its ``qid``; the
``inner:`` spans count the programs' own rounds; ``host_overhead_s`` and
``step_times_s`` are what the loop's dispatch, readback and accounting
spans give; a device loop built outside ``recording()`` is not replayed
inside it, nor the other way round. The clock mapping, the pairing of
device stamps and the attribution of the device's gaps are held as pure
functions. On the CPU every site records a host span; the device stamps
are held on the card (``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.algorithms import REGISTRY, common
from repro_torch.core.channel import ChannelContext
from repro_torch.graph import pgraph
from repro_torch.pregel.engine import Engine
from repro_torch.pregel.serve import QueryQueue

W = 4
MODES = [("host", 64), ("fused", 64), ("chunked", 2)]
MODE_IDS = ["host", "fused", "chunked2"]

_problems = {}


def _problem(key):
    if key not in _problems:
        spec = REGISTRY[key]
        g = spec.make_graph(8, 0)
        pg = pgraph.partition_graph(g, W, "random", build=spec.build,
                                    device="cpu")
        _problems[key] = (spec, g, pg, spec.inputs(g, 0))
    return _problems[key]


def _counts(ex, rid=None, name=None):
    """{span name: count} of an export (one request id when given), or
    the count of one name."""
    sp = ex["spans"]
    keep = np.ones(len(sp["name"]), bool) if rid is None else sp["rid"] == rid
    ids, n = np.unique(sp["name"][keep], return_counts=True)
    out = {ex["names"][i]: int(c) for i, c in zip(ids, n)}
    return out if name is None else out.get(name, 0)


def _spans(ex, name, rid=None):
    """(start, end) rows of the spans called ``name``, in start order."""
    sp = ex["spans"]
    keep = sp["name"] == ex["names"].index(name)
    if rid is not None:
        keep &= sp["rid"] == rid
    rows = np.column_stack([sp["start_ns"][keep], sp["end_ns"][keep]])
    return rows[np.argsort(rows[:, 0], kind="stable")]


def _same_run(a, b):
    assert (a.steps, a.halted) == (b.steps, b.halted)
    assert a.bytes_by_channel == b.bytes_by_channel
    assert a.msgs_by_channel == b.msgs_by_channel
    assert a.state.keys() == b.state.keys()
    for k in a.state:
        assert torch.equal(a.state[k], b.state[k])
    np.testing.assert_array_equal(np.asarray(a.output), np.asarray(b.output))


def test_off_records_nothing_and_costs_one_check():
    assert tracing.active() is None
    assert tracing.span("x") is tracing.NULL
    assert tracing.device_span("x", torch.device("cpu")) is tracing.NULL
    assert tracing.host_span("x") is None and tracing.run_rid() is None
    spec, _, pg, inputs = _problem("sssp:prop")
    Engine(mode="host", device="cpu").run(spec.factory(**inputs), pg)
    with tracing.recording(device="cpu") as rec:
        pass
    ex = rec.export()
    assert len(ex["spans"]["name"]) == 0
    assert ex["dropped"] == 0 and ex["stamps"] == 0
    assert tracing.active() is None
    with tracing.recording(device="cpu"):
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.recording(device="cpu"):
                pass


@pytest.mark.parametrize("key", ["sv:composed", "sssp:prop"])
@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_recorded_runs_are_bit_identical(key, mode, k):
    spec, _, pg, inputs = _problem(key)
    prog = spec.factory(**inputs)
    eng = Engine(mode=mode, chunk_size=k, device="cpu")
    plain = eng.run(prog, pg)
    with tracing.recording(device="cpu") as rec:
        traced = eng.run(prog, pg)
    _same_run(plain, traced)
    ex = rec.export()
    assert _counts(ex, name="superstep") == traced.steps
    assert _counts(ex, name="engine.run") == 1
    assert _counts(ex, name="loop.dispatch") == traced.dispatches
    assert _counts(ex, name="engine.extract") == 1
    assert any(n.startswith("channel:") for n in _counts(ex))
    # the CPU runs the kernels' plain versions, which are no kernel spans
    assert not any(n.startswith("kernel:") for n in _counts(ex))


def _nested(ex):
    sp = ex["spans"]
    p = sp["parent"]
    has = p >= 0
    assert (sp["start_ns"][has] >= sp["start_ns"][p[has]]).all()
    assert (sp["end_ns"][has] <= sp["end_ns"][p[has]]).all()
    assert (sp["end_ns"] >= sp["start_ns"]).all()


def test_spans_nest_and_a_served_query_shares_its_qid():
    spec, g, pg, _ = _problem("sssp:prop")
    eng = Engine(mode="chunked", chunk_size=2, device="cpu")
    schedule = spec.stream(g, 0, 7, rate=0.5)
    with tracing.recording(device="cpu") as rec:
        pgraph.partition_graph(g, W, "random", build=spec.build,
                               device="cpu")
        eng.run(spec.factory(**spec.inputs(g, 0)), pg)
        res = eng.serve(spec.factory(), pg, QueryQueue.from_schedule(
            schedule), num_lanes=3, chunk_size=2)
    ex = rec.export()
    _nested(ex)
    counts = _counts(ex)
    for name in ("graph.partition", "partition.assign", "partition.route_cap",
                 "partition.to_device", "engine.plan", "engine.init",
                 "engine.execute", "loop.build", "engine.serve",
                 "serve.admit", "serve.dispatch", "serve.harvest"):
        assert counts.get(name, 0) >= 1, name
    assert counts["serve.dispatch"] == res.dispatches
    assert counts["superstep"] == 1 + res.supersteps  # the job's, and the
    # session's executed supersteps
    names = ex["names"]
    sp = ex["spans"]
    harvest = names.index("serve.harvest")
    query = np.array([n.startswith("query.") for n in names])[sp["name"]]
    assert len(res.records) == 7
    for r in res.records:
        mine = np.flatnonzero(query & (sp["rid"] == r.qid))
        assert [names[n] for n in sp["name"][mine]] == ["query.harvest"]
        assert sp["name"][sp["parent"][mine[0]]] == harvest


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_inner_rounds_are_the_programs_own(mode, k):
    spec, _, pg, inputs = _problem("sssp:prop")
    eng = Engine(mode=mode, chunk_size=k, device="cpu")
    with tracing.recording(device="cpu") as rec:
        res = eng.run(spec.factory(**inputs), pg)
    ex = rec.export()
    rounds = int(res.state["info"][0, 0])
    assert rounds > 1
    assert _counts(ex, rid=0, name="inner:propagation.round") == rounds
    assert _counts(ex, rid=0, name="inner:propagation.local") > rounds
    sp = ex["spans"]
    step = ex["names"].index("superstep")
    for i in np.flatnonzero(sp["name"] == ex["names"].index(
            "inner:propagation.round")):
        while sp["name"][i] != step:  # a round lies inside a superstep
            i = sp["parent"][i]
            assert i >= 0


def test_pointer_jumping_rounds_are_its_own():
    _, _, pg, _ = _problem("wcc:prop")
    rng = np.random.default_rng(3)
    mask = np.asarray(pg.v_mask)
    ids = np.arange(W * pg.n_loc).reshape(W, pg.n_loc)
    perm = rng.permutation(ids[mask])
    par = (rng.random(len(perm)) * np.arange(len(perm))).astype(np.int64)
    parents = ids.copy()
    parents.reshape(-1)[perm] = perm[par]
    ctx = ChannelContext(W, pg.n_loc, torch.device("cpu"))
    with tracing.recording(device="cpu") as rec:
        _, rounds = common.pj_converge(
            ctx, torch.from_numpy(parents.astype(np.int32)),
            torch.from_numpy(mask))
    ex = rec.export()
    assert rounds > 2
    assert _counts(ex, name="inner:pointer_jumping") == rounds


@pytest.mark.parametrize("batched", [False, True], ids=["solo", "batched"])
@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_overhead_and_step_times_are_the_loop_spans(mode, k, batched):
    spec, g, pg, inputs = _problem("sssp:prop")
    eng = Engine(mode=mode, chunk_size=k, device="cpu")
    with tracing.recording(device="cpu") as rec:
        if batched:
            res = eng.run_batch(spec.factory(), pg, spec.queries(g, 0, 3))
        else:
            res = eng.run(spec.factory(**inputs), pg)
    ex = rec.export()
    d = _spans(ex, "loop.dispatch")
    r = _spans(ex, "loop.readback")
    a = _spans(ex, "loop.account")
    assert len(d) == len(r) == len(a) == res.dispatches
    assert (d[:, 1] == r[:, 0]).all() and (r[:, 1] == a[:, 0]).all()
    np.testing.assert_allclose(res.step_times_s, (r[:, 1] - d[:, 0]) * 1e-9,
                               rtol=0, atol=1e-12)
    tot = _spans(ex, "loop.totals") if "loop.totals" in ex["names"] else []
    want = (np.diff(d).sum() + np.diff(a).sum()
            + (np.diff(tot).sum() if len(tot) else 0)) * 1e-9
    assert res.host_overhead_s == pytest.approx(want, abs=1e-12)


def test_loop_cache_keys_the_recording_state():
    spec, _, pg, inputs = _problem("sv:composed")
    prog = spec.factory(**inputs)
    eng = Engine(mode="fused", device="cpu")
    assert not eng.run(prog, pg).cache_hit
    with tracing.recording(device="cpu") as rec:
        inside = [eng.run(prog, pg).cache_hit for _ in range(2)]
    assert inside == [False, True]
    assert eng.run(prog, pg).cache_hit and eng.stats()["compiles"] == 2
    assert _counts(rec.export(), name="loop.build") == 1


def test_a_profiler_sees_the_host_spans_without_recording():
    from torch.profiler import ProfilerActivity, profile

    spec, _, pg, inputs = _problem("sssp:prop")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        Engine(mode="host", device="cpu").run(spec.factory(**inputs), pg)
    names = {e.name for e in prof.events()}
    for name in ("engine.run", "engine.extract", "loop.dispatch",
                 "loop.readback"):
        assert name in names, name
    assert tracing.active() is None


def test_clock_mapping_interpolates_between_calibrations():
    # host = device + 1000 at device 0, + 1100 at device 1000
    points = np.array([[1000, 0, 5], [2100, 1000, 5]], np.int64)
    got = tracing.to_host(np.array([-50, 0, 500, 1000, 3000]), points)
    assert got.tolist() == [950, 1000, 1550, 2100, 4100]
    brackets = np.array([
        [990, 1010, 0, 0], [980, 1040, 5, 0],  # narrowest first: 1000
        [2096, 2104, 1000, 1], [2000, 2050, 990, 1]], np.int64)
    pts, residual = tracing.calibration_points(brackets)
    assert pts.tolist() == [[1000, 0, 10], [2100, 1000, 4]]
    # device 990 maps to 2089, 39 ns past its bracket's end
    assert residual == 39.0
    assert tracing.to_host(np.array([7]), np.zeros((0, 3), np.int64)) == 7
    assert tracing.granularity(np.array([64, 0, 96, 96, 224])) == 32
    assert tracing.granularity(np.array([5])) == 0


def test_stamps_pair_by_nesting():
    a, b, c = (2 * tracing.name_id(n) for n in ("t.a", "t.b", "t.c"))
    # a( b( c() c() ) b() ) a()
    sites = [a, b, c, c + 1, c, c + 1, b + 1, b, b + 1, a + 1, a, a + 1]
    begin, end, parent, unpaired = tracing.pair(np.array(sites))
    got = sorted(zip(begin.tolist(), end.tolist(), parent.tolist()))
    assert got == [(0, 9, -1), (1, 6, 0), (2, 3, 1), (4, 5, 1), (7, 8, 0),
                   (10, 11, -1)]
    assert unpaired == 0
    # a drop cuts the sequence short: the open ones are left unpaired
    _, _, _, unpaired = tracing.pair(np.array(sites[:8]))
    assert unpaired == 2
    stamps = np.array([[s, 100 + i, 7, 0, 3] for i, s in enumerate(sites)],
                      np.int64)
    rows, bad = tracing.device_spans(stamps, np.zeros((0, 3), np.int64),
                                     base=10)
    assert bad == 0 and len(rows) == 6
    assert rows[:, 3].tolist() == [3, 10, 11, 11, 10, 3]  # owner, then rows
    assert (rows[:, 4] == 7).all() and (rows[:, 5] == tracing.DEVICE).all()


def test_gaps_go_to_the_innermost_host_span():
    host = np.array([[0, 100], [10, 40], [20, 30], [60, 90]], np.int64)
    gaps = np.array([[21, 25], [32, 38], [41, 49], [95, 99], [101, 120]],
                    np.int64)
    assert tracing.attribute(gaps, host).tolist() == [2, 1, 0, 0, -1]
    step, outer = tracing.name_id("superstep"), tracing.name_id("t.outer")
    names = list(tracing._names)
    spans = np.array([
        [outer, 0, 1000, -1, 0, tracing.HOST],
        [step, 100, 200, 0, 0, tracing.DEVICE],
        [step, 150, 300, 0, 0, tracing.DEVICE],  # overlaps: merged
        [step, 400, 500, 0, 0, tracing.DEVICE],
        [step, 1100, 1200, 0, 0, tracing.DEVICE]], np.int64)
    gaps = tracing.superstep_gaps(spans, names)
    assert gaps["start_ns"].tolist() == [300, 500]
    assert gaps["end_ns"].tolist() == [400, 1100]
    assert gaps["name"].tolist() == [outer, outer]

"""The batched query plane in the port's device modes on the CPU:
``Engine(mode="fused"|"chunked").run_batch`` against the port's host-mode
``run_batch`` and the JAX package's ``Engine(mode=same).run_batch``.

For ``reach:basic`` and ``sssp:basic`` at (W, scale) = (4, 8), Q in
{1, 3, 8}, in ``fused``, ``chunked`` at K=2 and ``chunked`` at K=3: the
same numpy graph and sources go through both packages, and every run is
bit-identical to the port's host mode and to the JAX same mode —
outputs, per-query steps, halts, bytes and msgs, and the all-zero pad
audit (the combiner is ``min``, exact in any order: tolerance 0). On the
CPU the device loop runs each step under a guard that raises on host
syncs, so these runs also hold the union CombinedMessage to what a CUDA
graph capture allows.

Then the failure contract per mode (a capacity overflow names the same
lanes and superstep as the JAX package; an int32 wrap raises at the
same superstep), the cache (a second batch of the same bucket replays,
and the pad mask is an input of each run, not of the cached loop) and
the default mode.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro import algorithms as jalgorithms
from repro.graph import pgraph as jpgraph
from repro.pregel import errors as jerrors
from repro.pregel.engine import Engine as JEngine
from repro.pregel.program import VertexProgram as JVertexProgram
from repro_torch.algorithms import REGISTRY
from repro_torch.graph import pgraph
from repro_torch.pregel import errors
from repro_torch.pregel.engine import Engine
from repro_torch.pregel.program import VertexProgram
from test_torch_batch import _overflow_programs
from test_torch_graph import jax_tables

W, SCALE, SEED = 4, 8, 0
#: the union CombinedMessage programs, exact against the JAX package (the
#: other batched programs: tests/test_torch_personal.py and
#: tests/test_torch_batch_routed.py)
KEYS = ("reach:basic", "sssp:basic")
MODES = [("fused", 64), ("chunked", 2), ("chunked", 3)]
MODE_IDS = [f"{m}{k}" for m, k in MODES]


@functools.lru_cache(maxsize=None)
def problem(key):
    """(graph, JAX partition, port partition on the CPU, 8 sources), the
    port's partition made from the JAX one's tables."""
    spec = REGISTRY[key]
    graph = spec.make_graph(SCALE, SEED)
    jpg = jpgraph.partition_graph(graph, W, "random",
                                  build=jalgorithms.REGISTRY[key].build)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    return graph, jpg, pg, spec.queries(graph, SEED, 8)


@functools.lru_cache(maxsize=None)
def host_batch(key, q):
    _, _, pg, queries = problem(key)
    return Engine(mode="host", device="cpu").run_batch(
        REGISTRY[key].factory(), pg, queries[:q])


def _same_lanes(got, want, q):
    """Equal per-query views, totals and pad audit."""
    assert got.num_queries == want.num_queries == q
    assert (got.steps, got.halted) == (want.steps, want.halted)
    np.testing.assert_array_equal(got.query_steps,
                                  np.asarray(want.query_steps))
    np.testing.assert_array_equal(got.query_halted,
                                  np.asarray(want.query_halted))
    for qi in range(q):
        np.testing.assert_array_equal(got.outputs[qi],
                                      np.asarray(want.outputs[qi]))
        assert got.query_bytes(qi) == want.query_bytes(qi)
        assert got.query_msgs(qi) == want.query_msgs(qi)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel
    assert (got.num_pad_lanes, got.pad_steps, got.pad_bytes,
            got.pad_msgs) == (want.num_pad_lanes, want.pad_steps,
                              want.pad_bytes, want.pad_msgs)
    assert (got.pad_steps, got.pad_bytes, got.pad_msgs) == (0, 0, 0)


@pytest.mark.parametrize("q", [1, 3, 8])
@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("key", KEYS)
def test_batched_device_mode_matches_host_and_jax(key, mode, k, q):
    graph, jpg, pg, queries = problem(key)
    host = host_batch(key, q)
    res = Engine(mode=mode, chunk_size=k, device="cpu").run_batch(
        REGISTRY[key].factory(), pg, queries[:q])
    assert res.mode == mode and host.mode == "host"
    _same_lanes(res, host, q)
    assert res.state.keys() == host.state.keys()
    for name, v in host.state.items():
        assert torch.equal(res.state[name], v), name
    for name, v in host.overflow_by_channel.items():
        np.testing.assert_array_equal(res.overflow_by_channel[name], v)
    assert res.dispatches == math.ceil(res.steps / min(k, res.steps))
    assert len(res.step_times_s) == res.dispatches
    assert res.host_overhead_s > 0 and host.dispatches == host.steps
    jspec = jalgorithms.REGISTRY[key]
    want = JEngine(mode=mode, chunk_size=k).run_batch(
        jspec.factory(), jpg, queries[:q])
    _same_lanes(res, want, q)


@pytest.mark.parametrize("mode,k", [("host", 1)] + MODES,
                         ids=["host"] + MODE_IDS)
def test_batched_overflow_names_the_lanes_like_jax_in_every_mode(mode, k):
    _, jpg, pg, queries = problem("reach:basic")
    jprog, prog = _overflow_programs()
    with pytest.raises(jerrors.ChannelOverflowError) as jerr:
        JEngine(mode=mode, chunk_size=k).run_batch(jprog, jpg, queries[:5])
    with pytest.raises(errors.ChannelOverflowError) as err:
        Engine(mode=mode, chunk_size=k, device="cpu").run_batch(
            prog, pg, queries[:5])
    assert 0 < len(err.value.qids) < 5
    assert err.value.qids == jerr.value.qids
    assert err.value.superstep == jerr.value.superstep == 0
    assert err.value.channels == jerr.value.channels == ("combined_message",)
    res, jres = err.value.result, jerr.value.result
    assert res.mode == mode
    for qi in range(5):
        assert res.query_bytes(qi) == jres.query_bytes(qi)


def _wrap_programs():
    """A step whose per-step int32 traffic wraps on every lane, and that
    never halts."""

    def jstep(ctx, gs, state, i):
        ctx.add_traffic("big", 2**31 - 1, 1)
        ctx.add_traffic("big", 2**31 - 1, 1)
        return state, False

    def step(ctx, gs, state, i):
        ctx.add_traffic("big", 2**31 - 1, 1)
        ctx.add_traffic("big", 2**31 - 1, 1)
        return state, False

    return (JVertexProgram("wrap", lambda pg: {"x": pg.v_mask}, jstep,
                           query_init=lambda pg, q: {"x": pg.v_mask}),
            VertexProgram("wrap", lambda pg: {"x": pg.v_mask}, step,
                          query_init=lambda pg, q: {"x": pg.v_mask}))


@pytest.mark.parametrize("mode,k", [("host", 1)] + MODES,
                         ids=["host"] + MODE_IDS)
def test_batched_int32_wrap_raises_at_the_jax_superstep(mode, k):
    """Host and chunked stop at the step or chunk whose per-step total
    went negative and name the channel; fused trips its global latch and
    runs on to ``max_steps``, with the JAX package's message."""
    _, jpg, pg, _ = problem("reach:basic")
    jprog, prog = _wrap_programs()
    with pytest.raises(jerrors.TrafficWrapError) as jerr:
        JEngine(mode=mode, chunk_size=k).run_batch(jprog, jpg, [0, 1, 2],
                                                   max_steps=4)
    with pytest.raises(errors.TrafficWrapError) as err:
        Engine(mode=mode, chunk_size=k, device="cpu").run_batch(
            prog, pg, [0, 1, 2], max_steps=4)
    assert err.value.superstep == jerr.value.superstep
    if mode == "fused":
        assert str(err.value) == str(jerr.value)
    else:
        assert err.value.channels == ("big",)


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_a_batch_of_the_same_bucket_replays_with_its_own_pad_lanes(mode, k):
    """Q=4 then Q=3 of the same sources: one loop (the cap-4 bucket), the
    second run a cache hit whose pad lane is dead and whose real lanes
    equal the first run's; the first result is not overwritten."""
    _, _, pg, queries = problem("sssp:basic")
    eng = Engine(mode=mode, chunk_size=k, device="cpu")
    prog = REGISTRY["sssp:basic"].factory()
    four = eng.run_batch(prog, pg, queries[:4])
    kept = {name: v.clone() for name, v in four.state.items()}
    three = eng.run_batch(prog, pg, queries[:3])
    assert not four.cache_hit and three.cache_hit
    assert four.compile_time_s > 0 and three.compile_time_s == 0
    assert (eng.compiles, eng.cache_hits, eng.cache_size) == (1, 1, 1)
    assert (three.num_pad_lanes, three.pad_steps, three.pad_bytes) == (
        1, 0, 0)
    for qi in range(3):
        np.testing.assert_array_equal(three.outputs[qi], four.outputs[qi])
        assert three.query_bytes(qi) == four.query_bytes(qi)
        assert int(three.query_steps[qi]) == int(four.query_steps[qi])
    _same_lanes(three, host_batch("sssp:basic", 3), 3)
    for name, v in kept.items():
        assert torch.equal(four.state[name], v)
    eng.run_batch(prog, pg, queries[:5])  # the cap-8 bucket: a miss
    assert eng.compiles == 2
    eng.clear_cache()
    assert eng.cache_size == 0


def test_the_default_mode_is_fused_and_runs_batches():
    _, _, pg, queries = problem("reach:basic")
    eng = Engine(device="cpu")
    assert eng.mode == "fused"
    res = eng.run_batch(REGISTRY["reach:basic"].factory(), pg, queries[:3])
    assert res.mode == "fused" and res.dispatches == 1
    _same_lanes(res, host_batch("reach:basic", 3), 3)

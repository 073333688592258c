"""The port's device modes (``fused``, ``chunked``) on the CPU: the
counterpart of ``tests/test_runtime_fused.py``.

For each of the 13 programs whose superstep has no inner loop, at
(W, scale) = (4, 8), in ``fused``, ``chunked`` at K=2 and ``chunked`` at
K=3: the port's run equals its own host mode bit for bit (state,
outputs, supersteps, halts, bytes, messages and overflow flags per
channel) and the JAX package's ``Engine(mode=same)`` on the same numpy
inputs (integer outputs exact; PageRank's float32 ranks to rtol 1e-5,
the sums in another order — ROADMAP fault 4). On the CPU the device
loop runs each step under a guard that raises on host syncs, so these
runs also hold the step code to what a CUDA graph capture allows.

Then the loop's edge cases: ``max_steps`` without a halt, a ``channels=``
declaration (an undeclared key raises), a capacity overflow and an int32
wrap raising the JAX package's error in every mode at the same
superstep, ``dispatches == ceil(steps / K)`` and a cached second run
that leaves the first result as it was. The seven programs with an inner
loop are in ``tests/test_torch_fused_inner.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro import algorithms as jalgorithms
from repro.core import message as jmsg
from repro.graph import pgraph as jpgraph
from repro.pregel import errors as jerrors
from repro.pregel import runtime as jruntime
from repro.pregel.engine import Engine as JEngine
from repro_torch.algorithms import REGISTRY
from repro_torch.core import message as msg
from repro_torch.graph import pgraph
from repro_torch.pregel import errors, runtime
from repro_torch.pregel.engine import Engine
from test_torch_graph import jax_tables

DEVICE_KEYS = ["wcc:basic", "wcc:switch", "sv:basic", "sv:reqresp",
               "sv:scatter", "sv:both", "sv:monolithic", "pagerank:basic",
               "pagerank:scatter", "pj:basic", "pj:reqresp", "sssp:basic",
               "reach:basic"]
MODES = [("fused", 64), ("chunked", 2), ("chunked", 3)]
W, SCALE = 4, 8


_graphs = {}
_host = {}


def _problem(key):
    """(spec, graph, JAX partition, port partition on the CPU, inputs),
    the port's partition made from the JAX one's tables."""
    if key not in _graphs:
        spec = REGISTRY[key]
        g = spec.make_graph(SCALE, 0)
        jpg = jpgraph.partition_graph(g, W, "random", build=spec.build)
        pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
        _graphs[key] = (spec, g, jpg, pg, spec.inputs(g, 0))
    return _graphs[key]


def _host_run(key):
    if key not in _host:
        spec, _, _, pg, inputs = _problem(key)
        _host[key] = Engine(mode="host", device="cpu").run(
            spec.factory(**inputs), pg)
    return _host[key]


def _same_as_host(res, host):
    assert (res.steps, res.halted, res.converged) == (
        host.steps, host.halted, host.converged)
    assert res.bytes_by_channel == host.bytes_by_channel
    assert res.msgs_by_channel == host.msgs_by_channel
    assert res.overflow_by_channel == host.overflow_by_channel
    assert res.state.keys() == host.state.keys()
    for name, v in host.state.items():
        assert torch.equal(res.state[name], v), name
    np.testing.assert_array_equal(res.output, host.output)


@pytest.mark.parametrize("mode,k", MODES, ids=[f"{m}{k}" for m, k in MODES])
@pytest.mark.parametrize("key", DEVICE_KEYS)
def test_device_mode_matches_host_and_jax(key, mode, k):
    spec, g, jpg, pg, inputs = _problem(key)
    host = _host_run(key)
    res = Engine(mode=mode, chunk_size=k, device="cpu").run(
        spec.factory(**inputs), pg)
    assert res.mode == mode
    _same_as_host(res, host)
    want = JEngine(mode=mode, chunk_size=k).run(
        jalgorithms.get_program(key, **inputs), jpg)
    assert (res.steps, res.halted) == (want.steps, want.halted)
    assert res.bytes_by_channel == want.bytes_by_channel
    assert res.msgs_by_channel == want.msgs_by_channel
    if key.startswith("pagerank"):
        np.testing.assert_allclose(res.output, want.output, rtol=1e-5,
                                   atol=1e-9)
    else:
        np.testing.assert_array_equal(res.output, want.output)
    spec.check(g, pg, res, inputs)


@pytest.mark.parametrize("mode,k", MODES, ids=[f"{m}{k}" for m, k in MODES])
def test_max_steps_without_a_halt(mode, k):
    spec, _, jpg, pg, inputs = _problem("wcc:basic")
    assert _host_run("wcc:basic").steps > 3
    host = Engine(mode="host", device="cpu").run(spec.factory(**inputs), pg,
                                                 max_steps=3)
    res = Engine(mode=mode, chunk_size=k, device="cpu").run(
        spec.factory(**inputs), pg, max_steps=3)
    want = JEngine(mode=mode, chunk_size=k).run(
        jalgorithms.get_program("wcc:basic"), jpg, max_steps=3)
    assert res.steps == want.steps == 3
    assert not res.halted and not res.converged and not want.halted
    _same_as_host(res, host)
    assert res.bytes_by_channel == want.bytes_by_channel


def _declared_step(ctx, gs, state, i):
    ctx.add_traffic("a", 1, 1)
    x = state["x"] + 1
    return {"x": x}, (x >= 3).all(dim=1)


@pytest.mark.parametrize("mode,k", MODES, ids=[f"{m}{k}" for m, k in MODES])
def test_explicit_channel_declaration(mode, k):
    """A declaration is the key set: every declared key is reported, an
    undeclared key raises at the warm-up step, and so does a declared key
    that no step reaches (a stale or misspelled declaration)."""
    _, _, _, pg, _ = _problem("wcc:basic")
    x0 = {"x": torch.zeros((W, pg.n_loc), dtype=torch.int32)}
    res = runtime.run_supersteps(pg, _declared_step, x0, mode=mode,
                                 chunk_size=k, channels=("a",))
    assert res.steps == 3 and res.halted
    assert res.bytes_by_channel == {"a": 3 * W}
    with pytest.raises(KeyError, match="not in the registry"):
        runtime.run_supersteps(pg, _declared_step, x0, mode=mode,
                               chunk_size=k, channels=("b",))
    with pytest.raises(ValueError, match="never reached"):
        runtime.run_supersteps(pg, _declared_step, x0, mode=mode,
                               chunk_size=k, channels=("a", "c"))


def _overflow_steps(jpg, pg):
    """Steps whose routed send runs at capacity 1 from superstep 2 on (no
    message is valid before), so every mode overflows at superstep 2."""

    def jstep(ctx, gs, state, i):
        raw = gs.raw_out
        _, _, ovf = jmsg.combined_send(ctx, raw.dst_global,
                                       raw.mask & (i >= 2), raw.src_local,
                                       "min", capacity=1)
        return state, False, ovf

    def step(ctx, gs, state, i):
        raw = gs.raw_out
        _, _, ovf = msg.combined_send(ctx, raw.dst_global,
                                      raw.mask & (i >= 2), raw.src_local,
                                      "min", capacity=1)
        return state, False, ovf

    return jstep, step


@pytest.mark.parametrize("mode,k", [("host", 1)] + MODES,
                         ids=["host"] + [f"{m}{k}" for m, k in MODES])
def test_overflow_raises_at_the_same_superstep_in_every_mode(mode, k):
    _, _, jpg, pg, _ = _problem("wcc:basic")
    jstep, step = _overflow_steps(jpg, pg)
    with pytest.raises(jerrors.ChannelOverflowError) as jerr:
        jruntime.run_supersteps(jpg, jstep, {"x": jpg.v_mask}, mode=mode,
                                chunk_size=k)
    with pytest.raises(errors.ChannelOverflowError) as err:
        runtime.run_supersteps(pg, step, {"x": pg.v_mask}, mode=mode,
                               chunk_size=k)
    assert err.value.superstep == jerr.value.superstep == 2
    assert err.value.channels == jerr.value.channels == ("combined_message",)
    got, want = err.value.result, jerr.value.result
    assert got.steps == want.steps == 3
    assert got.bytes_by_channel == want.bytes_by_channel


def _wrap_step(ctx, gs, state, i):
    ctx.add_traffic("big", 2**31 - 1, 1)
    ctx.add_traffic("big", 2**31 - 1, 1)
    return state, False


@pytest.mark.parametrize("mode,k", [("host", 1)] + MODES,
                         ids=["host"] + [f"{m}{k}" for m, k in MODES])
def test_int32_wrap_raises_the_jax_error_in_every_mode(mode, k):
    """A step whose per-step int32 total wraps: host and chunked name the
    channel, fused trips its global latch — as in the JAX package."""
    _, _, jpg, pg, _ = _problem("wcc:basic")

    def jstep(ctx, gs, state, i):
        ctx.add_traffic("big", 2**31 - 1, 1)
        ctx.add_traffic("big", 2**31 - 1, 1)
        return state, False

    with pytest.raises(jerrors.TrafficWrapError) as jerr:
        jruntime.run_supersteps(jpg, jstep, {"x": jpg.v_mask}, mode=mode,
                                chunk_size=k, max_steps=4)
    with pytest.raises(errors.TrafficWrapError) as err:
        runtime.run_supersteps(pg, _wrap_step, {"x": pg.v_mask}, mode=mode,
                               chunk_size=k, max_steps=4)
    assert err.value.channels == jerr.value.channels
    assert err.value.superstep == jerr.value.superstep
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("key,k", [("wcc:basic", 2), ("pagerank:scatter", 3),
                                   ("sssp:basic", 4)])
def test_dispatches_are_steps_over_k(key, k):
    spec, _, _, pg, inputs = _problem(key)
    res = Engine(mode="chunked", chunk_size=k, device="cpu").run(
        spec.factory(**inputs), pg)
    assert res.dispatches == math.ceil(res.steps / k)
    assert len(res.step_times_s) == res.dispatches
    fused = Engine(mode="fused", device="cpu").run(spec.factory(**inputs),
                                                   pg)
    assert fused.dispatches == 1


@pytest.mark.parametrize("mode,k", MODES, ids=[f"{m}{k}" for m, k in MODES])
def test_a_second_run_is_a_cache_hit_and_keeps_the_first_result(mode, k):
    spec, _, _, pg, inputs = _problem("sv:both")
    eng = Engine(mode=mode, chunk_size=k, device="cpu")
    prog = spec.factory(**inputs)
    first = eng.run(prog, pg)
    kept = {name: v.clone() for name, v in first.state.items()}
    second = eng.run(prog, pg)
    assert not first.cache_hit and second.cache_hit
    assert (eng.compiles, eng.cache_hits, eng.cache_size) == (1, 1, 1)
    assert first.compile_time_s > 0 and second.compile_time_s == 0
    assert second.engine_compiles == 1 and second.engine_cache_hits == 1
    for name, v in kept.items():
        assert torch.equal(first.state[name], v)
        assert first.state[name] is not second.state[name]
    _same_as_host(second, _host_run("sv:both"))
    eng.run(spec.factory(**inputs), pg)  # another program object: a miss
    assert eng.compiles == 2
    eng.clear_cache()
    assert eng.cache_size == 0


def test_a_host_sync_in_a_device_step_raises_on_the_cpu():
    """The CPU path holds a device-mode step to the capture's contract:
    reading a flag back to the host raises, naming the program."""
    _, _, _, pg, _ = _problem("wcc:basic")

    def step(ctx, gs, state, i):
        x = state["x"] + 1
        return {"x": x}, bool((x > 3).all())

    x0 = {"x": torch.zeros((W, pg.n_loc), dtype=torch.int32)}
    assert runtime.run_supersteps(pg, step, x0).steps == 4  # host mode
    with pytest.raises(RuntimeError,
                       match="sync-probe: .*_local_scalar_dense"):
        runtime.run_supersteps(pg, step, x0, mode="fused", name="sync-probe")

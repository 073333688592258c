"""The port's slice end to end: ``wcc:basic`` and ``pagerank:scatter``
(and ``pagerank:basic``, whose float32 sums are CombinedMessages) through ``Engine.run`` against the JAX package's ``Engine(mode="host")``
on the identical plan, plus the runtime's failure contract.

Outputs, supersteps, halt flags and per-channel bytes/msgs must be
identical; pagerank's float ranks are held to rtol 1e-5 (float sums in
another order, ROADMAP fault 4).
"""
import numpy as np
import pytest
import torch

from repro import algorithms as jalgorithms
from repro.core import message as jmsg
from repro.graph import pgraph as jpgraph
from repro.pregel import errors as jerrors
from repro.pregel import runtime as jruntime
from repro.pregel.engine import Engine as JEngine
from repro_torch.algorithms import REGISTRY, get_program
from repro_torch.core import message as msg
from repro_torch.graph import pgraph
from repro_torch.pregel import errors, runtime
from repro_torch.pregel.engine import Engine
from test_torch_graph import jax_tables

CASES = [("wcc:basic", {}), ("pagerank:scatter", {"iters": 12}),
         ("pagerank:basic", {"iters": 12})]


@pytest.mark.parametrize("w,scale", [(4, 9), (8, 8)])
@pytest.mark.parametrize("key,knobs", CASES, ids=[k for k, _ in CASES])
def test_slice_matches_jax_engine(key, knobs, w, scale):
    spec = REGISTRY[key]
    g = spec.make_graph(scale, 0)
    jpg = jpgraph.partition_graph(g, w, "random", build=spec.build)
    want = JEngine(mode="host").run(
        jalgorithms.get_program(key, **knobs), jpg)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    got = Engine(mode="host", device="cpu").run(get_program(key, **knobs), pg)

    assert (got.steps, got.halted) == (want.steps, want.halted)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel
    if key == "wcc:basic":
        np.testing.assert_array_equal(got.output, want.output)
    else:
        np.testing.assert_allclose(got.output, want.output, rtol=1e-5,
                                   atol=1e-9)
    spec.check(g, pg, got)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        assert Engine().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine()


def test_unported_engine_options_raise_naming_roadmap(tmp_path,
                                                      monkeypatch):
    """Every engine option of the JAX package is ported: the planner
    (``plan="auto"``), once the one that raised here, plans a run that
    equals the hand-set run; an unknown plan still raises."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path))
    spec = REGISTRY["wcc:basic"]
    g = spec.make_graph(7, 0)
    jpg = jpgraph.partition_graph(g, 4, "random", build=spec.build)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    prog = get_program("wcc:basic")
    auto = Engine(device="cpu", mode="host", plan="auto").run(prog, pg)
    hand = Engine(device="cpu", mode="host").run(prog, pg)
    assert auto.plan.source == "auto" and hand.plan.source == "manual"
    np.testing.assert_array_equal(auto.output, hand.output)
    assert auto.bytes_by_channel == hand.bytes_by_channel
    with pytest.raises(ValueError, match="unknown plan"):
        Engine(device="cpu", plan="always")


def _overflow_graphs():
    g = REGISTRY["wcc:basic"].make_graph(7, 0)
    jpg = jpgraph.partition_graph(g, 4, "random", build=("raw_out",))
    return jpg, pgraph.from_arrays(*jax_tables(jpg), device="cpu")


def test_capacity_overflow_raises_like_jax():
    """A routed send at capacity 1 overflows at superstep 0 in both
    packages, attributed to the same channel; the dump row keeps the
    port's scatter in bounds."""
    jpg, pg = _overflow_graphs()

    def jstep(ctx, gs, state, i):
        raw = gs.raw_out
        _, _, ovf = jmsg.combined_send(ctx, raw.dst_global, raw.mask,
                                       raw.src_local, "min", capacity=1)
        return state, True, ovf

    def step(ctx, gs, state, i):
        raw = gs.raw_out
        _, _, ovf = msg.combined_send(ctx, raw.dst_global, raw.mask,
                                      raw.src_local, "min", capacity=1)
        return state, True, ovf

    with pytest.raises(jerrors.ChannelOverflowError) as jerr:
        jruntime.run_supersteps(jpg, jstep, {"x": jpg.v_mask}, mode="host")
    with pytest.raises(errors.ChannelOverflowError) as err:
        runtime.run_supersteps(pg, step, {"x": pg.v_mask})
    assert err.value.superstep == jerr.value.superstep == 0
    assert err.value.channels == jerr.value.channels == ("combined_message",)
    assert (err.value.result.bytes_by_channel
            == jerr.value.result.bytes_by_channel)


def test_int32_traffic_wrap_raises():
    _, pg = _overflow_graphs()

    def step(ctx, gs, state, i):
        ctx.add_traffic("big", 2**31 - 1, 1)
        ctx.add_traffic("big", 2**31 - 1, 1)
        return state, False

    with pytest.raises(errors.TrafficWrapError) as err:
        runtime.run_supersteps(pg, step, {"x": pg.v_mask})
    assert err.value.channels == ("big",) and err.value.superstep == 0


def test_declared_channels_are_enforced():
    _, pg = _overflow_graphs()

    def step(ctx, gs, state, i):
        ctx.add_traffic("a", 1, 1)
        return state, True

    res = runtime.run_supersteps(pg, step, {"x": pg.v_mask},
                                 channels=("a",))
    assert res.bytes_by_channel == {"a": pg.num_workers}
    with pytest.raises(KeyError, match="not in the registry"):
        runtime.run_supersteps(pg, step, {"x": pg.v_mask}, channels=("b",))
    with pytest.raises(ValueError, match="never reached"):
        runtime.run_supersteps(pg, step, {"x": pg.v_mask},
                               channels=("a", "c"))

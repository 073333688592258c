"""The ``sv:composed`` slice end to end: the six S-V variants,
``wcc:switch`` and ``pj:basic``/``reqresp`` through ``Engine.run``
against the JAX package's ``Engine(mode="host")`` on the identical plan.

Outputs, supersteps, halt flags and per-channel bytes/msgs must be
identical (every value is an integer id, every combiner ``min``); each
run also passes its registry oracle. On the CPU both packages run the
plain segment reductions (the JAX ``sv.program`` defaults to
``use_kernel=False``); int32 ``min`` is exact either way.
"""
import numpy as np
import pytest

from repro import algorithms as jalgorithms
from repro.algorithms import sv as jsv
from repro.core import request_respond as jrr
from repro.graph import pgraph as jpgraph
from repro.pregel import errors as jerrors
from repro.pregel import runtime as jruntime
from repro.pregel.engine import Engine as JEngine
from repro_torch.algorithms import REGISTRY, sv
from repro_torch.core import request_respond as rr
from repro_torch.graph import pgraph
from repro_torch.pregel import errors, runtime
from repro_torch.pregel.engine import Engine
from test_torch_graph import jax_tables

KEYS = [f"sv:{v}" for v in sv.VARIANTS] + ["wcc:switch", "pj:basic",
                                           "pj:reqresp"]
SETTINGS = [(4, 9), (8, 8)]


def _graphs(key, w, scale):
    spec = REGISTRY[key]
    g = spec.make_graph(scale, 0)
    jpg = jpgraph.partition_graph(g, w, "random", build=spec.build)
    return spec, g, jpg, pgraph.from_arrays(*jax_tables(jpg), device="cpu")


@pytest.mark.parametrize("w,scale", SETTINGS)
@pytest.mark.parametrize("key", KEYS)
def test_slice_matches_jax_engine(key, w, scale):
    spec, g, jpg, pg = _graphs(key, w, scale)
    inputs = spec.inputs(g, 0)
    want = JEngine(mode="host").run(
        jalgorithms.get_program(key, **inputs), jpg)
    got = Engine(mode="host", device="cpu").run(spec.factory(**inputs), pg)

    assert (got.steps, got.halted) == (want.steps, want.halted)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel
    np.testing.assert_array_equal(got.output, want.output)
    spec.check(g, pg, got, inputs)


@pytest.mark.parametrize("w,scale", SETTINGS)
def test_every_sv_variant_gives_the_same_labels(w, scale):
    """All six converge to the minimum member id; the composed one in no
    more supersteps than the unoptimized one and fewer bytes (at these
    small scales it may tie on supersteps)."""
    _, _, _, pg = _graphs("sv:basic", w, scale)
    eng = Engine(mode="host", device="cpu")
    runs = {v: eng.run(REGISTRY[f"sv:{v}"].factory(), pg)
            for v in sv.VARIANTS}
    for v, res in runs.items():
        np.testing.assert_array_equal(res.output, runs["basic"].output,
                                      err_msg=v)
    assert runs["composed"].steps <= runs["basic"].steps
    assert runs["composed"].total_bytes < runs["basic"].total_bytes


def _overflow_step(pkg_rr, stack):
    """A request at capacity 1, plain or through the composed stack."""

    def step(ctx, gs, state, i):
        d = state["D"]
        if stack is None:
            _, ovf = pkg_rr.request(ctx, d, gs.v_mask, d, capacity=1)
        else:
            _, ovf = stack.call(ctx, "pointer", d, gs.v_mask, d, capacity=1)
        return state, True, ovf

    return step


@pytest.mark.parametrize("stacked", [False, True], ids=["plain", "stacked"])
def test_request_overflow_raises_like_jax(stacked):
    """A RequestRespond at capacity 1 overflows at superstep 0 in both
    packages, latched under ``<name>/request``."""
    _, _, jpg, pg = _graphs("sv:basic", 4, 7)
    jstack = jsv.composed_channels() if stacked else None
    stack = sv.composed_channels() if stacked else None
    with pytest.raises(jerrors.ChannelOverflowError) as jerr:
        jruntime.run_supersteps(
            jpg, _overflow_step(jrr, jstack),
            {"D": jpg.global_ids().astype(np.int32)}, mode="host")
    with pytest.raises(errors.ChannelOverflowError) as err:
        runtime.run_supersteps(pg, _overflow_step(rr, stack),
                               {"D": pg.global_ids()})
    key = ("sv/pointer" if stacked else "request_respond") + "/request"
    assert err.value.channels == jerr.value.channels == (key,)
    assert err.value.superstep == jerr.value.superstep == 0
    assert (err.value.result.bytes_by_channel
            == jerr.value.result.bytes_by_channel)


def test_declared_stack_must_be_reached():
    """The composed program declares its stack; a stack component that no
    step reaches is rejected as a stale declaration."""
    _, _, _, pg = _graphs("sv:basic", 4, 7)
    stack = sv.composed_channels()

    def step(ctx, gs, state, i):
        d = state["D"]
        stack.call(ctx, "pointer", d, gs.v_mask, d, capacity=pg.n_loc)
        return state, True

    with pytest.raises(ValueError, match="sv/jump"):
        runtime.run_supersteps(pg, step, {"D": pg.global_ids()},
                               channels=stack)
    res = runtime.run_supersteps(pg, step, {"D": pg.global_ids()},
                                 channels=["sv/pointer/request",
                                           "sv/pointer/respond"])
    assert set(res.bytes_by_channel) == {"sv/pointer/request",
                                         "sv/pointer/respond"}

"""The inner loops in the port's device modes, on the CPU: the seven
programs whose superstep runs a loop of its own (``sv:composed``, both
``msf`` variants, ``scc:basic``/``prop``, ``wcc:prop``, ``sssp:prop``),
and the primitive under them (``core.channel.inner_loop``).

    PYTHONPATH=src python -m pytest tests/test_torch_fused_inner.py

Each program at (W, scale) = (4, 8) (``scc`` at its tests' (4, 7)) in
``fused``, ``chunked`` at K=2 and ``chunked`` at K=3 equals the port's
host mode bit for bit (state, the per-worker ``info``/``iters`` rows
among it, outputs, supersteps, halts, bytes, messages and overflow flags
per channel) and the JAX package's ``Engine(mode=same)`` on the same
numpy inputs (integer outputs exact, the msf forest weight to rtol 1e-5,
as ``tests/test_torch_msf.py`` holds it).

On the CPU a device loop runs each inner loop eagerly: the condition is
read outside the loop's host-sync guard and the body runs under it, so
these runs hold the bodies to what a CUDA graph capture allows, and the
carry lives in buffers that the body writes back in place, as on the
card. The primitive is held to a Python loop (zero trips, a cap, per-
worker carries kept after a worker converges, a host sync in a body
raising with the program named), and ``pj_converge``, ``cm_propagate``
and ``propagate`` inside a device loop to the JAX functions under
``jax.vmap``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import algorithms as jalgorithms
from repro.algorithms import common as jcommon
from repro.core import propagation as jprop
from repro.core.channel import ChannelContext as JContext
from repro.graph import generators as jgen
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro_torch.algorithms import REGISTRY, common
from repro_torch.core import propagation as prop
from repro_torch.core.channel import inner_loop
from repro_torch.graph import pgraph
from repro_torch.pregel import runtime
from repro_torch.pregel.engine import Engine
from test_torch_graph import jax_tables

INNER_KEYS = ["sv:composed", "msf:channels", "msf:monolithic", "scc:basic",
              "scc:prop", "wcc:prop", "sssp:prop"]
MODES = [("fused", 64), ("chunked", 2), ("chunked", 3)]
MODE_IDS = [f"{m}{k}" for m, k in MODES]
W = 4
AXIS = "w"
INT32_MAX = 2**31 - 1

_problems = {}
_host = {}


def _problem(key):
    """(spec, graph, JAX partition, port partition on the CPU, inputs),
    the port's partition made from the JAX one's tables."""
    if key not in _problems:
        spec = REGISTRY[key]
        g = spec.make_graph(7 if key.startswith("scc") else 8, 0)
        jpg = jpgraph.partition_graph(g, W, "random", build=spec.build)
        pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
        _problems[key] = (spec, g, jpg, pg, spec.inputs(g, 0))
    return _problems[key]


def _host_run(key):
    if key not in _host:
        spec, _, _, pg, inputs = _problem(key)
        _host[key] = Engine(mode="host", device="cpu").run(
            spec.factory(**inputs), pg)
    return _host[key]


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("key", INNER_KEYS)
def test_inner_loop_program_matches_host_and_jax(key, mode, k):
    spec, g, jpg, pg, inputs = _problem(key)
    host = _host_run(key)
    res = Engine(mode=mode, chunk_size=k, device="cpu").run(
        spec.factory(**inputs), pg)
    assert res.mode == mode
    assert (res.steps, res.halted, res.converged) == (
        host.steps, host.halted, host.converged)
    assert res.bytes_by_channel == host.bytes_by_channel
    assert res.msgs_by_channel == host.msgs_by_channel
    assert res.overflow_by_channel == host.overflow_by_channel
    assert res.state.keys() == host.state.keys()
    for name, v in host.state.items():
        assert torch.equal(res.state[name], v), name
    want = JEngine(mode=mode, chunk_size=k).run(
        jalgorithms.get_program(key, **inputs), jpg)
    assert (res.steps, res.halted) == (want.steps, want.halted)
    assert res.bytes_by_channel == want.bytes_by_channel
    assert res.msgs_by_channel == want.msgs_by_channel
    for counter in ("info", "iters"):  # per-worker rounds and iterations
        if counter in res.state:
            assert res.state[counter].dtype == torch.int32
            np.testing.assert_array_equal(res.state[counter],
                                          np.asarray(want.state[counter]))
    if key.startswith("msf"):
        np.testing.assert_array_equal(res.output["labels"],
                                      want.output["labels"])
        assert res.output["edges"] == want.output["edges"]
        np.testing.assert_allclose(res.output["weight"],
                                   want.output["weight"], rtol=1e-5)
        assert res.output["weight"] == host.output["weight"]
    else:
        np.testing.assert_array_equal(res.output, want.output)
        np.testing.assert_array_equal(res.output, host.output)
    spec.check(g, pg, res, inputs)


# ---------------------------------------------------------------------------
# the primitive against a Python loop
# ---------------------------------------------------------------------------


def _grid():
    return _problem("wcc:prop")[3]


def _run_loop(mode, k, loop, state0, name="inner-probe", pg=None):
    """``loop(ctx, state) -> dict`` as the one superstep of a run in
    ``mode`` on ``pg`` (default :func:`_grid`); the run's state."""

    def step(ctx, gs, state, i):
        return loop(ctx, state), True

    res = runtime.run_supersteps(pg or _grid(), step, state0, mode=mode,
                                 chunk_size=k, max_steps=1, name=name)
    assert res.steps == 1 and res.halted
    return res.state


def _counter(ctx, out):
    """A loop's counter as it comes back: a Python int in host mode, a
    0-d int32 tensor in a device loop."""
    if ctx.device_loop is None:
        assert isinstance(out, int)
        return torch.tensor(out, dtype=torch.int32)
    assert out.dtype == torch.int32 and out.dim() == 0
    return out


def _count_to(limit, cap=1 << 20):
    """x -> 3x + 1 (int32, wrapping) while the counter is below
    ``limit`` and below ``cap``; the counter starts at 0."""

    def loop(ctx, state):
        x, n, _ = inner_loop(
            ctx, lambda c: c[2] & (c[1] < cap),
            lambda c: (c[0] * 3 + 1, c[1] + 1, c[1] + 1 < limit),
            (state["x"], 0, 0 < limit))
        return {"x": x, "n": _counter(ctx, n)}

    return loop


@pytest.mark.parametrize("mode,k", [("host", 1)] + MODES,
                         ids=["host"] + MODE_IDS)
@pytest.mark.parametrize("limit,cap,trips", [(0, 99, 0), (5, 99, 5),
                                             (99, 7, 7)],
                         ids=["zero_trips", "to_the_condition",
                              "to_the_cap"])
def test_inner_loop_runs_as_a_python_loop(mode, k, limit, cap, trips):
    """Zero trips leave the carry as it was; a loop stops when its
    condition fails or at its cap, whichever comes first."""
    pg = _grid()
    x0 = torch.arange(W * pg.n_loc, dtype=torch.int32).reshape(W, pg.n_loc)
    state = _run_loop(mode, k, _count_to(limit, cap),
                      {"x": x0, "n": torch.zeros((), dtype=torch.int32)})
    want = x0.clone()
    for _ in range(trips):
        want = want * 3 + 1
    assert torch.equal(state["x"], want)
    assert int(state["n"]) == trips


@pytest.mark.parametrize("mode,k", [("host", 1)] + MODES,
                         ids=["host"] + MODE_IDS)
def test_a_converged_worker_keeps_its_carry(mode, k):
    """Per-worker carries as under ``vmap``: worker w iterates ``3 + 2w``
    times (its value doubling) and then keeps its value and its count
    while the others go on."""
    pg = _grid()
    want_iters = torch.tensor([3 + 2 * w for w in range(W)],
                              dtype=torch.int32)

    def body(c):
        v, active, iters = c
        v = torch.where(active[:, None], v * 2, v)
        iters = iters + active.to(torch.int32)
        return v, active & (iters < want_iters), iters

    def loop(ctx, state):
        v, _, iters = inner_loop(
            ctx, lambda c: c[1].any(), body,
            (state["v"], torch.ones(W, dtype=torch.bool),
             torch.zeros(W, dtype=torch.int32)))
        return {"v": v, "iters": iters}

    v0 = torch.ones((W, pg.n_loc), dtype=torch.int32)
    state = _run_loop(mode, k, loop,
                      {"v": v0, "iters": torch.zeros(W, dtype=torch.int32)})
    assert torch.equal(state["iters"], want_iters)
    assert torch.equal(state["v"], v0 << want_iters[:, None])


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_a_host_sync_in_an_inner_body_raises(mode, k):
    """A body that reads a flag back to the host breaks the capture's
    contract: in a device mode it raises, naming the program; host mode
    runs it."""
    pg = _grid()

    def loop(ctx, state):
        x, _ = inner_loop(
            ctx, lambda c: c[1],
            lambda c: (c[0] + 1, bool((c[0] < 3).all())),
            (state["x"], True))
        return {"x": x}

    x0 = {"x": torch.zeros((W, pg.n_loc), dtype=torch.int32)}
    assert int(_run_loop("host", 1, loop, x0)["x"].max()) == 4
    with pytest.raises(RuntimeError,
                       match="sync-probe: .*_local_scalar_dense"):
        _run_loop(mode, k, loop, x0, name="sync-probe")


@pytest.mark.parametrize("mode,k", MODES, ids=MODE_IDS)
def test_an_inner_body_keeps_its_carry_layout(mode, k):
    """A body that changes a carry element's dtype cannot write it back
    in place: a device loop refuses it."""
    pg = _grid()

    def loop(ctx, state):
        x, _ = inner_loop(ctx, lambda c: c[1] < 2,
                          lambda c: (c[0].float(), c[1] + 1),
                          (state["x"], 0))
        return {"x": x}

    x0 = {"x": torch.zeros((W, pg.n_loc), dtype=torch.int32)}
    with pytest.raises(ValueError, match="fixed layout"):
        _run_loop(mode, k, loop, x0)


# ---------------------------------------------------------------------------
# pj_converge, cm_propagate and propagate inside a device loop, against
# the JAX functions under jax.vmap
# ---------------------------------------------------------------------------


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _forest(pg, seed):
    """Random parents over the real vertices, crossing workers: one tree,
    its root pointing to itself; padding slots point to themselves."""
    rng = np.random.default_rng(seed)
    mask = np.asarray(pg.v_mask)
    ids = np.arange(W * pg.n_loc).reshape(W, pg.n_loc)
    perm = rng.permutation(ids[mask])
    par = (rng.random(len(perm)) * np.arange(len(perm))).astype(np.int64)
    parents = ids.copy()
    parents.reshape(-1)[perm] = perm[par]
    return parents.astype(np.int32), mask


@pytest.mark.parametrize("mode,k", [("fused", 64), ("chunked", 2)],
                         ids=["fused64", "chunked2"])
def test_pj_converge_in_a_device_loop_matches_jax(mode, k):
    spec, _, jpg, pg, _ = _problem("wcc:prop")
    parents, mask = _forest(pg, 5)

    def shard(p, m):
        c = JContext(AXIS, W, jpg.n_loc)
        roots, it = jcommon.pj_converge(c, p, m, use_reqresp=True)
        return roots, it, c.stats_bytes["pj_loop"], c.stats_msgs["pj_loop"]

    want = jax.vmap(shard, axis_name=AXIS)(parents, mask)

    def loop(ctx, state):
        roots, rounds = common.pj_converge(ctx, state["p"], state["m"])
        return {"p": roots, "m": state["m"], "rounds": _counter(ctx, rounds),
                "nb": ctx.stats_bytes["pj_loop"],
                "nm": ctx.stats_msgs["pj_loop"]}

    z = torch.zeros(W, dtype=torch.int32)
    state = _run_loop(mode, k, loop, {
        "p": torch.from_numpy(parents), "m": torch.from_numpy(mask),
        "rounds": torch.zeros((), dtype=torch.int32), "nb": z, "nm": z})
    _same(state["p"], want[0])
    assert [int(state["rounds"])] * W == np.asarray(want[1]).tolist()
    assert int(state["rounds"]) > 2
    _same(state["nb"], want[2])
    _same(state["nm"], want[3])


@pytest.mark.parametrize("mode,k", [("fused", 64), ("chunked", 2)],
                         ids=["fused64", "chunked2"])
def test_cm_propagate_in_a_device_loop_matches_jax(mode, k):
    """scc's masked CombinedMessage propagation: labels, iterations and
    the traffic of every iteration."""
    spec, _, jpg, pg, _ = _problem("scc:basic")
    rng = np.random.default_rng(3)
    alive = (rng.random((W, pg.n_loc)) < 0.8) & np.asarray(pg.v_mask)
    ids = np.arange(W * pg.n_loc, dtype=np.int32).reshape(W, pg.n_loc)
    lab0 = np.where(alive, ids, INT32_MAX).astype(np.int32)

    def shard(raw, lab, al):
        c = JContext(AXIS, W, jpg.n_loc)
        c.route_cap = jpg.route_cap
        out, it = jcommon.cm_propagate(
            c, raw, lab, "min", active0=al,
            update=lambda lab, inc, got: jnp.where(
                al, jnp.minimum(lab, inc), lab), name="b")
        return out, it, c.stats_bytes["b"], c.stats_msgs["b"]

    want = jax.vmap(shard, axis_name=AXIS)(jpg.raw_out, lab0, alive)

    def loop(ctx, state):
        al = state["alive"]
        out, iters = common.cm_propagate(
            ctx, pg.raw_out, state["lab"], "min", active0=al,
            update=lambda lab, inc, got: torch.where(
                al, torch.minimum(lab, inc), lab), name="b")
        return {"lab": out, "alive": al, "iters": _counter(ctx, iters),
                "nb": ctx.stats_bytes["b"], "nm": ctx.stats_msgs["b"]}

    z = torch.zeros(W, dtype=torch.int32)
    state = _run_loop(mode, k, loop, {
        "lab": torch.from_numpy(lab0), "alive": torch.from_numpy(alive),
        "iters": torch.zeros((), dtype=torch.int32), "nb": z, "nm": z},
        pg=pg)
    _same(state["lab"], want[0])
    assert [int(state["iters"])] * W == np.asarray(want[1]).tolist()
    assert int(state["iters"]) > 2
    _same(state["nb"], want[2])
    _same(state["nm"], want[3])


@pytest.mark.parametrize("mode,k", [("fused", 64), ("chunked", 2)],
                         ids=["fused64", "chunked2"])
@pytest.mark.parametrize("case", ["int_min", "f32_mirrored", "max_inner"])
def test_propagate_in_a_device_loop_matches_jax(case, mode, k):
    """The two nested loops (rounds, and each worker's local fixpoint)
    inside a device loop: labels, rounds, per-worker iterations and
    traffic; a mirrored cut plan; a ``max_inner`` cap."""
    if case == "f32_mirrored":
        g = jgen.rmat(8, edge_factor=4, seed=6, weighted=True)
        jpg = jpgraph.partition_graph(g, W, "random", build=("prop_out",),
                                      mirror_threshold=8)
    else:
        jpg = _problem("wcc:prop")[2]
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    ids = np.arange(W * pg.n_loc, dtype=np.int32).reshape(W, pg.n_loc)
    if case == "f32_mirrored":
        assert pg.prop_out.cut.hub_cap > 0
        lab0 = np.where(ids == 3, 0.0, np.inf).astype(np.float32)
        jkw = {"edge_transform": lambda v, ew: v + ew[:, None]}
        kw = {"edge_transform": lambda v, ew: v + ew[..., None]}
    else:
        lab0 = np.where(np.asarray(pg.v_mask), ids, INT32_MAX).astype(
            np.int32)
        jkw = kw = {"max_inner": 2} if case == "max_inner" else {}

    def shard(plan, lab):
        c = JContext(AXIS, W, jpg.n_loc)
        out, rounds, iters = jprop.propagate(c, plan, lab, "min", name="p",
                                             **jkw)
        return out, rounds, iters, c.stats_bytes["p"], c.stats_msgs["p"]

    want = jax.vmap(shard, axis_name=AXIS)(jpg.prop_out, lab0)

    def loop(ctx, state):
        out, rounds, iters = prop.propagate(ctx, pg.prop_out, state["lab"],
                                            "min", name="p", **kw)
        return {"lab": out, "rounds": _counter(ctx, rounds), "iters": iters,
                "nb": ctx.stats_bytes["p"], "nm": ctx.stats_msgs["p"]}

    z = torch.zeros(W, dtype=torch.int32)
    state = _run_loop(mode, k, loop, {
        "lab": torch.from_numpy(lab0),
        "rounds": torch.zeros((), dtype=torch.int32), "iters": z, "nb": z,
        "nm": z}, pg=pg)
    _same(state["lab"], want[0])
    assert [int(state["rounds"])] * W == np.asarray(want[1]).tolist()
    _same(state["iters"], want[2])
    _same(state["nb"], want[3])
    _same(state["nm"], want[4])
    if case == "max_inner":
        assert int(state["iters"].max()) <= 2 * int(state["rounds"])

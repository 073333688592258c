"""The port's resilient engine against the JAX engine
(``tests/test_resilience.py``'s contracts).

  1. Overflow escalation — ``Engine(on_overflow="escalate")`` turns a
     channel-capacity overflow into a bounded escalate-and-replay; the
     recovered run equals a run that had the capacity from the start,
     and its trail (attempts, channels, final ``cap_scales``, and the
     lanes' qids under ``run_batch``) is the JAX engine's on the same
     inputs. Swept over all 21 registry programs at halved caps. The
     learned scales are memoized per problem fingerprint, so a second
     run is a cache hit with no recovery.
  2. Checkpoint/resume — a chunked run resumed from any of its
     checkpoints equals the uninterrupted run (and the JAX run) in state,
     supersteps, halts and bytes and messages per channel; a resume
     replays the cached loop; a checkpoint refuses another program,
     graph shape or step budget.
  3. ``on_nonconverged``, ``converged`` in every mode, ``run_many`` and
     ``stats()``.

Both packages run the same plans (the JAX plan's leaves handed to
``pgraph.from_arrays``) from the same numpy graphs. Every comparison is
exact.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import algorithms as jalgorithms
from repro.core import message as jmsg
from repro.graph import generators as jgen
from repro.graph import pgraph as jpgraph
from repro.pregel import checkpoint as jckpt
from repro.pregel.engine import Engine as JEngine
from repro.pregel.program import VertexProgram as JVertexProgram
from repro_torch.algorithms import REGISTRY
from repro_torch.core import message as msg
from repro_torch.graph import pgraph
from repro_torch.plan import features
from repro_torch.pregel import checkpoint as ckpt_io
from repro_torch.pregel import errors
from repro_torch.pregel.engine import Engine, ManyResults, run_program
from repro_torch.pregel.program import VertexProgram
from test_torch_graph import jax_tables

SEED, W = 0, 4
MODES = ("host", "fused", "chunked")


def _both(graph, build):
    jpg = jpgraph.partition_graph(graph, W, "random", build=build)
    return jpg, pgraph.from_arrays(*jax_tables(jpg), device="cpu")


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_run(got, want):
    """Output, supersteps, halt, and bytes and messages per channel."""
    if isinstance(want.output, dict):
        for k in want.output:
            _same(got.output[k], want.output[k])
    else:
        _same(got.output, want.output)
    assert (got.steps, got.halted) == (want.steps, want.halted)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel


def _trail(recovery):
    """The escalation trail without the superstep (modes detect an
    overflow at different boundaries)."""
    return [(ev["attempt"], tuple(ev["channels"]), ev.get("qids"),
             ev["cap_scales"]) for ev in recovery or ()]


# ---------------------------------------------------------------------------
# a program that always overflows a small capacity: every vertex messages
# vertex 0, so a worker sends about n_loc messages to one peer
# ---------------------------------------------------------------------------


def jfanin(capacity: int, steps: int = 3):
    def init(pg):
        return {"acc": jnp.zeros((pg.num_workers, pg.n_loc), jnp.float32)}

    def step(ctx, gs, state, i):
        deliv = jmsg.direct_send(
            ctx, jnp.zeros((ctx.n_loc,), jnp.int32), gs.v_mask,
            {"x": jnp.ones((ctx.n_loc,), jnp.float32)}, capacity=capacity,
            name="fanin")
        got = jnp.where(deliv.mask, deliv.payload["x"], 0.0).sum()
        return ({"acc": state["acc"].at[0].add(got)}, i >= steps - 1,
                deliv.overflow)

    return JVertexProgram(name="test:fanin", init=init, step=step,
                          extract=lambda pg, s: pg.to_global(s["acc"]),
                          max_steps=steps + 2)


def fanin(capacity: int, steps: int = 3):
    def init(pg):
        return {"acc": torch.zeros((pg.num_workers, pg.n_loc),
                                   dtype=torch.float32, device=pg.device)}

    def step(ctx, gs, state, i):
        w, n = ctx.num_workers, ctx.n_loc
        deliv = msg.direct_send(
            ctx, torch.zeros((w, n), dtype=torch.int32, device=ctx.device),
            gs.v_mask, {"x": torch.ones((w, n), device=ctx.device)},
            capacity=capacity, name="fanin")
        got = torch.where(deliv.mask, deliv.payload["x"], 0.0).sum(dim=1)
        acc = state["acc"].clone()
        acc[:, 0] += got
        return {"acc": acc}, i >= steps - 1, deliv.overflow

    return VertexProgram(name="test:fanin", init=init, step=step,
                         extract=lambda pg, s: pg.to_global(s["acc"]),
                         max_steps=steps + 2)


@functools.lru_cache(maxsize=None)
def small():
    return _both(jgen.rmat(6, edge_factor=4, seed=SEED).symmetrized(),
                 ("raw_out",))


@pytest.mark.parametrize("mode", MODES)
def test_overflow_error_is_structured_in_all_modes(mode):
    _, pg = small()
    with pytest.raises(errors.ChannelOverflowError,
                       match="capacity overflow") as ei:
        Engine(mode=mode, chunk_size=2, device="cpu").run(fanin(2), pg)
    err = ei.value
    assert isinstance(err, RuntimeError) and err.superstep is not None
    assert "fanin" in err.channels
    assert err.result.overflow_by_channel["fanin"]


@pytest.mark.parametrize("mode", MODES)
def test_fanin_escalation_recovers_like_jax(mode):
    jpg, pg = small()
    ref = Engine(mode="host", device="cpu").run(fanin(1024), pg)
    res = Engine(mode=mode, chunk_size=2, device="cpu",
                 on_overflow="escalate").run(fanin(2), pg)
    want = JEngine(mode=mode, chunk_size=2,
                   on_overflow="escalate").run(jfanin(2), jpg)
    assert res.recovery and _trail(res.recovery) == _trail(want.recovery)
    assert all(ev["channels"] == ("fanin",) for ev in res.recovery)
    _same_run(res, ref)
    _same(res.output, want.output)
    assert res.steps == want.steps
    assert res.bytes_by_channel == {
        k: int(v) for k, v in want.bytes_by_channel.items()}
    assert not any(res.overflow_by_channel.values())


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_escalation_is_memoized_per_fingerprint(mode):
    _, pg = small()
    prog = fanin(2)
    eng = Engine(mode=mode, device="cpu", on_overflow="escalate")
    first = eng.run(prog, pg)
    assert first.recovery
    compiles = eng.compiles
    second = eng.run(prog, pg)
    assert second.recovery is None
    _same_run(second, first)
    if mode != "host":
        assert second.cache_hit and eng.compiles == compiles
        # the loops of the scales that overflowed were released
        assert eng.stats()["cached_executables"] == 1
    fp = features.fingerprint(prog, pg)
    assert fp.channel_class == "static" and fp.workers == W
    assert eng._learned[fp.cache_key()] == first.recovery[-1]["cap_scales"]


def test_escalate_bounded_by_max_retries():
    _, pg = small()
    eng = Engine(device="cpu", on_overflow="escalate", max_retries=1)
    with pytest.raises(errors.ChannelOverflowError) as ei:
        eng.run(fanin(1), pg)
    assert len(ei.value.result.recovery) == 1
    with pytest.raises(errors.ChannelOverflowError):
        Engine(device="cpu", on_overflow="escalate",
               max_retries=0).run(fanin(2), pg)


@functools.lru_cache(maxsize=None)
def registry_problem(key):
    jspec, spec = jalgorithms.REGISTRY[key], REGISTRY[key]
    graph = spec.make_graph(6, SEED)
    jpg, pg = _both(graph, jspec.build)
    return (jspec.factory(**jspec.inputs(graph, SEED)), jpg,
            spec.factory(**spec.inputs(graph, SEED)), pg)


@pytest.mark.parametrize("key", sorted(REGISTRY))
def test_registry_sweep_halved_caps_escalate_like_jax(key):
    """Every registry program with every capacity halved, under
    escalation: the port's run equals its plain run, and its trail and
    counts equal the JAX engine's escalated run."""
    jprog, jpg, prog, pg = registry_problem(key)
    ref = Engine(mode="host", device="cpu").run(prog, pg)
    res = Engine(mode="host", device="cpu", cap_scales={"*": 0.5},
                 on_overflow="escalate").run(prog, pg)
    want = JEngine(mode="host", cap_scales={"*": 0.5},
                   on_overflow="escalate").run(jprog, jpg)
    _same_run(res, ref)
    assert _trail(res.recovery) == _trail(want.recovery)
    assert res.steps == want.steps
    assert res.bytes_by_channel == {
        k: int(v) for k, v in want.bytes_by_channel.items()}
    assert res.msgs_by_channel == {
        k: int(v) for k, v in want.msgs_by_channel.items()}


@pytest.mark.parametrize("key", ["sv:composed", "msf:channels"])
@pytest.mark.parametrize("mode", ["fused", "chunked"])
def test_device_modes_escalate_like_host(key, mode):
    """The device modes take the host run's trail at an eighth of the
    caps, and their recovered runs equal the plain run bit for bit."""
    _, _, prog, pg = registry_problem(key)
    ref = Engine(mode="host", device="cpu").run(prog, pg)
    host = Engine(mode="host", device="cpu", cap_scales={"*": 0.125},
                  on_overflow="escalate").run(prog, pg)
    eng = Engine(mode=mode, chunk_size=3, device="cpu",
                 cap_scales={"*": 0.125}, on_overflow="escalate")
    res = eng.run(prog, pg)
    assert res.recovery and _trail(res.recovery) == _trail(host.recovery)
    _same_run(res, ref)
    again = eng.run(prog, pg)
    assert again.cache_hit and again.recovery is None
    _same_run(again, ref)


@pytest.mark.parametrize("mode", MODES)
def test_run_batch_escalation_names_the_lanes_like_jax(mode):
    key = "reach:basic"
    jspec, spec = jalgorithms.REGISTRY[key], REGISTRY[key]
    graph = spec.make_graph(7, SEED)
    jpg, pg = _both(graph, jspec.build)
    queries = [int(s) for s in spec.queries(graph, SEED, 5)]
    ref = Engine(mode="host", device="cpu").run_batch(spec.factory(), pg,
                                                      queries)
    res = Engine(mode=mode, chunk_size=2, device="cpu",
                 cap_scales={"*": 0.125},
                 on_overflow="escalate").run_batch(spec.factory(), pg,
                                                   queries)
    want = JEngine(mode="host", cap_scales={"*": 0.125},
                   on_overflow="escalate").run_batch(jspec.factory(), jpg,
                                                     queries)
    assert res.recovery and all("qids" in ev for ev in res.recovery)
    assert _trail(res.recovery) == _trail(want.recovery)
    for qi in range(len(queries)):
        _same(res.outputs[qi], ref.outputs[qi])
        assert res.query_bytes(qi) == ref.query_bytes(qi)
    _same(res.query_steps, ref.query_steps)


# ---------------------------------------------------------------------------
# convergence reporting
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def wcc_problem(scale=6):
    spec = REGISTRY["wcc:basic"]
    jpg, pg = _both(spec.make_graph(scale, SEED), spec.build)
    return jpg, pg, spec.factory()


@pytest.mark.parametrize("mode", MODES)
def test_converged_flag_mode_parity(mode):
    jpg, pg, prog = wcc_problem()
    eng = Engine(mode=mode, chunk_size=3, device="cpu")
    assert eng.run(prog, pg).converged
    short = eng.run(prog, pg, max_steps=1)
    want = JEngine(mode=mode, chunk_size=3).run(
        jalgorithms.get_program("wcc:basic"), jpg, max_steps=1)
    assert not short.converged and short.steps == 1
    assert (short.converged, short.steps) == (want.converged, want.steps)


def test_on_nonconverged_policies():
    _, pg, prog = wcc_problem()
    with pytest.raises(errors.NonConvergenceError) as ei:
        Engine(device="cpu", on_nonconverged="raise").run(prog, pg,
                                                          max_steps=1)
    assert ei.value.result is not None and ei.value.result.steps == 1
    with pytest.warns(RuntimeWarning, match="did not converge"):
        Engine(device="cpu", on_nonconverged="warn").run(prog, pg,
                                                         max_steps=1)
    assert not Engine(device="cpu").run(prog, pg, max_steps=1).converged
    with pytest.raises(ValueError, match="on_nonconverged"):
        Engine(device="cpu", on_nonconverged="explode")
    with pytest.raises(ValueError, match="on_overflow"):
        Engine(device="cpu", on_overflow="retry")
    with pytest.raises(ValueError, match="plan"):
        Engine(device="cpu", plan="bogus")
    # the planner is ported: plan="auto" constructs, and plans nothing
    # until a run asks
    auto = Engine(device="cpu", plan="auto")
    assert auto.stats() == {"compiles": 0, "cache_hits": 0,
                            "cached_executables": 0, "runs": 0}


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def ckpt_problem():
    """wcc:basic on a 10 x 10 grid: 19 supersteps, so a run passes many
    chunk boundaries."""
    jpg, pg = _both(jgen.grid2d(10), REGISTRY["wcc:basic"].build)
    return jpg, pg, REGISTRY["wcc:basic"].factory()


@pytest.mark.parametrize("k", [1, 2])
def test_checkpoint_resume_bit_identical_from_every_snapshot(tmp_path, k):
    jpg, pg, prog = ckpt_problem()
    eng = Engine(mode="chunked", chunk_size=k, device="cpu")
    full = eng.run(prog, pg, checkpoint_every=k,
                   checkpoint_dir=str(tmp_path))
    want = JEngine(mode="chunked", chunk_size=k).run(
        jalgorithms.get_program("wcc:basic"), jpg)
    _same(full.output, want.output)
    assert full.bytes_by_channel == {
        n: int(v) for n, v in want.bytes_by_channel.items()}
    ckpts = sorted(tmp_path.glob("*.ckpt"))
    assert len(ckpts) == (full.steps - 1) // k
    compiles = eng.compiles
    for path in ckpts:
        ck = ckpt_io.load(str(path))
        assert ck.step % k == 0 and ck.dispatches == ck.step // k
        resumed = eng.run(prog, pg, resume=ck)
        assert resumed.cache_hit and eng.compiles == compiles
        assert resumed.resumed_from == ck.step
        _same_run(resumed, full)
        assert resumed.converged == full.converged
        for name, v in full.state.items():
            assert torch.equal(resumed.state[name], v)
        fresh = Engine(mode="chunked", chunk_size=k, device="cpu").run(
            prog, pg, resume=str(path))
        _same_run(fresh, full)


def test_checkpoint_resume_from_path_and_latest(tmp_path):
    jpg, pg, prog = ckpt_problem()
    full = Engine(mode="chunked", chunk_size=2, device="cpu").run(
        prog, pg, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    newest = ckpt_io.latest(str(tmp_path))
    assert newest == str(sorted(tmp_path.glob("*.ckpt"))[-1])
    assert ckpt_io.latest(str(tmp_path / "none")) is None
    resumed = Engine(mode="chunked", chunk_size=2, device="cpu").run(
        prog, pg, resume=newest)
    _same_run(resumed, full)
    # the JAX engine checkpoints at the same boundaries
    jdir = tmp_path / "jax"
    JEngine(mode="chunked", chunk_size=2).run(
        jalgorithms.get_program("wcc:basic"), jpg, checkpoint_every=2,
        checkpoint_dir=str(jdir))
    jnew = jckpt.load(jckpt.latest(str(jdir)))
    ours = ckpt_io.load(newest)
    assert (ours.step, ours.dispatches) == (jnew.step, jnew.dispatches)
    assert ours.bytes_by_channel == jnew.bytes_by_channel
    _same(ours.state["lab"], jnew.state["lab"])
    # a file that is no checkpoint is refused
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"\x80\x05N.")
    with pytest.raises(ValueError, match="checkpoint"):
        ckpt_io.load(str(bad))


def test_checkpoint_validation_rejects_mismatches(tmp_path):
    _, pg, prog = ckpt_problem()
    Engine(mode="chunked", chunk_size=2, device="cpu").run(
        prog, pg, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    ck = ckpt_io.load(ckpt_io.latest(str(tmp_path)))
    assert ck.graph == ckpt_io.graph_hash(pg)
    with pytest.raises(ValueError, match="program"):
        Engine(mode="chunked", device="cpu").run(fanin(1024), small()[1],
                                                 resume=ck)
    with pytest.raises(ValueError, match="max_steps"):
        Engine(mode="chunked", chunk_size=2, device="cpu").run(
            prog, pg, max_steps=ck.max_steps + 1, resume=ck)
    _, other, _ = wcc_problem(7)
    with pytest.raises(ValueError, match="graph signature"):
        Engine(mode="chunked", chunk_size=2, device="cpu").run(
            prog, other, resume=ck)


def test_checkpoint_requires_chunked_and_dir(tmp_path):
    _, pg, prog = wcc_problem()
    for mode in ("fused", "host"):
        with pytest.raises(ValueError, match="chunked"):
            Engine(mode=mode, device="cpu").run(
                prog, pg, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Engine(mode="chunked", device="cpu").run(prog, pg,
                                                 checkpoint_every=2)


def test_graph_signature_is_the_static_surface():
    _, pg, _ = wcc_problem()
    _, same_shape = _both(REGISTRY["wcc:basic"].make_graph(6, SEED),
                          REGISTRY["wcc:basic"].build)
    assert ckpt_io.graph_hash(same_shape) == ckpt_io.graph_hash(pg)
    _, bigger, _ = wcc_problem(7)
    assert ckpt_io.graph_hash(bigger) != ckpt_io.graph_hash(pg)


# ---------------------------------------------------------------------------
# run_many, stats, run_program
# ---------------------------------------------------------------------------


def test_run_many_and_stats():
    jpg, pg, prog = wcc_problem()
    _, other, _ = wcc_problem(7)
    eng = Engine(mode="fused", device="cpu")
    res = eng.run_many(prog, [pg, pg, other, other])
    assert isinstance(res, ManyResults)
    assert res.cache_hits == [False, True, False, True]
    assert res.hit_count == 2
    assert eng.stats() == {"compiles": 2, "cache_hits": 2,
                           "cached_executables": 2, "runs": 4}
    one = run_program(prog, pg, mode="host")
    _same_run(res[0], one)
    want = JEngine(mode="fused").run_many(
        jalgorithms.get_program("wcc:basic"), [jpg, jpg])
    assert want.hit_count == 1
    _same(res[1].output, want[1].output)

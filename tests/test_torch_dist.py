"""The workers layer of ``Engine(backend="dist")``
(``repro_torch.distributed.workers``) and its launcher
(``repro_torch.launch.workers``) on four gloo CPU ranks.

Every ``GroupWorkers`` operation on a rank's row equals ``LocalWorkers``
on all W rows, row for row and bit for bit: ``me``/``own``, the tiled
exchange with and without a lane dim (int32, float32, bool), the
reduction for all six combiners on int32 and float32 (float sums whose
order matters, NaN, infinities, -0.0, ties, empty rows), the votes and
``gather``. A rank that skips a collective, or raises alone, ends its
spawn with an error within the group's timeout. On a group of one rank
``Engine(backend="dist")`` runs the device modes (uncaptured), a given
``Plan``, ``plan="auto"``, ``serve`` and checkpoints as the local
backend does, and refuses a group whose size is not the graph's W
(``tests/test_torch_dist_loops.py`` holds the same calls on four ranks).
The four ranks run once, in a module-scoped fixture.
"""
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.algorithms import REGISTRY
from repro_torch.core import combiners as cb
from repro_torch.distributed.workers import GroupWorkers, LocalWorkers
from repro_torch.graph import pgraph
from repro_torch.launch import workers as launch
from repro_torch.plan import planner as planning
from repro_torch.pregel import errors, runtime
from repro_torch.pregel.engine import Engine

W = 4
TIMEOUT_S = 30

# ---------------------------------------------------------------------------
# the per-rank functions (ranks re-import them from this module, which
# imports no JAX; tests/test_torch_gpu.py runs them on the card)
# ---------------------------------------------------------------------------

COMBINERS = ("sum", "min", "max", "or", "prod", "min_by_first")


def layer_inputs(w: int):
    """Named (W, ...) numpy inputs: exchange buffers with and without a
    lane dim (int32, float32, bool), reduce operands whose float sums
    depend on their order, NaN/inf and empty rows, vote flags, and a
    gather operand."""
    rng = np.random.default_rng(24)
    big = rng.choice(np.float32([1e8, -1e8, 1.0, 3e-8, 0.5, -7.25]),
                     size=(w, 6, 3)).astype(np.float32)
    # ((1e8 + 1) - 1e8) + 1 = 1 in index order, 0 in reverse
    big[:, 0, 0] = np.float32([1e8, 1.0, -1e8, 1.0, 0.0, 0.0, 0.0, 0.0])[:w]
    special = rng.standard_normal((w, 5, 3)).astype(np.float32)
    special[1, 0] = np.nan
    special[2, 1, 0] = np.inf
    special[0, 2, 0] = -np.inf
    special[3, 3] = -0.0
    special[:, 4, 0] = 2.5  # a min_by_first key tied on every worker
    return {
        "exchange": {
            "i32": rng.integers(-2**31, 2**31 - 1, (w, w, 5),
                                dtype=np.int64).astype(np.int32),
            "f32": rng.standard_normal((w, w, 3, 2)).astype(np.float32),
            "bool": rng.random((w, w, 6)) < 0.5,
        },
        "exchange_lanes": {
            "i32": rng.integers(0, 1000, (w, 3, w, 4)).astype(np.int32),
            "f32": rng.standard_normal((w, 2, w, 3, 2)).astype(np.float32),
        },
        "reduce": {
            "i32": rng.integers(-50, 50, (w, 4, 3)).astype(np.int32),
            "i32_edges": np.stack([np.full((4, 3), v, np.int32) for v in
                                   (2**31 - 1, -2**31, 7, 2**30)][:w]),
            "f32_order": big,
            "f32_special": special,
            "f32_empty": np.zeros((w, 0, 3), np.float32),
        },
        "votes": {
            "none": np.zeros((w, 3), bool),
            "one": np.arange(3 * w).reshape(w, 3) == 5,
            "all": np.ones((w, 3), bool),
            "all_but_one": np.arange(3 * w).reshape(w, 3) != 7,
            "mixed": rng.random((w, 3)) < 0.5,
        },
        "gather": rng.standard_normal((w, 4, 2)).astype(np.float32),
    }


def _as_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def layer_probe(rank: int, world: int, device):
    """Every ``GroupWorkers`` operation on this rank's row of
    :func:`layer_inputs`."""
    wk = GroupWorkers()
    inp = layer_inputs(world)
    mine = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[rank:rank + 1])).to(device)  # noqa: E731
    out = {"me": _as_numpy(wk.me(device)), "size": wk.size,
           "rows": wk.rows,
           "own": _as_numpy(wk.own(mine(inp["exchange"]["i32"])))}
    out["exchange"] = {k: _as_numpy(wk.exchange(mine(a)))
                       for k, a in inp["exchange"].items()}
    out["exchange_lanes"] = {k: _as_numpy(wk.exchange(mine(a), peer_dim=2))
                             for k, a in inp["exchange_lanes"].items()}
    out["reduce"] = {(k, c): _as_numpy(wk.reduce(mine(a), cb.get(c)))
                     for k, a in inp["reduce"].items() for c in COMBINERS}
    out["any"] = {k: bool(wk.any(mine(a))) for k, a in inp["votes"].items()}
    out["all"] = {k: bool(wk.all(mine(a))) for k, a in inp["votes"].items()}
    out["gather"] = _as_numpy(wk.gather(mine(inp["gather"])))
    out["gather_host"] = _as_numpy(wk.gather_host(
        torch.arange(3, dtype=torch.int64) + 10 * rank))
    out["counted"] = (wk.collectives, wk.bytes)
    return out


def one_sided(rank: int, world: int, device):
    """Rank 1 skips the collective the other ranks enter: they must fail
    at the group's timeout, never hang."""
    if rank != 1:
        flag = torch.ones(1, dtype=torch.int32)
        dist.all_reduce(flag)
    return rank


def jobs_then_resume(rank: int, world: int, device, jobs, job, data):
    """``launch.jobs.rank_jobs``, then ``job`` resumed on the group from
    the checkpoint whose file holds ``data`` (a local run's: each rank
    writes it under a name of its own): the resumed run's summary
    last."""
    import os
    import tempfile

    from repro_torch.launch import jobs as J

    done = J.rank_jobs(rank, world, device, jobs)
    problems = J.Problems()
    spec, _, inputs = problems.problem(job)
    pg = pgraph.from_arrays(*problems.tables(job), device=device,
                            worker=rank)
    with tempfile.TemporaryDirectory() as where:
        path = os.path.join(where, "local.ckpt")
        with open(path, "wb") as f:
            f.write(data)
        res = Engine(mode=job.mode, chunk_size=job.chunk_size,
                     device=device, backend="dist").run(
            spec.factory(**inputs), pg, resume=path)
    return done + [dict(J._result(res), resumed_from=res.resumed_from)]


def raises_alone(rank: int, world: int, device):
    """Rank 2 raises while the others wait in a collective."""
    if rank == 2:
        raise ValueError("rank 2 fails on its own")
    dist.barrier()
    return rank


# ---------------------------------------------------------------------------
# the workers layer, rank by rank, against LocalWorkers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def probes():
    return launch.spawn(layer_probe, W, device="cpu",
                        timeout_s=TIMEOUT_S, join_timeout_s=180, threads=1)


@pytest.fixture(scope="module")
def inputs():
    return layer_inputs(W)


LOCAL = LocalWorkers(W)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rank", range(W))
def test_me_and_own(probes, inputs, rank):
    got = probes[rank]
    assert (got["size"], got["rows"]) == (W, 1)
    bits(got["me"], LOCAL.me("cpu").numpy()[rank:rank + 1])
    own = LOCAL.own(t(inputs["exchange"]["i32"])).numpy()
    bits(got["own"], own[rank:rank + 1])


@pytest.mark.parametrize("dtype", ["i32", "f32", "bool"])
def test_exchange(probes, inputs, dtype):
    want = LOCAL.exchange(t(inputs["exchange"][dtype])).numpy()
    for rank in range(W):
        bits(probes[rank]["exchange"][dtype], want[rank:rank + 1])


@pytest.mark.parametrize("dtype", ["i32", "f32"])
def test_exchange_with_a_lane_dim(probes, inputs, dtype):
    want = LOCAL.exchange(t(inputs["exchange_lanes"][dtype]),
                          peer_dim=2).numpy()
    for rank in range(W):
        bits(probes[rank]["exchange_lanes"][dtype], want[rank:rank + 1])


REDUCE_CASES = [(k, c) for k in ("i32", "i32_edges", "f32_order",
                                 "f32_special", "f32_empty")
                for c in COMBINERS]


@pytest.mark.parametrize("case,combiner", REDUCE_CASES,
                         ids=[f"{k}-{c}" for k, c in REDUCE_CASES])
def test_reduce_matches_the_local_fold(probes, inputs, case, combiner):
    x = t(inputs["reduce"][case])
    want = LOCAL.reduce(x, cb.get(combiner)).numpy()
    # the old entry point folds the same way
    bits(cb.get(combiner).reduce_workers(x).numpy(), want)
    for rank in range(W):
        bits(probes[rank]["reduce"][(case, combiner)], want[rank:rank + 1])


def test_float_sums_depend_on_the_order(inputs):
    """The operands really tell the fold order apart: summing the workers
    in reverse rounds differently somewhere."""
    x = t(inputs["reduce"]["f32_order"])
    fwd = LOCAL.reduce(x, cb.SUM)[0]
    rev = LOCAL.reduce(x.flip(0), cb.SUM)[0]
    assert not torch.equal(fwd, rev)


@pytest.mark.parametrize("vote", ["none", "one", "all", "all_but_one",
                                  "mixed"])
def test_votes(probes, inputs, vote):
    flag = t(inputs["votes"][vote])
    for rank in range(W):
        assert probes[rank]["any"][vote] == bool(LOCAL.any(flag))
        assert probes[rank]["all"][vote] == bool(LOCAL.all(flag))


@pytest.mark.parametrize("rank", range(W))
def test_gather(probes, inputs, rank):
    bits(probes[rank]["gather"], LOCAL.gather(t(inputs["gather"])).numpy())
    bits(probes[rank]["gather_host"],
         np.arange(3)[None] + 10 * np.arange(W)[:, None])
    collectives, nbytes = probes[rank]["counted"]
    assert collectives > 0 and nbytes > 0


# ---------------------------------------------------------------------------
# the launcher's failures
# ---------------------------------------------------------------------------


def test_a_rank_that_skips_a_collective_fails_the_spawn():
    t0 = time.monotonic()
    with pytest.raises(Exception):
        launch.spawn(one_sided, W, device="cpu", timeout_s=5,
                     join_timeout_s=60, threads=1)
    assert time.monotonic() - t0 < 60


def test_a_rank_that_raises_alone_fails_the_spawn():
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 2 fails on its own"):
        launch.spawn(raises_alone, W, device="cpu", timeout_s=5,
                     join_timeout_s=60, threads=1)
    assert time.monotonic() - t0 < 60


def test_spawn_validates_its_arguments():
    with pytest.raises(ValueError, match="transport"):
        launch.spawn(one_sided, W, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="NCCL"):
        launch.spawn(one_sided, W, device="cpu", backend="nccl")


# ---------------------------------------------------------------------------
# Engine(backend="dist") refusals, on a one-process group
# ---------------------------------------------------------------------------


@pytest.fixture
def group_of_one(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _graph(workers, worker=None):
    spec = REGISTRY["wcc:basic"]
    return spec, pgraph.partition_graph(
        spec.make_graph(6, 0), workers, build=spec.build, device="cpu",
        worker=worker)


def _same_run(res, want, resumed=False):
    """Two results equal bit for bit: outputs, state, counts (a resumed
    run counts only its own dispatches)."""
    assert (res.steps, res.halted) == (want.steps, want.halted)
    assert resumed or res.dispatches == want.dispatches
    assert (res.bytes_by_channel, res.msgs_by_channel) == (
        want.bytes_by_channel, want.msgs_by_channel)
    for k in want.state:
        bits(res.state[k].numpy(), want.state[k].numpy())
    bits(res.output, want.output)


@pytest.mark.parametrize("mode", ["fused", "chunked"])
def test_dist_runs_the_device_modes(group_of_one, mode):
    """The device modes on a group run uncaptured and equal the local
    loop, by the engine's mode and by a given Plan."""
    spec, pg = _graph(1, worker=0)
    want = Engine(mode=mode, chunk_size=2, device="cpu").run(
        spec.factory(), _graph(1)[1])
    given = planning.manual_plan(mode=mode, chunk_size=2,
                                 route_batch="union", dense_threshold=0.1,
                                 explicit={})
    for eng in (Engine(mode=mode, chunk_size=2, device="cpu",
                       backend="dist"),
                Engine(plan=given, device="cpu", backend="dist")):
        res = eng.run(spec.factory(), pg)
        assert (res.backend, res.mode, res.captured) == ("dist", mode, False)
        _same_run(res, want)
    # a group's manual default stays the host loop
    assert Engine(device="cpu", backend="dist").mode == "host"


def test_dist_plans_as_the_local_engine(group_of_one, tmp_path,
                                        monkeypatch):
    """``plan="auto"`` on a group gives the local engine's Plan (the
    probe cache shared), and the planned runs are equal."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "probes"))
    spec, pg = _graph(1, worker=0)
    want = Engine(plan="auto", device="cpu").run(spec.factory(),
                                                 _graph(1)[1])
    eng = Engine(plan="auto", device="cpu", backend="dist")
    res = eng.run(spec.factory(), pg)
    assert res.plan.key() == want.plan.key() and res.plan.source == "auto"
    assert (res.plan.fingerprint.cache_key()
            == want.plan.fingerprint.cache_key())
    assert res.mode == want.mode == "fused"
    _same_run(res, want)
    assert eng.workers.collectives > 0


def test_dist_serves_and_checkpoints(group_of_one, tmp_path):
    """``serve`` and checkpoint/resume on a group equal the local
    backend: the served records, the checkpoint files byte for byte,
    and resumes that cross the backends."""
    spec, pg = _graph(1, worker=0)
    whole = _graph(1)[1]
    reach = REGISTRY["reach:basic"].factory()
    sources = [0, 5, 9]
    served = [Engine(mode="chunked", chunk_size=2, device="cpu",
                     backend=b).serve(reach, g, sources, num_lanes=2)
              for b, g in (("dist", pg), ("local", whole))]
    assert [r.captured for r in served] == [False, False]
    for got, want in zip(*(s.records for s in served)):
        assert (got.qid, got.lane, got.admitted, got.finished, got.steps,
                got.halted, got.bytes_by_channel, got.msgs_by_channel) == (
            want.qid, want.lane, want.admitted, want.finished, want.steps,
            want.halted, want.bytes_by_channel, want.msgs_by_channel)
        bits(got.output, want.output)
    dirs = {b: tmp_path / b for b in ("dist", "local")}
    engines = {"dist": Engine(mode="chunked", chunk_size=2, device="cpu",
                              backend="dist"),
               "local": Engine(mode="chunked", chunk_size=2, device="cpu")}
    graphs = {"dist": pg, "local": whole}
    plain = {b: engines[b].run(spec.factory(), graphs[b],
                               checkpoint_every=2, checkpoint_dir=str(d))
             for b, d in dirs.items()}
    _same_run(plain["dist"], plain["local"])
    files = {b: sorted(d.iterdir()) for b, d in dirs.items()}
    assert [f.name for f in files["dist"]] == [f.name for f in files["local"]]
    assert files["dist"], "no checkpoint written"
    for a, b in zip(files["dist"], files["local"]):
        assert a.read_bytes() == b.read_bytes()
    # each backend resumes from the other's first checkpoint
    for b, other in (("dist", "local"), ("local", "dist")):
        res = engines[b].run(spec.factory(), graphs[b],
                             resume=str(files[other][0]))
        assert res.resumed_from > 0
        _same_run(res, plain["local"], resumed=True)
    # a one-worker graph runs on a group of one in host mode, as the
    # local backend does
    res = Engine(device="cpu", backend="dist").run(spec.factory(), pg)
    want = Engine(mode="host", device="cpu").run(spec.factory(), whole)
    assert res.backend == "dist" and want.backend == "local"
    assert (res.steps, res.bytes_by_channel) == (want.steps,
                                                 want.bytes_by_channel)
    np.testing.assert_array_equal(res.output, want.output)


def _wrap_step(ctx, gs, state, i):
    ctx.add_traffic("big", 2**31 - 1, 1)
    ctx.add_traffic("big", 2**31 - 1, 1)
    return state, False


def _overflow_step(ctx, gs, state, i):
    ctx.add_traffic("sent", 4, 1)
    ctx.add_overflow("sent", i >= 2)
    return state, False, i >= 2


def _syncing_step(ctx, gs, state, i):
    return state, bool(state["x"].all())


@pytest.mark.parametrize("mode,k", [("fused", 64), ("chunked", 2)])
def test_loop_errors_on_a_group_equal_local(group_of_one, mode, k):
    """A device loop on a group raises what the local loop raises: the
    int32 wrap (the fused latch merged from the ranks, the chunked rows'
    channel), the overflow at its superstep, and a host sync in a step
    (the guard lets the collectives through and nothing else)."""
    _, pg = _graph(1, worker=0)
    _, whole = _graph(1)
    group = GroupWorkers()
    for step, error in ((_wrap_step, errors.TrafficWrapError),
                        (_overflow_step, errors.ChannelOverflowError),
                        (_syncing_step, RuntimeError)):
        got = []
        for g, workers in ((pg, group), (whole, None)):
            with pytest.raises(error) as err:
                runtime.run_supersteps(g, step, {"x": g.v_mask}, mode=mode,
                                       chunk_size=k, max_steps=4,
                                       workers=workers)
            got.append(err.value)
        assert str(got[0]) == str(got[1])
        if error is not RuntimeError:
            assert got[0].superstep == got[1].superstep
            assert got[0].channels == got[1].channels
            assert (got[0].result.bytes_by_channel
                    == got[1].result.bytes_by_channel)


def test_dist_refuses_a_group_of_another_size(group_of_one):
    spec, pg = _graph(W, worker=0)
    with pytest.raises(ValueError, match="one worker per rank.*W=4.*"
                                         "group size 1"):
        Engine(device="cpu", backend="dist").run(spec.factory(), pg)


def test_backends_refuse_the_other_graphs(group_of_one):
    spec, whole = _graph(1)
    with pytest.raises(ValueError, match="worker=0"):
        Engine(device="cpu", backend="dist").run(spec.factory(), whole)
    _, row = _graph(1, worker=0)
    with pytest.raises(ValueError, match="local backend"):
        Engine(mode="host", device="cpu").run(spec.factory(), row)
    with pytest.raises(ValueError, match="unknown backend"):
        Engine(device="cpu", backend="shard_map")
    with pytest.raises(ValueError, match="group= needs"):
        Engine(device="cpu", group=dist.group.WORLD)


def test_a_workers_layer_of_one_rank_is_a_group(group_of_one):
    wk = GroupWorkers(group_of_one)
    x = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
    assert torch.equal(wk.exchange(x), x)
    assert torch.equal(wk.reduce(x, cb.SUM), x)
    assert wk.collectives == 2

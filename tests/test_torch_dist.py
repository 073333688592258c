"""The workers layer of ``Engine(backend="dist")``
(``repro_torch.distributed.workers``) and its launcher
(``repro_torch.launch.workers``) on four gloo CPU ranks.

Every ``GroupWorkers`` operation on a rank's row equals ``LocalWorkers``
on all W rows, row for row and bit for bit: ``me``/``own``, the tiled
exchange with and without a lane dim (int32, float32, bool), the
reduction for all six combiners on int32 and float32 (float sums whose
order matters, NaN, infinities, -0.0, ties, empty rows), the votes and
``gather``. A rank that skips a collective, or raises alone, ends its
spawn with an error within the group's timeout. ``Engine(backend=
"dist")`` refuses what this slice does not run (the device modes,
``serve``, ``plan="auto"``, checkpoints) and a group whose size is not
the graph's W. The four ranks run once, in a module-scoped fixture.
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


@pytest.mark.parametrize("mode", ["fused", "chunked"])
def test_dist_refuses_the_device_modes(mode):
    with pytest.raises(ValueError, match=r"ROADMAP item 8\.2"):
        Engine(mode=mode, device="cpu", backend="dist")
    given = planning.manual_plan(mode=mode, chunk_size=4,
                                 route_batch="union", dense_threshold=0.1,
                                 explicit={})
    with pytest.raises(ValueError, match=r"ROADMAP item 8\.2"):
        Engine(plan=given, device="cpu", backend="dist")


def test_dist_refuses_plan_auto():
    with pytest.raises(ValueError, match=r"ROADMAP item 8\.4"):
        Engine(plan="auto", device="cpu", backend="dist")


def test_dist_refuses_serve_and_checkpoints(group_of_one, tmp_path):
    spec, pg = _graph(1, worker=0)
    eng = Engine(device="cpu", backend="dist")
    assert eng.mode == "host" and eng.workers.size == 1
    with pytest.raises(ValueError, match=r"ROADMAP item 8\.3"):
        eng.serve(REGISTRY["reach:basic"].factory(), pg, [0])
    with pytest.raises(ValueError, match=r"ROADMAP item 8\.2"):
        eng.run(spec.factory(), pg, checkpoint_every=2,
                checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match=r"ROADMAP item 8\.2"):
        eng.run(spec.factory(), pg, resume=str(tmp_path))
    # a one-worker graph runs on a group of one, as the local backend does
    res = eng.run(spec.factory(), pg)
    want = Engine(mode="host", device="cpu").run(spec.factory(),
                                                  _graph(1)[1])
    assert res.backend == "dist" and want.backend == "local"
    assert (res.steps, res.bytes_by_channel) == (want.steps,
                                                 want.bytes_by_channel)
    np.testing.assert_array_equal(res.output, want.output)


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

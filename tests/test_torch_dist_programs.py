"""``Engine(backend="dist")`` on four gloo CPU ranks against the port's
single-process host run (``backend="local"``) and the JAX package's
``Engine(mode="host")`` — the port's counterpart of
``tests/test_runtime_shardmap.py``.

At W = 4 and each spec's ``test_scale``: all 21 registry programs solo,
the five batched programs at Q = 3, the mirror-on-mesh set (``wcc:switch``,
``sv:composed``, ``sssp:basic`` on the ``degree`` partition at
``mirror_threshold=8``) and ``sv:composed`` escalating from halved
capacities. Every rank's run equals the local run bit for bit: outputs,
final state (per-worker ``info``/``iters`` rows included), supersteps,
halts, bytes and messages per channel, per lane when batched, and the
escalation trail; and every run matches the JAX host mode (integer
outputs and every count exact, float outputs to rtol 1e-4 / atol 1e-7).
The ranks run every job once, in a module-scoped spawn that runs beside
the single-process runs.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from repro import algorithms as jalgorithms
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro_torch.algorithms import REGISTRY
from repro_torch.graph import pgraph
from repro_torch.launch import jobs as J
from repro_torch.launch import workers as launch

W, Q = 4, 3
CPU = torch.device("cpu")
PROBLEMS = J.Problems()
BATCHED = ("reach:basic", "sssp:basic", "sssp:prop", "pagerank:personal",
           "pj:reqresp")
MIRRORED = ("wcc:switch", "sv:composed", "sssp:basic")


def _scale(key):
    return REGISTRY[key].test_scale


SOLO_JOBS = {k: J.Job(k, _scale(k), W) for k in sorted(REGISTRY)}
BATCH_JOBS = {k: J.Job(k, _scale(k), W, queries=Q) for k in BATCHED}
MIRROR_JOBS = {k: J.Job(k, _scale(k), W, partitioner="degree",
                        mirror_threshold=8) for k in MIRRORED}
ESCALATE_JOB = J.Job("sv:composed", _scale("sv:composed"), W, cap_scale=0.5)
JOBS = (list(SOLO_JOBS.values()) + list(BATCH_JOBS.values())
        + list(MIRROR_JOBS.values()) + [ESCALATE_JOB])


@pytest.fixture(scope="module")
def ranks():
    """The four ranks' summaries of every job, job by job; the spawn
    runs in the background while the tests make their reference runs."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(launch.spawn, J.rank_jobs, W, JOBS, device="cpu",
                      timeout_s=60, join_timeout_s=240, threads=1)
    got = {}

    def of(job):
        if not got:
            per_rank = fut.result()
            for i, j in enumerate(JOBS):
                got[j] = [r[i] for r in per_rank]
        return got[job]

    yield of
    pool.shutdown(wait=True)


def _held_to_local(ranks, job):
    """Every rank's summary equals the local run's, bit for bit; returns
    the local summary."""
    local = J.run_job(job, CPU, problems=PROBLEMS)
    for rank, got in enumerate(ranks(job)):
        assert got["backend"] == "dist" and local["backend"] == "local"
        assert J.differences(got, local) == [], (job.name, rank)
    return local


def _jax_run(job):
    jspec = jalgorithms.REGISTRY[job.key]
    spec, graph, inputs = PROBLEMS.problem(job)
    jpg = jpgraph.partition_graph(graph, W, job.partitioner,
                                  build=jspec.build,
                                  mirror_threshold=job.mirror_threshold)
    eng = JEngine(mode="host", **(
        {"cap_scales": {"*": job.cap_scale}, "on_overflow": "escalate"}
        if job.cap_scale is not None else {}))
    prog = jspec.factory(**jspec.inputs(graph, job.seed))
    if job.queries:
        return eng.run_batch(prog, jpg, spec.queries(graph, job.seed, Q))
    return eng.run(prog, jpg)


def _close(got, want):
    """Integer (and bool) leaves exact, float leaves to the registry's
    tolerance (the JAX package sums some floats in another order)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


def _counts(res):
    return ({k: int(v) for k, v in res.bytes_by_channel.items()},
            {k: int(v) for k, v in res.msgs_by_channel.items()})


def _rows(local, want):
    """The per-worker rows a program keeps in its state (``info``,
    ``iters``) exact to the JAX run's."""
    for name in ("info", "iters"):
        if name in local["state"]:
            np.testing.assert_array_equal(local["state"][name],
                                          np.asarray(want.state[name]))


@pytest.mark.parametrize("key", sorted(SOLO_JOBS))
def test_solo_run_on_a_group_matches_local_and_jax(ranks, key):
    job = SOLO_JOBS[key]
    local = _held_to_local(ranks, job)
    want = _jax_run(job)
    _close(local["output"], want.output)
    assert (local["steps"], local["halted"]) == (want.steps, want.halted)
    assert (local["bytes"], local["msgs"]) == _counts(want)
    _rows(local, want)
    J.check_oracle(job, ranks(job)[0], CPU, PROBLEMS)


@pytest.mark.parametrize("key", BATCHED)
def test_batched_run_on_a_group_matches_local_and_jax(ranks, key):
    job = BATCH_JOBS[key]
    local = _held_to_local(ranks, job)
    want = _jax_run(job)
    assert len(local["output"]) == Q
    for qi in range(Q):
        _close(local["output"][qi], want.outputs[qi])
        assert ({k: int(v[qi]) for k, v in local["query_bytes"].items()}
                == want.query_bytes(qi))
        assert ({k: int(v[qi]) for k, v in local["query_msgs"].items()}
                == want.query_msgs(qi))
    np.testing.assert_array_equal(local["query_steps"], want.query_steps)
    np.testing.assert_array_equal(local["query_halted"], want.query_halted)
    assert local["pad"] == (want.pad_steps, want.pad_bytes, want.pad_msgs)
    _rows(local, want)


@pytest.mark.parametrize("key", MIRRORED)
def test_mirrored_partition_on_a_group_matches_local_and_jax(ranks, key):
    job = MIRROR_JOBS[key]
    spec, graph, _ = PROBLEMS.problem(job)
    tables, statics = pgraph.partition_tables(
        graph, W, "degree", build=spec.build, mirror_threshold=8)
    hubs = [statics[p]["hub_cap"] for p in ("scatter_out", "scatter_in")
            if p in statics]
    # sssp:basic sends over raw edges, which mirroring leaves alone (as in
    # the JAX mirror-on-mesh test)
    assert any(hubs) if hubs else key == "sssp:basic", "no hub mirrored"
    local = _held_to_local(ranks, job)
    unmirrored = J.run_job(J.Job(key, job.scale, W, partitioner="degree"),
                           CPU, problems=PROBLEMS)
    np.testing.assert_array_equal(np.asarray(local["output"]),
                                  np.asarray(unmirrored["output"]))
    want = _jax_run(job)
    _close(local["output"], want.output)
    assert (local["steps"], local["halted"]) == (want.steps, want.halted)
    assert (local["bytes"], local["msgs"]) == _counts(want)


def test_escalation_on_a_group_takes_the_local_and_jax_trail(ranks):
    local = _held_to_local(ranks, ESCALATE_JOB)
    plain = J.run_job(J.Job("sv:composed", ESCALATE_JOB.scale, W), CPU,
                      problems=PROBLEMS)
    assert local["recovery"], "halved caps must overflow"
    assert J.differences(local, plain, J.TIMES + ("recovery",)) == []
    want = _jax_run(ESCALATE_JOB)
    assert local["recovery"] == [
        (ev["attempt"], tuple(ev["channels"]), ev.get("qids"),
         ev["cap_scales"]) for ev in want.recovery]
    assert (local["bytes"], local["msgs"]) == _counts(want)


def test_the_ranks_hold_one_row_each(ranks):
    """The group ran one worker a rank: W (1, ...) graphs, and every rank
    reported collectives for every job."""
    for job in JOBS:
        for got in ranks(job):
            assert got["collectives"] > 0 and got["collective_bytes"] > 0
    spec, graph, _ = PROBLEMS.problem(SOLO_JOBS["wcc:basic"])
    tables = pgraph.partition_tables(graph, W, build=spec.build)
    for rank in range(W):
        pg = pgraph.from_arrays(*tables, device="cpu", worker=rank)
        assert pg.rows == 1 and pg.num_workers == W
        assert pg.v_mask.shape == (1, pg.n_loc)
        np.testing.assert_array_equal(pg.global_ids().numpy()[0],
                                      rank * pg.n_loc + np.arange(pg.n_loc))

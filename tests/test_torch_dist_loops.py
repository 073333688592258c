"""``Engine(backend="dist")`` in the device modes, served, checkpointed
and planned, on four gloo CPU ranks: the port's counterpart of
``tests/test_runtime_shardmap.py``'s default-mode, batched and served
runs, beyond host mode (``tests/test_torch_dist_programs.py``).

At W = 4 and each spec's ``test_scale``: all 21 registry programs fused,
the seven programs with inner loops chunked at K = 3, the five batched
programs chunked at K = 3 and Q = 3, ``reach:basic``, ``sssp:basic`` and
``pagerank:personal`` served (Q = 3 through 2 lanes at chunk 2, the JAX
mesh test's schedule, so a lane is refilled), ``wcc:basic`` and
``sv:composed`` chunked with checkpoints, ``sv:composed`` solo and
``sssp:basic`` batched under ``plan="auto"``, and ``sv:composed`` fused
escalating from halved capacities. On a group the device loops run
uncaptured (``captured`` False on every rank).

Every rank's summary equals the single-process run in the same mode bit
for bit (``launch.jobs.differences``): outputs, final state, supersteps,
dispatches, halts, bytes and messages per channel (per lane, per served
record), the checkpoint files byte for byte and the run resumed from the
first, the plan's key. Every run matches the JAX package's ``Engine`` in
the same mode: integer outputs and every count exact, float outputs to
rtol 1e-4 / atol 1e-7, the tolerance ``test_torch_dist_programs.py``
states. The JAX ``shard_map`` serve fails (ROADMAP fault 5), so a served
session is held to the JAX single-process (``vmap``) serve, record by
record, and each record to its own solo run. A group's checkpoint
resumes locally and a local one on the group; a group plans the local
engine's ``Plan.key()`` from a shared probe cache. The ranks run every
job once, in a module-scoped spawn beside the reference runs.
"""
import concurrent.futures
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from repro import algorithms as jalgorithms
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro.pregel.serve import QueryQueue as JQueryQueue
from repro_torch.algorithms import REGISTRY
from repro_torch.graph import pgraph
from repro_torch.launch import jobs as J
from repro_torch.launch import workers as launch
from repro_torch.pregel.engine import Engine
from test_torch_dist import jobs_then_resume

W, Q, K = 4, 3, 3
CPU = torch.device("cpu")
PROBLEMS = J.Problems()
INNER = ("sv:composed", "msf:channels", "msf:monolithic", "scc:basic",
         "scc:prop", "wcc:prop", "sssp:prop")
BATCHED = ("reach:basic", "sssp:basic", "sssp:prop", "pagerank:personal",
           "pj:reqresp")
SERVED = ("reach:basic", "sssp:basic", "pagerank:personal")


def _scale(key):
    return REGISTRY[key].test_scale


FUSED_JOBS = {k: J.Job(k, _scale(k), W, mode="fused")
              for k in sorted(REGISTRY)}
CHUNKED_JOBS = {k: J.Job(k, _scale(k), W, mode="chunked", chunk_size=K)
                for k in INNER}
BATCH_JOBS = {k: J.Job(k, _scale(k), W, queries=Q, mode="chunked",
                       chunk_size=K) for k in BATCHED}
SERVE_JOBS = {k: J.Job(k, _scale(k), W, queries=Q, lanes=2, mode="chunked",
                       chunk_size=2) for k in SERVED}
CKPT_JOBS = {
    "wcc:basic": J.Job("wcc:basic", _scale("wcc:basic"), W, mode="chunked",
                       chunk_size=2, checkpoint_every=2),
    "sv:composed": J.Job("sv:composed", _scale("sv:composed"), W,
                         mode="chunked", chunk_size=1, checkpoint_every=1)}
PLAN_JOBS = {
    "sv:composed": J.Job("sv:composed", _scale("sv:composed"), W,
                         plan="auto"),
    "sssp:basic": J.Job("sssp:basic", _scale("sssp:basic"), W, queries=Q,
                        plan="auto")}
# halved capacities overflow: the group's votes must raise on every rank
# at the same superstep, and the escalations replay the device loop
ESCALATE_JOB = J.Job("sv:composed", _scale("sv:composed"), W, cap_scale=0.5,
                     mode="fused")
JOBS = (list(FUSED_JOBS.values()) + list(CHUNKED_JOBS.values())
        + list(BATCH_JOBS.values()) + list(SERVE_JOBS.values())
        + list(CKPT_JOBS.values()) + list(PLAN_JOBS.values())
        + [ESCALATE_JOB])


# a local checkpoint the group resumes from, after its jobs
RESUME_JOB = CKPT_JOBS["sv:composed"]
RESUMED = "resumed from a local checkpoint"


def _local_checkpoint() -> bytes:
    files = local(RESUME_JOB)["checkpoints"]
    return files[min(files)]


@pytest.fixture(scope="module")
def ranks():
    """The four ranks' summaries of every job, job by job; the spawn
    runs in the background while the tests make their reference runs.
    The planner's probe cache is a temporary directory the ranks and
    this process share, warmed here first (the local planned runs), so
    rank 0 and the local planner read the same probes."""
    cache = tempfile.TemporaryDirectory()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_PLAN_CACHE", os.path.join(cache.name, "p"))
        for job in PLAN_JOBS.values():
            local(job)
        pool = concurrent.futures.ThreadPoolExecutor(1)
        fut = pool.submit(launch.spawn, jobs_then_resume, W, JOBS,
                          RESUME_JOB, _local_checkpoint(), device="cpu",
                          timeout_s=60, join_timeout_s=240, threads=1)
        got = {}

        def of(job):
            if not got:
                per_rank = fut.result()
                for i, j in enumerate(JOBS + [RESUMED]):
                    got[j] = [r[i] for r in per_rank]
            return got[job]

        yield of
        pool.shutdown(wait=True)
    cache.cleanup()


@functools.lru_cache(maxsize=None)
def local(job):
    """The single-process run of ``job`` on the CPU."""
    return J.run_job(job, CPU, problems=PROBLEMS)


def _held_to_local(ranks, job):
    """Every rank's summary equals the local run's bit for bit, and the
    group ran uncaptured; returns the local summary."""
    want = local(job)
    for rank, got in enumerate(ranks(job)):
        assert got["backend"] == "dist" and want["backend"] == "local"
        assert got["captured"] is False and got["collectives"] > 0
        assert J.differences(got, want) == [], (job.name, rank)
    return want


def _jax_engine(job):
    return JEngine(mode=job.mode, chunk_size=job.chunk_size)


def _jax_problem(job):
    """(JAX program, JAX partition, port graph): the JAX package's run of
    the job's problem on the same partition."""
    jspec = jalgorithms.REGISTRY[job.key]
    _, graph, _ = PROBLEMS.problem(job)
    jpg = jpgraph.partition_graph(graph, W, job.partitioner,
                                  build=jspec.build)
    return jspec.factory(**jspec.inputs(graph, job.seed)), jpg, graph


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


def _rows(summary, want):
    """The per-worker rows a program keeps in its state (``info``,
    ``iters``) exact to the JAX run's."""
    for name in ("info", "iters"):
        if name in summary["state"]:
            np.testing.assert_array_equal(summary["state"][name],
                                          np.asarray(want.state[name]))


def _solo_matches_jax(summary, job):
    prog, jpg, _ = _jax_problem(job)
    want = _jax_engine(job).run(prog, jpg)
    _close(summary["output"], want.output)
    assert (summary["steps"], summary["halted"]) == (want.steps, want.halted)
    assert (summary["bytes"], summary["msgs"]) == _counts(want)
    _rows(summary, want)


@pytest.mark.parametrize("key", sorted(FUSED_JOBS))
def test_fused_run_on_a_group_matches_local_and_jax(ranks, key):
    job = FUSED_JOBS[key]
    summary = _held_to_local(ranks, job)
    assert summary["mode"] == "fused" and summary["dispatches"] >= 1
    _solo_matches_jax(summary, job)
    J.check_oracle(job, ranks(job)[0], CPU, PROBLEMS)


@pytest.mark.parametrize("key", INNER)
def test_chunked_inner_loops_on_a_group_match_local_and_jax(ranks, key):
    job = CHUNKED_JOBS[key]
    summary = _held_to_local(ranks, job)
    assert summary["dispatches"] == -(-summary["steps"] // K)
    _solo_matches_jax(summary, job)


@pytest.mark.parametrize("key", BATCHED)
def test_batched_chunked_run_on_a_group_matches_local_and_jax(ranks, key):
    job = BATCH_JOBS[key]
    summary = _held_to_local(ranks, job)
    prog, jpg, graph = _jax_problem(job)
    want = _jax_engine(job).run_batch(
        prog, jpg, REGISTRY[key].queries(graph, job.seed, Q))
    assert len(summary["output"]) == Q
    for qi in range(Q):
        _close(summary["output"][qi], want.outputs[qi])
        assert ({k: int(v[qi]) for k, v in summary["query_bytes"].items()}
                == want.query_bytes(qi))
        assert ({k: int(v[qi]) for k, v in summary["query_msgs"].items()}
                == want.query_msgs(qi))
    np.testing.assert_array_equal(summary["query_steps"], want.query_steps)
    np.testing.assert_array_equal(summary["query_halted"], want.query_halted)
    assert summary["pad"] == (want.pad_steps, want.pad_bytes, want.pad_msgs)
    _rows(summary, want)


@pytest.mark.parametrize("key", SERVED)
def test_served_session_on_a_group_matches_local_and_jax(ranks, key):
    """Record by record against the local session and the JAX
    ``Engine(mode="chunked").serve`` on the same queue, and each record
    against a solo host-mode run of its query."""
    job = SERVE_JOBS[key]
    summary = _held_to_local(ranks, job)
    prog, jpg, graph = _jax_problem(job)
    queries = REGISTRY[key].queries(graph, job.seed, Q)
    want = JEngine(mode="chunked", chunk_size=2).serve(
        prog, jpg, JQueryQueue.from_queries(queries), num_lanes=2)
    records = summary["records"]
    assert len(records) == Q == len(want.records)
    assert max(r["lane"] for r in records) == 1
    assert len({r["admitted"] for r in records}) > 1, "no lane was refilled"
    assert (summary["steps"], summary["clock"], summary["dispatches"]) == (
        want.supersteps, want.clock, want.dispatches)
    assert (summary["bytes"], summary["msgs"]) == _counts(want)
    for got, jrec in zip(records, want.records):
        assert tuple(got[f] for f in (
            "qid", "lane", "admitted", "finished", "steps", "halted",
            "status")) == (jrec.qid, jrec.lane, jrec.admitted,
                           jrec.finished, jrec.steps, jrec.halted,
                           jrec.status)
        _close(got["output"], jrec.output)
        assert got["bytes_by_channel"] == jrec.bytes_by_channel
        assert got["msgs_by_channel"] == jrec.msgs_by_channel
    spec, _, inputs = PROBLEMS.problem(job)
    pg = pgraph.from_arrays(*PROBLEMS.tables(job), device="cpu")
    solo = Engine(mode="host", device="cpu")
    for got in records:
        one = solo.run_batch(spec.factory(**inputs), pg, [got["query"]])
        np.testing.assert_array_equal(np.asarray(got["output"]),
                                      np.asarray(one.outputs[0]))
        assert got["steps"] == int(one.query_steps[0])
        assert got["bytes_by_channel"] == one.query_bytes(0)


@pytest.mark.parametrize("key", sorted(CKPT_JOBS))
def test_checkpoints_on_a_group_cross_load_with_local(ranks, key):
    """The group's checkpoint files equal the local run's byte for byte
    (``differences`` covers them); the group resumed from its first one
    as the local run did; a local run resumes from the group's file and
    a group from the local file, each equal to the uninterrupted run."""
    job = CKPT_JOBS[key]
    summary = _held_to_local(ranks, job)
    files = summary["checkpoints"]
    assert len(files) >= 2, files.keys()
    first = min(files)
    group_file = ranks(job)[0]["checkpoints"][first]
    assert group_file == files[first]
    resumed = J.resume_from(job, group_file, CPU, PROBLEMS)
    assert J._same(resumed, summary["resumed"])
    assert resumed["resumed_from"] > 0
    for field in ("output", "state", "steps", "halted", "bytes", "msgs"):
        assert J._same(resumed[field], summary[field]), field
    _solo_matches_jax(summary, job)


def test_a_group_resumes_from_a_local_checkpoint(ranks):
    """The local run's first checkpoint resumes on the four ranks: every
    rank equals the uninterrupted local run."""
    summary = local(RESUME_JOB)
    for got in ranks(RESUMED):
        assert got["resumed_from"] > 0
        for field in ("output", "state", "steps", "halted", "bytes",
                      "msgs"):
            assert J._same(got[field], summary[field]), field


def test_fused_escalation_on_a_group_takes_the_local_and_jax_trail(ranks):
    summary = _held_to_local(ranks, ESCALATE_JOB)
    assert summary["recovery"], "halved caps must overflow"
    prog, jpg, _ = _jax_problem(ESCALATE_JOB)
    want = JEngine(mode="fused", cap_scales={"*": 0.5},
                   on_overflow="escalate").run(prog, jpg)
    assert summary["recovery"] == [
        (ev["attempt"], tuple(ev["channels"]), ev.get("qids"),
         ev["cap_scales"]) for ev in want.recovery]
    _close(summary["output"], want.output)
    assert (summary["bytes"], summary["msgs"]) == _counts(want)


@pytest.mark.parametrize("key", sorted(PLAN_JOBS))
def test_plan_auto_on_a_group_keys_the_local_plan(ranks, key):
    """``plan="auto"`` on the group: every rank runs rank 0's Plan, whose
    key and fingerprint equal the local engine's (``differences`` holds
    the plan), and the planned runs are equal."""
    job = PLAN_JOBS[key]
    summary = _held_to_local(ranks, job)
    key_, source, fingerprint = summary["plan"]
    assert source == "auto" and fingerprint is not None
    assert key_[0] == summary["mode"] == "fused"

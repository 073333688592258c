"""The readers of the program's own trace (``perfbench/program_trace.py``
and its twelve metrics) on fake traces, and a cell recorded on the CPU."""
import time

import numpy as np
import pytest

from perfbench import harness
from perfbench import program_trace as pt

from conftest import small_root

JOB_METRICS = [m for m in pt.NEW_METRICS if m.endswith(".job")]
SERVE_METRICS = [m for m in pt.NEW_METRICS if m.endswith(".serve")]
NAMES = ["engine.run", "engine.extract", "superstep", "channel:a",
         "channel:a/b", "kernel:segment_combine", "inner:x", "serve.dispatch",
         "serve.harvest", "channel:c"]
MS = 1_000_000  # ns


def _trace(rows):
    """A program trace of (name, start ms, end ms, parent row) rows."""
    a = np.array([(NAMES.index(n), s * MS, e * MS, p) for n, s, e, p in rows],
                 np.int64).reshape(-1, 4)
    return {"names": NAMES,
            "spans": {"name": a[:, 0], "start_ns": a[:, 1],
                      "end_ns": a[:, 2], "parent": a[:, 3],
                      "rid": np.zeros(len(a), np.int64),
                      "device": np.zeros(len(a), bool)}}


def _run(rows=None, jobs=True, window=(0.0, 0.1)):
    run = harness.Run(cell={}, config={}, traffic={}, seed=0, seconds=1.0,
                      trace=True, device=None, t0=0.0)
    run.window_start, run.window_end = window
    if jobs:
        run.jobs = [{}]
    else:
        run.sessions = [{}]
    if rows is not None:
        run.program_trace = _trace(rows)
    return run


def _read(name, run):
    return harness.load("metrics", name).read(run)


# two jobs in a 100 ms window, and one job's spans before it (set-up)
JOBS = [
    ("engine.run", -30, -5, -1), ("superstep", -29, -6, 0),
    ("engine.run", 0, 40, -1),                       # row 2
    ("superstep", 2, 12, 2), ("superstep", 14, 30, 2),
    ("channel:a", 3, 9, 3), ("channel:a/b", 4, 8, 5),  # nested: once
    ("channel:a", 15, 20, 4),
    ("kernel:segment_combine", 4, 5, 6), ("kernel:segment_combine", 16, 18, 7),
    ("inner:x", 5, 6, 5), ("inner:x", 6, 7, 5), ("inner:x", 7, 8, 5),
    ("engine.extract", 31, 39, 2),
    ("channel:c", 5, 6, 10),  # in an inner loop inside channel:a: once
    ("engine.run", 50, 90, -1),                      # row 15
    ("superstep", 52, 62, 15), ("engine.extract", 70, 72, 15),
]


def test_job_readers_read_inside_the_window_only():
    run = _run(JOBS)
    assert _read("superstep_ms.job", run) == pytest.approx(12.0)  # 10,16,10
    assert _read("inner_rounds.job", run) == pytest.approx(1.5)
    assert _read("channel_ms.job", run) == pytest.approx(5.5)  # (6+5)/2
    assert _read("kernel_ms.job", run) == pytest.approx(1.5)
    assert _read("extract_ms.job", run) == pytest.approx(5.0)
    # covered: 2-12, 14-30, 52-62 of 0-100 ms
    assert _read("between_steps.job", run) == pytest.approx(64.0)
    for name in SERVE_METRICS:
        assert _read(name, run) is None


SESSION = [
    ("serve.dispatch", 0, 30, -1), ("superstep", 1, 25, 0),
    ("inner:x", 2, 3, 1), ("inner:x", 3, 4, 1), ("channel:a", 2, 20, 1),
    ("kernel:segment_combine", 5, 9, 4), ("serve.harvest", 30, 34, -1),
    ("serve.dispatch", 40, 60, -1), ("superstep", 41, 51, 7),
    ("inner:x", 42, 43, 8), ("channel:a", 42, 50, 8),
    ("serve.harvest", 60, 62, -1), ("serve.dispatch", 120, 130, -1),
]


def test_serve_readers_read_per_dispatch():
    run = _run(SESSION, jobs=False)
    assert _read("superstep_ms.serve", run) == pytest.approx(17.0)
    assert _read("inner_rounds.serve", run) == pytest.approx(1.5)
    assert _read("channel_ms.serve", run) == pytest.approx(13.0)
    assert _read("kernel_ms.serve", run) == pytest.approx(2.0)
    assert _read("harvest_ms.serve", run) == pytest.approx(3.0)
    assert _read("between_steps.serve", run) == pytest.approx(66.0)
    for name in JOB_METRICS:
        assert _read(name, run) is None


@pytest.mark.parametrize("name", pt.NEW_METRICS)
def test_every_reader_is_none_without_a_trace(name):
    jobs = name.endswith(".job")
    assert _read(name, _run(None, jobs=jobs)) is None
    empty = _run([], jobs=jobs)
    assert _read(name, empty) in (None, 100.0)  # nothing covers the window


def test_a_run_of_the_harness_never_records(tmp_path, monkeypatch):
    import torch
    from repro_torch import tracing

    def refuse(*a, **kw):
        raise AssertionError("the harness opened a recording")

    monkeypatch.setattr(tracing, "recording", refuse)
    root = small_root(tmp_path, 7)
    bench = harness.manifest(root)
    for trace in (False, True):
        run, result = harness.execute(bench, "pr-scatter", 5, 0.2, trace,
                                      torch.device("cpu"),
                                      time.perf_counter(), root)
        assert result["correct"] and pt.trace_of(run) is None
        assert tracing.active() is None


@pytest.mark.parametrize("cell", ["cc-sv-composed", "sssp-serve-l32"])
def test_a_recorded_cell_on_the_cpu(tmp_path, cell):
    """The program's recorder over a small cell's set-up and window: the
    readers give numbers and the window's supersteps are the program's."""
    import torch

    root = small_root(tmp_path, 7)
    bench = harness.manifest(root)
    run, result, checks = pt.traced_execute(
        bench, cell, 11, 0.3, torch.device("cpu"), time.perf_counter(),
        root=root)
    assert result["correct"]
    names = JOB_METRICS if run.jobs else SERVE_METRICS
    for name in names:
        assert _read(name, run) is not None, name
    w = pt.Window.of(run)
    want = checks["job_steps"] or checks["session_supersteps"]
    assert w.count("superstep") == want > 0
    summary = pt._summary(run, checks)
    assert summary["dropped"] == 0 and summary["partition_s"]

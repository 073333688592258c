"""The metric readers' arithmetic on fake windows, the import check, and
a dummy cell added by new files alone."""
import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness, yardstick

from conftest import ROOT


def _run(**kw):
    run = harness.Run(cell={}, config={}, traffic={}, seed=0, seconds=1.0,
                      trace=False, device=None, t0=0.0)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _read(name, run):
    return harness.load("metrics", name).read(run)


def _jobs(durations):
    t, jobs = 0.0, []
    for d in durations:
        jobs.append(dict(start=t, end=t + d, steps=4, host_overhead_s=0.001,
                         channel_bytes=2_000_000))
        t += d
    return _run(jobs=jobs, window_start=0.0, window_end=t)


def test_job_ms_is_the_window_over_the_jobs_and_a_stall_moves_it():
    steady = _jobs([0.1] * 10)
    assert _read("job_ms", steady) == pytest.approx(100.0)
    stalled = _jobs([0.1] * 9 + [0.6])
    assert _read("job_ms", stalled) == pytest.approx(150.0)
    assert _read("supersteps.job", steady) == 4
    assert _read("channel_mb.job", steady) == pytest.approx(2.0)
    assert _read("host_overhead_ms.job", steady) == pytest.approx(1.0)
    assert _read("queries_per_s", steady) is None


def _queries(latencies, status="ok"):
    qs = [dict(latency_s=l, program_lane_wait_s=0.01, steps=1,
               channel_bytes=1_000_000, status=status) for l in latencies]
    sessions = [dict(start=0.0, end=10.0, dispatches=5, program_wall_s=9.0)]
    return _run(queries=qs, sessions=sessions, window_start=0.0,
                window_end=10.0)


def test_p95_counts_every_query_and_a_stall_moves_it():
    lat = [1.0] * 200
    base = _read("query_p95_ms", _queries(lat))
    assert base == pytest.approx(1000.0)
    stalled = _read("query_p95_ms", _queries(lat[:180] + [3.0] * 20))
    assert stalled == pytest.approx(3000.0)
    assert _read("queries_per_s", _queries(lat)) == pytest.approx(20.0)
    assert _read("chunk_ms.serve", _queries(lat)) == pytest.approx(1800.0)
    assert _read("lane_wait_ms.serve", _queries(lat)) == pytest.approx(10.0)
    assert _read("job_ms", _queries(lat)) is None


def test_a_failed_query_is_late_beyond_any_limit_and_not_answered():
    run = _queries([1.0] * 10 + [math.inf] * 1)
    run.queries[-1]["status"] = "overflow"
    assert _read("queries_per_s", run) == pytest.approx(1.0)
    run = _queries([1.0] * 10 + [math.inf] * 2)
    assert _read("query_p95_ms", run) == math.inf


def test_rooflines_and_idle_read_nothing_without_a_trace():
    run = _jobs([0.1] * 3)
    for name in ("seg_combine_roofline.job", "bucket_route_roofline.job",
                 "device_idle.job"):
        assert _read(name, run) is None
    run.kernel_times = {"segment_combine": dict(calls=2, time_s=2e-3,
                                                bound_s=5e-4)}
    run.device_trace = {"busy_s": 0.75, "window_s": 1.0}
    assert _read("seg_combine_roofline.job", run) == pytest.approx(25.0)
    assert _read("device_idle.job", run) == pytest.approx(25.0)
    assert _read("seg_combine_roofline.serve", run) is None


def test_byte_counts_follow_the_real_entries():
    import torch

    vals = torch.zeros(2, 5, 3)
    ids = torch.tensor([[0, 1, 1, 7, 9], [2, 2, 3, 4, 4]], dtype=torch.int32)
    # 8 real ids (< 5) of 4 + 3 x 4 bytes; output 2 x 5 x 3 x 4 bytes
    assert yardstick.segment_combine_bytes(vals, ids, 5) == 8 * 16 + 120
    keys = torch.zeros(8, 100, dtype=torch.int32)
    assert yardstick.bucket_ranks_bytes(keys, 8) == 800 * 8 + 8 * 8 * 4
    keys = torch.tensor([[0, 1, 8]], dtype=torch.int32)
    lanes = torch.ones(1, 3, 4, dtype=torch.bool)
    assert yardstick.bucket_ranks_lanes_bytes(keys, lanes, 8) == \
        3 * 8 + 2 * 4 + 1 * 8 * 5 * 4
    assert yardstick.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)
    assert yardstick.percentile([3.0, 1.0, 2.0, 4.0, 5.0], 95) == \
        pytest.approx(4.8)


def _python(code, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_nothing_jax_is_loaded_by_the_harness_and_its_parts():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from perfbench import harness, trace, yardstick
import perfbench.calibrate
for kind in ("drivers", "references", "generators", "metrics"):
    for f in sorted((harness.BENCH / kind).glob("*.py")):
        harness.load(kind, f.stem)
import repro_torch.algorithms, repro_torch.pregel.engine
assert harness.forbidden_modules() == [], harness.forbidden_modules()
sys.modules["repro.x"] = sys.modules["repro_torch"]
sys.modules["jaxlib"] = sys.modules["repro_torch"]
assert harness.forbidden_modules() == ["jaxlib", "repro.x"]
print("ok")
"""
    p = _python(code, ROOT)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr


def test_the_benchmark_alone_exits_nonzero_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "pr-scatter", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_dummy_cell_needs_new_files_only(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as
    files and entries, run without an edit to any file already there."""
    root = tmp_path / "repo"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "perfbench/configs/g500-s20-u.json").read_text())
    cfg.update(name="dummy-s7", scale=7)
    (root / "perfbench/configs/dummy-s7.json").write_text(json.dumps(cfg))
    traffic = json.loads(
        (ROOT / "perfbench/workloads/sv-composed-jobs.json").read_text())
    traffic.update(program="wcc:basic", plans=["scatter_out", "raw_out"])
    (root / "perfbench/workloads/wcc-basic-jobs.json").write_text(
        json.dumps(traffic))
    (root / "perfbench/metrics/dummy_jobs.job.py").write_text(
        "def read(run):\n    return float(len(run.jobs)) or None\n")
    bench["configs"].append(dict(name="dummy-s7", source="a test",
                                 file="perfbench/configs/dummy-s7.json",
                                 reduced=["scale"], why="a test"))
    bench["workloads"].append(dict(name="dummy-cell", config="dummy-s7",
                                   traffic="wcc-basic-jobs", chips=1,
                                   why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "job_ms":
            m["workloads"].append("dummy-cell")
    bench["per_layer"].append(dict(
        name="dummy_jobs.job", unit="jobs", better="higher",
        source="host_clock", layer="test", moves="job_ms",
        workloads=["dummy-cell"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys, time
sys.path[:0] = [{str(root)!r}, {str(ROOT / 'src')!r}]
import torch
from perfbench import harness
assert harness.ROOT == __import__("pathlib").Path({str(root)!r})
out = {{}}
for trace in (0, 1):
    r = harness.run_cell(harness.manifest(), "dummy-cell", 3, 0.2, bool(trace),
                         torch.device("cpu"), time.perf_counter())
    out[trace] = r
print(json.dumps({{k: (v["correct"], sorted(v["metrics"]))
                  for k, v in out.items()}}))
"""
    p = _python(code, root)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["0"] == [True, ["job_ms", "setup_s"]]
    assert got["1"][0] and "dummy_jobs.job" in got["1"][1]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_the_checks_sample_is_a_seeded_uniform_reservoir():
    def kept(seed, n=1000, k=16):
        run = _run(seed=seed, traffic={"check_sample": k})
        for i in range(n):
            run.keep(i, i)
        return run

    a, b = kept(7), kept(7)
    assert a.answers == b.answers and len(a.answers) == 16
    assert a.answered == 1000 and a.answers != kept(8).answers
    assert [q for q, _ in kept(7, n=5).answers] == [0, 1, 2, 3, 4]
    late = sum(q >= 500 for s in range(200) for q, _ in kept(s).answers)
    assert late / (200 * 16) == pytest.approx(0.5, abs=0.05)


def test_the_checks_sample_holds_every_lane():
    def kept(seed, lanes=32, n=768, k=2):
        run = _run(seed=seed, traffic={"check_sample": k})
        for i in range(n):
            run.keep(i, i, stratum=i % lanes)
        return run

    a = kept(7)
    assert a.answered == 768 and len(a.answers) == 64
    assert sorted(a.samples) == list(range(32))
    assert all(len(v) == 2 and all(q % 32 == lane for q, _ in v)
               for lane, v in a.samples.items())
    assert a.answers == kept(7).answers != kept(8).answers

"""The port's command line (``python -m repro_torch``) and its paper
tables (``python -m repro_torch.paper_tables``) on the CPU.

The paper table at scale 8 is held row for row to the same five cases
run through the JAX package's ``Engine(mode="host")`` on the same
datasets (supersteps, messages, bytes); the JAX table's own ``run`` is
not called, since it also compiles the fused mode.
"""
import functools
import json

import numpy as np
import pytest

from benchmarks import common as jbench
from repro.algorithms import REGISTRY as JREGISTRY
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro_torch import __main__ as cli
from repro_torch import paper_tables
from repro_torch.algorithms import (ALGORITHMS, BATCHED, DEFAULT_VARIANT,
                                    REGISTRY, resolve)


def test_list_names_every_ported_program(capsys):
    assert cli.main(["list"]) == 0
    out = capsys.readouterr().out
    for key in REGISTRY:
        assert key in out
    assert f"{len(REGISTRY)} ported programs" in out
    assert len(REGISTRY) == len(JREGISTRY) == 21
    assert "21 ported programs" in out


def test_list_json_declares_channels(capsys):
    assert cli.main(["list", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == set(REGISTRY)
    assert out["msf:channels"]["default"]
    assert "msf/candidate" in out["msf:channels"]["channels"]
    assert out["msf:monolithic"]["build"] == ["raw_out"]


@pytest.mark.parametrize("program", ["pagerank:basic", "msf",
                                     "msf:monolithic"])
def test_run_checks_the_oracle(capsys, program):
    assert cli.main(["run", program, "--scale", "7", "--device", "cpu",
                     "--repeat", "2"]) == 0
    out = capsys.readouterr().out
    assert "oracle: ok" in out and "run 1:" in out
    if program.startswith("msf"):
        assert "candidate" in out


def test_run_personal_pagerank_checks_its_oracle(capsys):
    assert cli.main(["run", "pagerank:personal", "--scale", "8",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "oracle: ok" in out and "scatter_combine" in out


@pytest.mark.parametrize("program", ["pagerank:personal", "pj:reqresp"])
@pytest.mark.parametrize("route_batch", ["union", "lane"])
def test_serve_smoke_of_the_new_batched_programs(capsys, program,
                                                 route_batch):
    assert cli.main(["serve", program, "--device", "cpu", "--smoke",
                     "--route-batch", route_batch]) == 0
    out = capsys.readouterr().out
    assert f"route_batch={route_batch}" in out
    assert "bit-identity: all 12 served outputs" in out


def test_run_without_check_and_unknown_program(capsys):
    assert cli.main(["run", "wcc", "--scale", "6", "--device", "cpu",
                     "--no-check"]) == 0
    assert "oracle" not in capsys.readouterr().out
    with pytest.raises(KeyError, match="not yet ported"):
        cli.main(["run", "pagerank:teleport", "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--on-overflow", "--plan",
                                  "--checkpoint-every", "--resume"])
def test_unported_options_are_absent(flag, capsys, tmp_path, monkeypatch):
    """Every JAX ``run`` option is ported: each refuses a bad value as the
    JAX CLI does, and ``--plan auto`` (the planner, the last one ported)
    plans the run and prints its knob line."""
    argv = ["run", "wcc", "--scale", "6", "--device", "cpu", flag, "1"]
    if flag in ("--plan", "--on-overflow"):
        with pytest.raises(SystemExit):
            cli.main(argv)
        if flag == "--plan":
            monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path))
            capsys.readouterr()
            assert cli.main(argv[:-1] + ["auto"]) == 0
            out = capsys.readouterr().out
            assert "[plan: auto]" in out and "oracle: ok" in out
    elif flag == "--checkpoint-every":
        with pytest.raises(ValueError, match="checkpoint_dir"):
            cli.main(argv)
    else:
        assert cli.main(argv) == 2
        assert "no checkpoint at 1" in capsys.readouterr().out


def test_bench_batch_checks_lanes_and_writes_json(tmp_path, capsys):
    """``bench-batch`` over every batchable program (``sssp:prop``
    among them): each lane held to its serial run, q/s both ways, the
    speedup and the geomean by channel class, and the JSON rows."""
    path = tmp_path / "bb.json"
    assert cli.main(["bench-batch", "--device", "cpu", "--scale", "6",
                     "--workers", "4", "--queries", "3", "--mode",
                     "chunked", "--chunk-size", "3", "--json",
                     str(path)]) == 0
    out = capsys.readouterr().out
    assert out.count("[lanes bit-identical]") == len(BATCHED) == 5
    assert "geomean speedup" in out and "-- static" in out
    data = json.loads(path.read_text())
    assert [r["program"] for r in data["rows"]] == list(BATCHED)
    for row in data["rows"]:
        assert row["q"] == 3 and row["speedup"] > 0
        assert {"queries_per_s_serial", "queries_per_s_batched",
                "channel_class", "route_batch"} <= set(row)
        assert row["batched_cache_hit"]
    assert set(data["geomean_speedup"]) == {"static", "routed"}
    assert cli.main(["bench-batch", "--device", "cpu", "--scale", "6",
                     "--workers", "4", "--queries", "2", "--programs",
                     "sssp:prop,wcc:basic", "--keys", "reach:basic",
                     "--channel-class", "static"]) == 0
    out = capsys.readouterr().out
    assert "sssp:prop" in out and "no query axis" in out
    assert "reach:basic" not in out


def test_run_checkpoints_then_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert cli.main(["run", "wcc:basic", "--scale", "8", "--device", "cpu",
                     "--chunk-size", "1", "--checkpoint-every", "2",
                     "--checkpoint-dir", ck]) == 0
    out = capsys.readouterr().out
    assert "chunked mode" in out and "oracle: ok" in out
    full = [l for l in out.splitlines() if l.startswith("run 0:")][0]
    assert len(list((tmp_path / "ck").glob("*.ckpt"))) >= 2
    assert cli.main(["run", "wcc:basic", "--scale", "8", "--device", "cpu",
                     "--chunk-size", "1", "--resume", ck,
                     "--repeat", "2"]) == 0
    out = capsys.readouterr().out
    assert "resuming from" in out and "resumed at superstep 4" in out
    assert "oracle: ok" in out and "engine session:" in out
    again = [l for l in out.splitlines() if l.startswith("run 0:")][0]
    # the same supersteps, messages and bytes as the uninterrupted run
    assert again.split("wall")[0] == full.split("wall")[0]


def test_run_on_overflow_escalate_prints_the_recovery(capsys, monkeypatch):
    """With every capacity at an eighth (an Engine built with
    ``cap_scales``), ``--on-overflow escalate`` recovers and prints each
    escalation; the counts equal a plain run's."""
    monkeypatch.setattr(cli, "Engine", functools.partial(
        cli.Engine, cap_scales={"*": 0.125}))
    assert cli.main(["run", "wcc:basic", "--scale", "8", "--device", "cpu",
                     "--on-overflow", "escalate", "--repeat", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("recovered: overflow of ['combined_message']") == 3
    assert "oracle: ok" in out and "[hit]" in out
    with pytest.raises(RuntimeError, match="capacity overflow"):
        cli.main(["run", "wcc:basic", "--scale", "8", "--device", "cpu"])


def test_mirror_threshold_counts_match_jax(capsys):
    """``--mirror-threshold``: the mirrored plans' run has the JAX
    package's counts on the same mirrored partition."""
    spec = JREGISTRY["pagerank:scatter"]
    assert cli.main(["run", "pagerank:scatter", "--scale", "8",
                     "--workers", "4", "--device", "cpu", "--mode", "host",
                     "--mirror-threshold", "8"]) == 0
    out = capsys.readouterr().out
    graph = spec.make_graph(8, 0)
    jpg = jpgraph.partition_graph(graph, 4, "random", build=spec.build,
                                  mirror_threshold=8)
    assert jpg.scatter_out.hub_cap > 0
    want = JEngine(mode="host").run(spec.factory(**spec.inputs(graph, 0)),
                                    jpg)
    for name, nbytes in want.bytes_by_channel.items():
        line = [l for l in out.splitlines()
                if l.strip().startswith(name + " ")][0]
        assert line.split()[1:4] == [str(int(nbytes)), "B",
                                     str(int(want.msgs_by_channel[name]))]
    assert cli.main(["run", "pagerank:scatter", "--scale", "8",
                     "--workers", "4", "--device", "cpu", "--mode", "host",
                     "--mirror-threshold", "auto"]) == 0


@pytest.mark.parametrize("mode", ["fused", "chunked"])
def test_run_and_bench_in_the_device_modes(tmp_path, capsys, mode):
    """``--mode``/``--chunk-size``: the oracle holds, the second run of
    ``--repeat 2`` replays the cached loop, the bench rows carry the
    dispatches; an inner-loop program (``run wcc`` is ``wcc:prop``) runs
    there too and holds its oracle."""
    assert cli.main(["run", "sv:both", "--scale", "7", "--device", "cpu",
                     "--mode", mode, "--chunk-size", "2",
                     "--repeat", "2"]) == 0
    out = capsys.readouterr().out
    assert f"{mode} mode" in out and "oracle: ok" in out
    assert "[capture" in out and "[hit]" in out
    path = tmp_path / "bench.json"
    assert cli.main(["bench", "--scale", "6", "--device", "cpu", "--keys",
                     "wcc:basic,pagerank:scatter", "--mode", mode,
                     "--chunk-size", "4", "--json", str(path)]) == 0
    rows = json.loads(path.read_text())["rows"]
    assert [r["mode"] for r in rows] == [mode, mode]
    assert all(r["dispatches"] == -(-r["supersteps"] // 4) for r in rows)
    capsys.readouterr()
    assert cli.main(["run", "wcc", "--scale", "6", "--device", "cpu",
                     "--mode", mode]) == 0
    out = capsys.readouterr().out
    assert "wcc:prop" in out and "oracle: ok" in out


def test_run_and_bench_default_to_the_fused_mode(tmp_path, capsys):
    assert cli.main(["run", "reach", "--scale", "6", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fused mode" in out and "oracle: ok" in out
    path = tmp_path / "bench.json"
    assert cli.main(["bench", "--scale", "6", "--device", "cpu", "--keys",
                     "sssp:basic", "--json", str(path)]) == 0
    assert [r["mode"] for r in json.loads(path.read_text())["rows"]] == [
        "fused"]


def test_serve_smoke_checks_every_answer_against_a_solo_run(capsys):
    """``serve --smoke``: 12 queries through 3 lanes at chunk 3 (forced
    refills), every served answer held to a solo host-mode run, on the
    union route and on the lane route."""
    assert cli.main(["serve", "reach:basic", "--device", "cpu",
                     "--smoke"]) == 0
    out = capsys.readouterr().out
    assert "served 12 queries through 3 lanes" in out
    assert "bit-identity: all 12 served outputs" in out
    assert cli.main(["serve", "--device", "cpu", "--smoke", "--route-batch",
                     "lane"]) == 0
    out = capsys.readouterr().out
    assert "route_batch=lane" in out
    assert "bit-identity: all 12 served outputs" in out
    assert cli.main(["serve", "wcc", "--device", "cpu"]) == 2
    assert "no query axis" in capsys.readouterr().out


def test_bench_writes_rows(tmp_path, capsys):
    out = tmp_path / "bench.json"
    assert cli.main(["bench", "--scale", "6", "--device", "cpu", "--keys",
                     "pagerank:basic,msf:channels", "--json",
                     str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["program"] for r in rows] == ["pagerank:basic",
                                            "msf:channels"]
    assert all(r["supersteps"] > 0 and r["bytes"] > 0 for r in rows)


def test_resolve_takes_bare_algorithm_names():
    assert set(ALGORITHMS) == set(DEFAULT_VARIANT)
    for algo, variant in DEFAULT_VARIANT.items():
        assert resolve(algo).key == f"{algo}:{variant}"
        assert f"{algo}:{variant}" in JREGISTRY
    assert resolve("msf").key == "msf:channels"


def _jax_rows(scale):
    """The five cases through the JAX host-mode Engine, on the JAX
    benchmarks' datasets and instance recipe."""
    eng = JEngine(mode="host")
    rows = []
    for _, name, programs in paper_tables.CASES:
        spec = JREGISTRY[programs[0][1]]
        if name == "tree":
            graph = spec.make_graph(scale, 0)
            pg = jpgraph.partition_graph(graph, 8, "random", build=spec.build)
        else:
            s = max(scale - 2, 6) if spec.algorithm == "msf" else scale
            graph = jbench.dataset(name, s)
            pg = jbench.partitioned(name, s, "random", spec.build)
        inputs = spec.inputs(graph, 0)
        for _, key, knobs in programs:
            res = eng.run(JREGISTRY[key].factory(**inputs, **knobs), pg)
            rows.append((key, res.steps, res.total_msgs, res.total_bytes))
    return rows


def test_paper_tables_match_jax_counts(tmp_path):
    out = paper_tables.run_and_write(8, str(tmp_path / "t.json"),
                                     device="cpu")
    got = [(r["variant"], r["supersteps"], r["messages"], r["bytes"])
           for r in out["rows"]]
    assert got == _jax_rows(8)
    head = out["headline"]
    assert head["composed_beats_unoptimized_rounds"]
    assert head["composed_beats_unoptimized_bytes"]
    comp = next(r for r in out["rows"] if r["variant"] == "sv:composed")
    assert sum(comp["bytes_by_component"].values()) == comp["bytes"]
    assert all(r["ms_per_superstep"] > 0 for r in out["rows"])
    for r in out["rows"]:  # the fused column: the host run's counts
        f = r["fused"]
        assert (f["supersteps"], f["messages"], f["bytes"]) == (
            r["supersteps"], r["messages"], r["bytes"])
        assert f["dispatches"] == 1 and f["cache_hit"]
    written = json.loads((tmp_path / "t.json").read_text())
    assert written["provenance"]["device"] == "cpu"
    assert written["scale"] == 8 and len(written["rows"]) == 10


def test_paper_tables_exit_nonzero_on_a_lost_headline(tmp_path, monkeypatch):
    def lost(scale, device):
        return [], {"composed_beats_unoptimized_rounds": False,
                    "composed_beats_unoptimized_bytes": True}

    monkeypatch.setattr(paper_tables, "run", lost)
    with pytest.raises(SystemExit, match="headline regression"):
        paper_tables.main(["--scale", "6", "--device", "cpu", "--out",
                           str(tmp_path / "t.json")])
    assert (tmp_path / "t.json").exists()


def test_paper_table_datasets_are_the_jax_benchmarks():
    for name, scale in (("web", 7), ("social", 7), ("weighted", 6)):
        got, want = paper_tables.dataset(name, scale), jbench.dataset(name,
                                                                      scale)
        assert got.n == want.n and got.directed == want.directed
        np.testing.assert_array_equal(got.edges, want.edges)
        if want.weights is not None:
            np.testing.assert_array_equal(got.weights, want.weights)


def test_plan_command_prints_each_decision_table(capsys, tmp_path,
                                                 monkeypatch):
    """``plan --explain`` prints one table a program with both cost
    columns and the probe cache; ``--no-calibrate`` plans from the corpus
    alone; ``--queries`` plans a batch."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "cache"))
    assert cli.main(["plan", "wcc:switch", "sssp:basic", "--scale", "7",
                     "--workers", "4", "--device", "cpu", "--explain"]) == 0
    out = capsys.readouterr().out
    assert out.count("plan [auto]") == 2
    assert "measured probe" in out or "corpus fit" in out
    assert f"calibration cache: {tmp_path / 'cache'}" in out
    assert "config ladder" in out
    assert cli.main(["plan", "reach:basic", "--scale", "7", "--workers",
                     "4", "--device", "cpu", "--queries", "16",
                     "--no-calibrate"]) == 0
    out = capsys.readouterr().out
    assert "knobs: mode=fused" in out and "[plan: auto]" in out
    assert "calibration cache" not in out


def test_bench_takes_modes_and_a_plan(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "cache"))
    path = tmp_path / "bench.json"
    assert cli.main(["bench", "--scale", "6", "--device", "cpu", "--keys",
                     "wcc:switch,sssp:basic", "--modes", "host,fused",
                     "--plan", "auto", "--chunk-size", "4", "--json",
                     str(path)]) == 0
    out = capsys.readouterr().out
    assert "[plan: auto]" in out and "engine sessions" in out
    data = json.loads(path.read_text())
    rows = data["rows"]
    assert [(r["program"], r["mode"]) for r in rows] == [
        ("wcc:switch", "host"), ("wcc:switch", "fused"),
        ("sssp:basic", "host"), ("sssp:basic", "fused")]
    for r in rows:
        assert r["plan"]["source"] == "auto"
        assert r["plan"]["mode"] == r["mode"]
        assert r["plan"]["chunk_size"] == 4
    assert rows[0]["bytes"] == rows[1]["bytes"]
    assert set(data["engines"]) == {"host", "fused"}

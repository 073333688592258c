"""The program's own trace of a run, and a cell run with it recorded.

``repro_torch.tracing.recording()`` records spans inside the port,
device spans included: stamps inside the captured superstep loop's
IF and WHILE bodies, on the host's clock. A run that records it over its
set-up and its window carries the recorder's export as
``run.program_trace`` (an attribute the harness's ``Run`` does not
declare: :func:`trace_of` reads it with a default). The per-layer readers
``perfbench/metrics/{superstep_ms,inner_rounds,channel_ms,kernel_ms,
between_steps}.{job,serve}.py``, ``extract_ms.job.py`` and
``harvest_ms.serve.py`` read it through :class:`Window`, which keeps only
the spans inside ``[window_start, window_end]``; each returns None
without a trace.

Run as a script, one cell with the program's recorder on across its
set-up and its window (the harness's ``--trace 1`` run otherwise, its
eager and kernel passes after the recording), printing the result line
with these metrics added and the trace's own checks:

    python3 perfbench/program_trace.py --workload NAME --seed N --seconds S

(``--off`` runs the same cell without the recorder, for the cost of
recording; ``--span-cost`` times empty device spans and host span sites
on the card.) The checks: the window's ``superstep`` spans against the
jobs' ``RunResult.steps`` or the sessions' executed supersteps, the
``kernel:`` spans against the kernels' device launch counters over the
window, dropped stamps, the clock calibration, and the device's gaps
between supersteps by the host span open at each one's midpoint.

:func:`traced_execute` and :func:`main` are a stopgap beside
``harness.execute``: they swap the driver's ``prepare``/``measure`` and
``Engine.serve`` (to count a session's supersteps) for the run, because
the harness cannot open a recording without an edit of its own. Once
``harness.execute`` opens ``recording()`` in its traced branch and
``Run`` declares ``program_trace``, both go, with those patches;
:class:`Window`, the readers and :func:`span_cost` stay.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional

import numpy as np


def trace_of(run) -> Optional[dict]:
    return getattr(run, "program_trace", None)


class Window:
    """The spans of a run's program trace inside its window, with the
    per-layer readers' arithmetic; :meth:`of` gives None without a
    trace or a window."""

    def __init__(self, trace: dict, lo: float, hi: float):
        self.names = trace["names"]
        sp = self.spans = trace["spans"]
        self.lo, self.hi = int(lo * 1e9), int(hi * 1e9)
        self.keep = np.flatnonzero((sp["start_ns"] >= self.lo)
                                   & (sp["end_ns"] <= self.hi))
        self.name = sp["name"][self.keep]
        self.start = sp["start_ns"][self.keep]
        self.end = sp["end_ns"][self.keep]

    def nested(self, ids: np.ndarray) -> np.ndarray:
        """Of the window's spans, those with an ancestor named by
        ``ids``."""
        parent, name = self.spans["parent"], self.spans["name"]
        up = parent[self.keep]
        out = np.zeros(len(up), bool)
        while (up >= 0).any():
            has = up >= 0
            out[has] |= np.isin(name[up[has]], ids)
            up = np.where(has, parent[np.maximum(up, 0)], -1)
        return out

    @classmethod
    def of(cls, run) -> Optional["Window"]:
        trace = trace_of(run)
        if not trace or run.window_start is None or run.window_end is None:
            return None
        return cls(trace, run.window_start, run.window_end)

    def ids(self, match) -> np.ndarray:
        """Name ids whose name equals ``match`` or, for a str ending in
        ":", starts with it."""
        return np.array([i for i, n in enumerate(self.names)
                         if (n.startswith(match) if match.endswith(":")
                             else n == match)], np.int64)

    def mask(self, match) -> np.ndarray:
        return np.isin(self.name, self.ids(match))

    def count(self, match) -> int:
        return int(self.mask(match).sum())

    def seconds(self, match, outermost: bool = False) -> float:
        """Total duration of the spans ``match`` names; with
        ``outermost``, only those with no ancestor among them."""
        keep = self.mask(match)
        if outermost:
            keep &= ~self.nested(self.ids(match))
        return float((self.end[keep] - self.start[keep]).sum()) * 1e-9

    def mean_ms(self, match) -> Optional[float]:
        n = self.count(match)
        return 1e3 * self.seconds(match) / n if n else None

    def per(self, total: float, unit: str) -> Optional[float]:
        """``total`` over the window's spans named ``unit`` (jobs:
        ``engine.run``; dispatches: ``serve.dispatch``)."""
        n = self.count(unit)
        return total / n if n else None

    def uncovered_share(self, match) -> float:
        """The share of the window no span ``match`` names covers."""
        keep = self.mask(match)
        iv = np.column_stack([self.start[keep], self.end[keep]])
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        covered, reach = 0, self.lo
        for s, e in iv:
            s = max(s, reach)
            if e > s:
                covered += e - s
                reach = e
        return 1.0 - covered / max(self.hi - self.lo, 1)


JOB, DISPATCH = "engine.run", "serve.dispatch"


def job_window(run) -> Optional[Window]:
    return Window.of(run) if run.jobs else None


def serve_window(run) -> Optional[Window]:
    return Window.of(run) if run.sessions else None


# -- the recorded cell run ----------------------------------------------------


def _summary(run, extra: dict) -> dict:
    """The trace's own checks and breakdowns over the window."""
    w = Window.of(run)
    tr = trace_of(run)
    names = tr["names"]
    out: Dict[str, object] = dict(extra)
    out["dropped"] = tr["dropped"]
    out["stamps"] = tr["stamps"]
    cal = tr["calibration"]
    out["calibration"] = {"points": len(cal["points"]),
                          "residual_ns": cal["residual_ns"],
                          "granularity_ns": cal["granularity_ns"],
                          "max_half_bracket_ns": int(
                              cal["points"][:, 2].max())
                          if len(cal["points"]) else None}
    out["window_supersteps"] = w.count("superstep")

    def by(prefix):  # name: [spans, ms outside a same-named span]
        return {names[i]: [int((w.name == i).sum()),
                           round(1e3 * w.seconds(names[i], True), 3)]
                for i in w.ids(prefix) if (w.name == i).any()}

    out["kernels_ms"] = by("kernel:")
    out["channels_ms"] = by("channel:")
    out["inner_ms"] = by("inner:")
    out["dedup_dense_ms"] = by("routing.dedup_dense")
    g = tr["gaps"]
    keep = (g["start_ns"] >= w.lo) & (g["end_ns"] <= w.hi)
    gaps: Dict[str, float] = {}
    for n, s, e in zip(g["name"][keep], g["start_ns"][keep],
                       g["end_ns"][keep]):
        key = names[n] if n >= 0 else "(no host span)"
        gaps[key] = gaps.get(key, 0.0) + (e - s) * 1e-9
    out["gaps_s"] = sorted(([k, round(v, 4)] for k, v in gaps.items()),
                           key=lambda kv: -kv[1])[:12]
    sp = tr["spans"]
    host = ~sp["device"]
    part = {}
    for i, n in enumerate(names):
        if n.startswith(("graph.partition", "partition.")):
            k = host & (sp["name"] == i)
            if k.any():
                part[n] = round(float(
                    (sp["end_ns"][k] - sp["start_ns"][k]).sum()) * 1e-9, 3)
    out["partition_s"] = part
    return out


def traced_execute(bench, workload, seed, seconds, device, t0, record=True,
                   root=None):
    """``harness.execute`` of a ``--trace 1`` run with the program's
    recorder on from ``driver.prepare`` through ``driver.measure`` (the
    warm-up captures the stamped loop; the eager and kernel passes run
    after the recording; ``record`` False leaves it off); returns (run,
    result, checks): the kernels' device launches over the window, the
    jobs' supersteps and the sessions' executed supersteps (``root``: the
    checkout whose configurations it runs, by default this one)."""
    import contextlib

    from repro_torch import tracing
    from repro_torch.kernels import ops
    from repro_torch.pregel.engine import Engine

    from perfbench import harness

    root = harness.ROOT if root is None else root
    _, _, traffic = harness.cell_parts(bench, workload, root)
    launches = (ops.device_launch_counts if device.type == "cuda"
                else dict)
    driver = harness.load("drivers", traffic["driver"])
    prepare, measure, serve = driver.prepare, driver.measure, Engine.serve
    stack = contextlib.ExitStack()
    state: Dict[str, object] = {"supersteps": []}

    def serve_counted(self, *a, **kw):
        res = serve(self, *a, **kw)
        state["supersteps"].append(res.supersteps)
        return res

    def recorded_prepare(run):
        if record:
            state["recorder"] = stack.enter_context(
                tracing.recording(device))
        prepare(run)

    def recorded_measure(run, s):
        before = launches()
        Engine.serve = serve_counted
        try:
            measure(run, s)
        finally:
            Engine.serve = serve
            after = launches()
            state["launched"] = {k: after[k] - before[k] for k in after}
            stack.close()
            if record:
                run.program_trace = state["recorder"].export()

    driver.prepare, driver.measure = recorded_prepare, recorded_measure
    try:
        run, result = harness.execute(bench, workload, seed, seconds, True,
                                      device, t0, root)
    finally:
        driver.prepare, driver.measure = prepare, measure
        stack.close()
    checks = {"launched": state.get("launched"),
              "session_supersteps": sum(state["supersteps"]),
              "job_steps": sum(j["steps"] for j in run.jobs)}
    return run, result, checks


NEW_METRICS = ("superstep_ms.job", "superstep_ms.serve", "inner_rounds.job",
               "inner_rounds.serve", "channel_ms.job", "channel_ms.serve",
               "kernel_ms.job", "kernel_ms.serve", "between_steps.job",
               "between_steps.serve", "extract_ms.job", "harvest_ms.serve")


def main(argv) -> int:
    import argparse

    import torch

    from perfbench import harness

    p = argparse.ArgumentParser(prog="perfbench/program_trace.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--off", action="store_true",
                   help="run without the program's recorder")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    bench = harness.manifest()
    device = torch.device("cuda", 0)
    run, result, checks = traced_execute(
        bench, args.workload, args.seed, args.seconds, device, t0,
        record=not args.off)
    for name in NEW_METRICS:
        value = harness.load("metrics", name).read(run)
        if value is not None:
            result["metrics"][name] = {"value": value}
    if trace_of(run) is not None:
        result["program_trace"] = _summary(run, checks)
    else:
        result["program_trace"] = checks
    for note in result.pop("_notes"):
        print(f"perfbench: {note}", file=sys.stderr)
    result.pop("_spans", None)
    print(json.dumps(result, default=float), flush=True)
    return 0


def span_cost(n: int = 2000) -> dict:
    """Device and host cost of the recorder's sites on the card: an empty
    device span (two stamps) launched eagerly and replayed from a
    captured graph, and a host span site off, on, and under no recorder
    (ns each)."""
    import timeit

    import torch
    from repro_torch import tracing

    dev = torch.device("cuda", 0)
    out = {}
    out["host_site_off_ns"] = 1e9 * min(timeit.repeat(
        lambda: tracing.span("x"), number=n, repeat=5)) / n
    out["device_site_off_ns"] = 1e9 * min(timeit.repeat(
        lambda: tracing.device_span("x", dev), number=n, repeat=5)) / n
    with tracing.recording(dev) as rec:
        def host():
            with tracing.span("x"):
                pass
        out["host_span_on_ns"] = 1e9 * min(timeit.repeat(
            host, number=n, repeat=5)) / n

        def empty(k):
            for _ in range(k):
                with tracing.device_span("empty", dev):
                    pass
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            empty(10)
            torch.cuda.synchronize()
            t = time.perf_counter_ns()
            empty(n)
            out["device_span_host_ns"] = (time.perf_counter_ns() - t) / n
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(50_000_000)
            a.record()
            empty(n)
            b.record()
            torch.cuda.synchronize()
            out["device_span_eager_ns"] = 1e6 * a.elapsed_time(b) / n
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=stream):
                empty(n)
            g.replay()
            torch.cuda.synchronize()
            a.record()
            g.replay()
            b.record()
            torch.cuda.synchronize()
            out["device_span_replayed_ns"] = 1e6 * a.elapsed_time(b) / n
            del g
        rec.drain()
    ex = rec.export()
    out["dropped"] = ex["dropped"]
    out["granularity_ns"] = ex["calibration"]["granularity_ns"]
    out["residual_ns"] = ex["calibration"]["residual_ns"]
    return out


if __name__ == "__main__":
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    import perfbench.run  # noqa: F401  (the run's cache paths)
    if "--span-cost" in sys.argv:
        print(json.dumps(span_cost()), flush=True)
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))

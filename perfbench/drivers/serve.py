"""A served stream of point queries through ``Engine.serve``: sessions of
``session_sets`` root sets each, back to back until the window ends.

Arrivals are a Poisson process on the program's superstep clock at
``load`` of the lanes' capacity, ``load * lanes / mean_steps`` a
superstep, ``mean_steps`` being the supersteps a query takes (a count,
the same on any device, written into the traffic file). The k-th session
of every run has the same gaps between arrivals, in an order drawn from
the run's seed, so every seed offers the same load.

A query's latency is taken on the harness's clock, through objects the
harness hands the program: from the first moment the session's clock has
reached the query's arrival (the harness's queue sees every boundary's
clock) to the moment its answer is extracted (the harness's wrapper of
the program's ``extract``). A query that fails has no answer and counts
as missing every limit.

The check samples ``check_sample`` answers of each lane, so a fault
confined to one lane is seen in every run.

Traffic keys: ``program``, ``knobs``, ``plans``, ``lanes``, ``chunk``,
``load``, ``mean_steps``, ``session_sets``, ``root_sets`` (the sets drawn
in set-up).
"""
from __future__ import annotations

import dataclasses
import math
import time

from perfbench import yardstick


def _timed_queue(arrivals, roots):
    """The port's ``QueryQueue`` with the harness's stamp of the moment
    each entry is first due."""
    from repro_torch.pregel.serve import QueryQueue

    class TimedQueue(QueryQueue):
        def __init__(self):
            super().__init__()
            self.due_at = {}
            self._order = []
            self._next = 0

        def _stamp(self, now):
            t = time.perf_counter()
            while (self._next < len(self._order)
                   and self._order[self._next][0] <= now):
                self.due_at[self._order[self._next][1]] = t
                self._next += 1

        def mark_eligible(self, now, wall_s):
            self._stamp(now)
            super().mark_eligible(now, wall_s)

        def pop_ready(self, now):
            self._stamp(now)
            return super().pop_ready(now)

    q = TimedQueue()
    for arrival, root in zip(arrivals, roots):
        q._order.append((arrival, q.push(root, arrival)))
    q._order.sort()
    return q


def _session(run, stream: tuple, roots):
    """One ``Engine.serve`` session of ``roots`` arriving on the Poisson
    schedule of sub-stream ``stream``: (start, end, ServeResult, queue)."""
    t = run.traffic
    st = run.state
    rate = t["load"] * t["lanes"] / t["mean_steps"]
    arrivals = yardstick.poisson_arrivals(
        len(roots), rate, yardstick.substream(0, *stream),
        yardstick.substream(run.seed, *stream))
    queue = _timed_queue(arrivals, roots)
    st["finished_at"].clear()
    start = time.perf_counter()
    res = st["engine"].serve(st["program"], st["pg"], queue,
                             num_lanes=t["lanes"], chunk_size=t["chunk"])
    end = time.perf_counter()
    return start, end, res, queue


def prepare(run) -> None:
    from repro_torch.algorithms import get_program
    from repro_torch.pregel.engine import Engine

    t = run.traffic
    st = run.state
    st["pg"] = run.partition(t["plans"])
    base = get_program(t["program"], **t.get("knobs", {}))
    finished = st["finished_at"] = {}

    def extract(pg, state):
        out = base.extract(pg, state)
        finished[id(out)] = time.perf_counter()
        return out

    st["program"] = dataclasses.replace(base, extract=extract)
    st["engine"] = Engine(device=run.device)
    run.draw_root_sets(t["root_sets"])
    # two short sessions of the cell's shape, a query a lane: the first
    # builds and captures the serving loop, the second replays it
    warm = run.root_set(0)[:t["lanes"]]
    start = time.perf_counter()
    for i in range(2):
        _session(run, (6, i), warm)
    run.spans["warmup_s"] = time.perf_counter() - start


def measure(run, seconds: float) -> None:
    t = run.traffic
    run.window_start = time.perf_counter()
    index = 0
    while True:
        roots = [r for k in range(t["session_sets"])
                 for r in run.root_set(index * t["session_sets"] + k)]
        start, end, res, queue = _session(run, (4, index), roots)
        finished = run.state["finished_at"]
        if not res.cache_hit:
            run.notes.append(f"session {index} built its loop inside the "
                             "window")
        run.sessions.append(dict(
            start=start, end=end, dispatches=res.dispatches,
            program_wall_s=res.wall_time_s))
        for rec in res.records:
            done = finished.get(id(rec.output)) if rec.output is not None \
                else None
            due = queue.due_at.get(rec.qid)
            run.queries.append(dict(
                latency_s=(done - due) if done is not None and due is not None
                else math.inf,
                program_lane_wait_s=rec.wall_admitted_s - rec.wall_eligible_s,
                steps=rec.steps, channel_bytes=rec.total_bytes,
                status=rec.status))
            if rec.output is not None:
                run.keep(rec.query, rec.output, stratum=rec.lane)
        index += 1
        if end - run.window_start >= seconds:
            break
    run.window_end = run.sessions[-1]["end"]


def host_pass(run) -> None:
    """The lanes' batch of the first session's roots in host mode, its
    kernel launches eager (the traced run's rooflines)."""
    from repro_torch.pregel.engine import Engine

    st = run.state
    roots = run.root_set(0)[:run.traffic["lanes"]]
    Engine(mode="host", device=run.device).run_batch(
        st["program"], st["pg"], roots)


def release(run) -> None:
    st = run.state
    st["engine"].clear_cache()
    for k in ("engine", "program", "pg"):
        st.pop(k, None)

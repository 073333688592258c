"""Back-to-back whole jobs, a closed loop of one client: each job is one
``Engine.run`` of the traffic's program, from its inputs to its output on
the host, and the next starts when it returns.

The Engine is the port's default one (``Engine(device=...)``), so a
change of its default mode or overflow policy shows in these cells.

Traffic keys: ``program`` and ``knobs`` (``get_program``'s), ``plans`` (the
partition's), and ``roots``: true where each job answers one search root,
taken in order from the run's root sets (``root_sets`` of them drawn in
set-up).
The program's ``query_init`` is then its init, so one captured loop
serves every root; a new program a root would build and capture a loop
for each.
"""
from __future__ import annotations

import dataclasses
import time

#: jobs run in set-up: the first builds and captures the loop, the second
#: replays it
WARMUP_JOBS = 2


def _job(run, root=None) -> dict:
    st = run.state
    if root is not None:
        st["root"][0] = root
    t = time.perf_counter()
    res = st["engine"].run(st["program"], st["pg"])
    out = res.output
    end = time.perf_counter()
    return dict(start=t, end=end, output=out, steps=res.steps,
                host_overhead_s=res.host_overhead_s,
                channel_bytes=int(sum(res.bytes_by_channel.values())),
                cache_hit=res.cache_hit)


def _roots(run):
    i = 0
    while True:
        yield from run.root_set(i)
        i += 1


def prepare(run) -> None:
    from repro_torch.algorithms import get_program
    from repro_torch.pregel.engine import Engine

    t = run.traffic
    st = run.state
    st["pg"] = run.partition(t["plans"])
    prog = get_program(t["program"], **t.get("knobs", {}))
    if t.get("roots"):
        holder = st["root"] = [None]
        query_init = prog.query_init
        prog = dataclasses.replace(
            prog, init=lambda pg: query_init(pg, holder[0]))
    st["program"] = prog
    st["engine"] = Engine(device=run.device)
    if t.get("roots"):
        run.draw_root_sets(t["root_sets"])
    st["roots"] = _roots(run) if t.get("roots") else None
    warm = time.perf_counter()
    for _ in range(WARMUP_JOBS):
        job = _job(run, next(st["roots"]) if st["roots"] else None)
        run.state.setdefault("warmup", []).append(
            {k: v for k, v in job.items() if k != "output"})
    run.spans["warmup_s"] = time.perf_counter() - warm
    # the window's roots start again at the first set
    st["roots"] = _roots(run) if t.get("roots") else None


def measure(run, seconds: float) -> None:
    st = run.state
    run.window_start = time.perf_counter()
    while True:
        root = next(st["roots"]) if st["roots"] else None
        job = _job(run, root)
        run.keep(root, job.pop("output"))
        run.jobs.append(job)
        if not job["cache_hit"] and st["engine"].mode != "host":
            run.notes.append(f"job {len(run.jobs) - 1} built its loop "
                             "inside the window")
        if job["end"] - run.window_start >= seconds:
            break
    run.window_end = run.jobs[-1]["end"]


def host_pass(run) -> None:
    """One more job in host mode, its kernel launches eager (the traced
    run's rooflines)."""
    from repro_torch.pregel.engine import Engine

    st = run.state
    if st["roots"] is not None:
        st["root"][0] = run.answers[0][0]
    Engine(mode="host", device=run.device).run(st["program"], st["pg"])


def release(run) -> None:
    st = run.state
    st["engine"].clear_cache()
    for k in ("engine", "program", "pg", "roots"):
        st.pop(k, None)

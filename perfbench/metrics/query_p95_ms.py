"""query_p95_ms: the 95th percentile, over every query of the window's
sessions, of the time from its arrival coming due on the session's
superstep clock to its answer; a failed query counts as infinitely late.
Host clock (the harness's queue and extract wrapper)."""
from perfbench import yardstick


def read(run):
    if not run.queries:
        return None
    return 1e3 * yardstick.percentile(
        [q["latency_s"] for q in run.queries], 95)

"""lane_wait_ms.serve: the program's stamps of a query's wait for a lane
(QueryRecord.wall_admitted_s - wall_eligible_s), the mean over the
window's queries."""


def read(run):
    if not run.queries:
        return None
    return 1e3 * sum(q["program_lane_wait_s"] for q in run.queries) / len(
        run.queries)

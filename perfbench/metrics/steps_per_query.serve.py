"""steps_per_query.serve: supersteps a served query ran
(QueryRecord.steps), the mean over the window's queries."""


def read(run):
    if not run.queries:
        return None
    return sum(q["steps"] for q in run.queries) / len(run.queries)

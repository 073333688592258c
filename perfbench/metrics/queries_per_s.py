"""queries_per_s: queries answered over the wall time of the window's
sessions (a failed query is not answered). Host clock."""


def read(run):
    if not run.sessions:
        return None
    ok = sum(q["status"] == "ok" for q in run.queries)
    return ok / run.window_s

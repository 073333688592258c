"""chunk_ms.serve: the program's wall time of its serving loop over its
dispatches (ServeResult.wall_time_s / dispatches), over the window's
sessions."""


def read(run):
    dispatches = sum(s["dispatches"] for s in run.sessions)
    if not dispatches:
        return None
    return 1e3 * sum(s["program_wall_s"] for s in run.sessions) / dispatches

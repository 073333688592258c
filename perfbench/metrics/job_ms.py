"""job_ms: the window's wall time over the jobs completed in it; a job is
one Engine.run through its output on the host. Host clock."""


def read(run):
    if not run.jobs:
        return None
    return 1e3 * run.window_s / len(run.jobs)

"""host_overhead_ms.job: the program's own count of host time a job spent
driving its loop without waiting for the device (RunResult.host_overhead_s),
the mean over the window's jobs."""


def read(run):
    if not run.jobs:
        return None
    return 1e3 * sum(j["host_overhead_s"] for j in run.jobs) / len(run.jobs)

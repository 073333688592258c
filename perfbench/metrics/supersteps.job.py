"""supersteps.job: supersteps a job ran (RunResult.steps), the mean over
the window's jobs."""


def read(run):
    if not run.jobs:
        return None
    return sum(j["steps"] for j in run.jobs) / len(run.jobs)

"""channel_mb.job: bytes the channels sent in a job (the sum of
RunResult.bytes_by_channel), in MB (1e6 bytes), the mean over the
window's jobs."""


def read(run):
    if not run.jobs:
        return None
    return sum(j["channel_bytes"] for j in run.jobs) / len(run.jobs) / 1e6

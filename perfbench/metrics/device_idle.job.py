"""device_idle.job: the share of the traced window of jobs in which no
kernel ran on the card, from the card's utilization counter (NVML)
sampled across the window."""


def read(run):
    t = run.device_trace
    if not run.jobs or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

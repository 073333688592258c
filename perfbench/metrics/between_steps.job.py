"""between_steps.job: the share of the window of jobs in which no
superstep span of the program's trace is open on the device (the
device's stamps, mapped onto the host clock). None without a program
trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.job_window(run)
    return None if w is None else 100.0 * w.uncovered_share("superstep")

"""channel_ms.job: device ms inside the outermost channel:<name> spans of
the program's trace (a composed channel's own channels not counted twice)
a job, over the window's jobs. None without a program trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.job_window(run)
    if w is None:
        return None
    return w.per(1e3 * w.seconds("channel:", outermost=True), pt.JOB)

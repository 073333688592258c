"""superstep_ms.job: the mean device duration of a superstep span of the
program's trace (repro_torch.tracing: stamps inside the captured loop's IF
nodes) over the window's jobs. None without a program trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.job_window(run)
    return None if w is None else w.mean_ms("superstep")

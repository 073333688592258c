"""inner_rounds.job: inner-loop body runs a job, every site and depth (one
inner:<site> span of the program's trace a run of a WHILE body), the mean
over the window's jobs (engine.run spans). None without a program trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.job_window(run)
    return None if w is None else w.per(w.count("inner:"), pt.JOB)

"""superstep_ms.serve: the mean device duration of a superstep span of the
program's trace (a superstep of all 32 lanes, stamped inside the captured
serving loop) over the window's sessions. None without a program trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.serve_window(run)
    return None if w is None else w.mean_ms("superstep")

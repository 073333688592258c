"""between_steps.serve: the share of the window of sessions in which no
superstep span of the program's trace is open on the device. None
without a program trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.serve_window(run)
    return None if w is None else 100.0 * w.uncovered_share("superstep")

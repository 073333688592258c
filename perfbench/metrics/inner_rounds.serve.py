"""inner_rounds.serve: inner-loop body runs a serving dispatch, every site
and depth (inner:<site> spans of the program's trace), the mean over the
window's dispatches (serve.dispatch spans). None without a program
trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.serve_window(run)
    return None if w is None else w.per(w.count("inner:"), pt.DISPATCH)

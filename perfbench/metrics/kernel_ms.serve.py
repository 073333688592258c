"""kernel_ms.serve: device ms inside the kernel:<entry point> spans of the
program's trace a serving dispatch, over the window's dispatches. None
without a program trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.serve_window(run)
    if w is None:
        return None
    return w.per(1e3 * w.seconds("kernel:"), pt.DISPATCH)

"""harvest_ms.serve: host ms of the program's serve.harvest spans (a
boundary's accounting, quarantine and extract of the halted lanes) a
serving dispatch, over the window's dispatches. None without a program
trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.serve_window(run)
    if w is None:
        return None
    return w.per(1e3 * w.seconds("serve.harvest"), pt.DISPATCH)

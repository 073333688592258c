"""extract_ms.job: the host duration of the program's engine.extract span
(VertexProgram.extract of the final state) a job, the mean over the
window's jobs. None without a program trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.job_window(run)
    return None if w is None else w.mean_ms("engine.extract")

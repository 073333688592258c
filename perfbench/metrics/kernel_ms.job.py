"""kernel_ms.job: device ms inside the kernel:<entry point> spans of the
program's trace (kernels.ops calls that launch a kernel, in the captured
loop) a job, over the window's jobs. None without a program trace."""
from perfbench import program_trace as pt


def read(run):
    w = pt.job_window(run)
    return None if w is None else w.per(1e3 * w.seconds("kernel:"), pt.JOB)

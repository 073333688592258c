"""setup_s: process start to the first timed job or session (CUDA start,
the kernels' load or build, the graph made on the device, the port's
partition, the loop's warm-up and capture). Host clock."""


def read(run):
    return run.setup_s

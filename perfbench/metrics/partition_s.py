"""partition_s: the port's partition_graph of the generated graph (the
host's plan tables and their move to the device), on the harness clock."""


def read(run):
    return run.partition_s

"""Graphs of the port: generators, partitioners, host oracles and the
partitioned device graph with its channel plans."""

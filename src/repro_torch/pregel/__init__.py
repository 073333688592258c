"""The superstep runtime of the port: programs, the host-driven loop,
the Engine session and the failure taxonomy."""

"""channel_mb.serve: bytes the channels sent for a served query (the sum
of its record's bytes_by_channel), in MB (1e6 bytes), the mean over the
window's queries."""


def read(run):
    if not run.queries:
        return None
    return sum(q["channel_bytes"] for q in run.queries) / len(
        run.queries) / 1e6

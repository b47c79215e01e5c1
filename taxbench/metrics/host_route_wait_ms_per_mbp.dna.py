"""BatchAligner.stage_seconds' host_long_wait, ms a query Mbp: the time the
host C++ route adds to a sample beyond the card's buckets."""

from taxbench import readers


def read(ctx):
    if any(readers.host_route_wait_s(s) is None for s in ctx["samples"]):
        return None
    return readers.ms_per_unit(ctx, readers.host_route_wait_s)

"""The engine thread blocked: its engine.wait_round (on a round's device
finish) and engine.wait_parse (on the parse queue) spans, ms a query
Mbp."""

from taxbench import spans


def read(ctx):
    return spans.ms_per_mbp(ctx, "engine.wait_round", "engine.wait_parse")

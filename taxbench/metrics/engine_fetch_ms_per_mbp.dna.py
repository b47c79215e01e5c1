"""The engine's engine.fetch spans (each round's segment fetch and
encode), ms a query Mbp."""

from taxbench import spans


def read(ctx):
    return spans.ms_per_mbp(ctx, "engine.fetch")

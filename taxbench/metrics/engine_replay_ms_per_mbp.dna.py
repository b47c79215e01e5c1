"""The engine's engine.replay spans (each macro-batch's prepare and replay
passes), ms a query Mbp."""

from taxbench import spans


def read(ctx):
    return spans.ms_per_mbp(ctx, "engine.replay")

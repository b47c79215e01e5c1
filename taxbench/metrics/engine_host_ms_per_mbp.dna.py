"""RpaEngine.run's span less the aligner's stages and waits (parse,
grouping, replay, fetch, emit), ms a query Mbp."""

from taxbench import readers


def read(ctx):
    return readers.ms_per_unit(ctx, readers.engine_host_s)

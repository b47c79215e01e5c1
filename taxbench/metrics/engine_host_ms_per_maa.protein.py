"""RpaEngine.run's span less the aligner's stages (parse, grouping, replay, fetch, emit), ms a query Maa."""

from taxbench import readers


def read(ctx):
    return readers.ms_per_unit(ctx, readers.engine_host_s)

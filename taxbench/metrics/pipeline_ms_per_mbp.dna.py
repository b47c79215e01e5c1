"""Sample wall outside RpaEngine.run (archive, taxonomy, sort's finish, binner, summaries), ms a query Mbp."""

from taxbench import readers


def read(ctx):
    return readers.ms_per_unit(ctx, readers.pipeline_s)

"""BatchAligner.stage_seconds' stage_batch + device + collect, ms a query Mbp."""

from taxbench import readers


def read(ctx):
    return readers.ms_per_unit(ctx, readers.aligner_prep_s)

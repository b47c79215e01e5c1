"""max_memory_allocated over the window after a reset, MB."""

from taxbench import readers


def read(ctx):
    return readers.peak_mb(ctx)

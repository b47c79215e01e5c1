"""MB the device pool shipped over the window's query Mbp (a count)."""

from taxbench import readers


def read(ctx):
    return readers.per_mega_unit(
        ctx, lambda s: s["pool"]["bytes_shipped"] / 1e6)

"""Kernel 1's share of its roofline over the window's launches, %."""

from taxbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "myers_short")

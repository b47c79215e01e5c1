"""Share of the window with no kernel or copy on the card, %."""

from taxbench import readers


def read(ctx):
    return readers.idle_pct(ctx)

"""The program's count of blocking host-to-device copies (h2d.blocking)
over the window's query Mbp; None where no copy went to a card."""

from taxbench import spans


def read(ctx):
    got = spans.window(ctx)
    n = got["counts"].get(spans.H2D_BLOCKING) if got else None
    return spans.per_mbp(ctx, n) if n else None

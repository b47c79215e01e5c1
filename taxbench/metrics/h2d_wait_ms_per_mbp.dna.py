"""The entries' blocking host-to-device copies, h2d spans (each waits for
the work queued before it on the stream), ms a query Mbp; None where no
copy went to a card."""

from taxbench import spans


def read(ctx):
    got = spans.window(ctx)
    if got is None or not spans.seconds(got["spans"], "h2d"):
        return None
    return spans.ms_per_mbp(ctx, "h2d")

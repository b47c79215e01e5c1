"""The aligner's aligner.device spans (the entries' dedupe, packing, pool,
peq build, launch and readback set-up) less the h2d copies under them,
ms a query Mbp."""

from taxbench import spans


def read(ctx):
    got = spans.window(ctx)
    if got is None:
        return None
    return spans.per_mbp(ctx, spans.entry_prep_s(got["spans"]) * 1e3)

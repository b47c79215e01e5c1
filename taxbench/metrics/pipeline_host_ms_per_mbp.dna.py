"""The workflow's own pipeline.* spans (archive, taxonomy, stores, sort's
finish, binner, summaries), all but pipeline.engine, ms a query Mbp."""

from taxbench import spans


def read(ctx):
    got = spans.window(ctx)
    if got is None:
        return None
    return spans.per_mbp(ctx, spans.pipeline_host_s(got["spans"]) * 1e3)

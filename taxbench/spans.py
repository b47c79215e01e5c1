"""What the readers of the program's own spans share: the metrics that read
taxtk_torch/engine/metrics.py's recorder (pipeline_host_*, engine_*,
entry_prep_*, h2d_*).

In a `--trace 1` run, run.py switches the recorder on as the window opens
and off as it closes, and hands what it kept to the readers as
ctx["program"]; an untraced run leaves the recorder off and ctx["program"]
None, and each reader then returns None.  A span is a dict: name, start,
end (seconds on time.perf_counter), id, parent, thread, run, batch, round,
count.
"""

from __future__ import annotations

KEY = "program"
H2D_BLOCKING = "h2d.blocking"  # the program's counter of blocking copies


def window(ctx):
    """{"spans": [...], "counts": {...}} the program kept through the
    window, or None where it kept no span."""
    got = ctx.get(KEY)
    return got if got and got["spans"] else None


def seconds(spans, *names):
    """Seconds of the spans of those names."""
    return sum(s["end"] - s["start"] for s in spans if s["name"] in names)


def per_mbp(ctx, value):
    """value over the window's query size in millions of bases."""
    mbp = sum(s["size"] for s in ctx["samples"]) / 1e6
    return value / mbp if mbp else None


def ms_per_mbp(ctx, *names):
    """Milliseconds a query Mbp in the program's spans of those names;
    None where the program kept no span."""
    got = window(ctx)
    if got is None:
        return None
    return per_mbp(ctx, seconds(got["spans"], *names) * 1e3)


def pipeline_host_s(spans):
    """The workflow's own stages: its pipeline.* spans but the engine's."""
    return sum(s["end"] - s["start"] for s in spans
               if s["name"].startswith("pipeline.")
               and s["name"] != "pipeline.engine")


def entry_prep_s(spans):
    """The aligner's `device` spans (the entries' host prep and launch)
    less the h2d copies anywhere under them."""
    children = {}
    for s in spans:
        children.setdefault(s["parent"], []).append(s)
    total = 0.0
    for root in spans:
        if root["name"] != "aligner.device":
            continue
        total += root["end"] - root["start"]
        todo = [root]
        while todo:
            for c in children.get(todo.pop()["id"], ()):
                if c["name"] == "h2d":
                    total -= c["end"] - c["start"]
                else:
                    todo.append(c)
    return total

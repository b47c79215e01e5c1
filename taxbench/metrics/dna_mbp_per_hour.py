"""Query Mbp of the window's samples over the window's whole time, per hour."""


def read(ctx):
    mbp = sum(s["size"] for s in ctx["samples"]) / 1e6
    return mbp * 3600.0 / ctx["window_s"] if mbp else None

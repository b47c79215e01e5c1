"""Query Maa of the window's samples over the window's whole time, per hour."""


def read(ctx):
    maa = sum(s["size"] for s in ctx["samples"]) / 1e6
    return maa * 3600.0 / ctx["window_s"] if maa else None

"""What the per-layer metrics' readers (taxbench/metrics/<name>.py) share.

A reader's `read(ctx)` returns the metric's value, or None where the run
has nothing for it to read; the harness then leaves the metric out.  ctx
holds the window's samples (each with its wall, its stages' seconds, the
aligner's stage seconds, the pool's counters and its query size in bases
or residues), the window's length, the window's device peak, the device
trace (or None), each roofline's recorded calls and, in a traced run,
the program's own spans and counters (spans.py).
"""

from __future__ import annotations


def per_mega_unit(ctx, value_of):
    """The sum of value_of(sample) over the window's samples, over their
    query size in millions of bases (or residues)."""
    units = sum(s["size"] for s in ctx["samples"]) / 1e6
    if not units:
        return None
    return sum(value_of(s) for s in ctx["samples"]) / units


def ms_per_unit(ctx, seconds_of):
    """Milliseconds a million query bases (or residues) of the window's
    samples spend in what seconds_of(sample) returns."""
    return per_mega_unit(ctx, lambda s: seconds_of(s) * 1e3)


def aligner_prep_s(sample):
    """The aligner's own stages: bucket staging, the entries' host prep and
    launch, and the collection of results."""
    a = sample["aligner"]
    return a.get("stage_batch", 0.0) + a.get("device", 0.0) + a.get(
        "collect", 0.0)


def host_route_wait_s(sample):
    """How long the host C++ route (pairs above the device's caps) outlasted
    the device buckets of its round; None for a sample that sent no pair
    there."""
    if not sample["host_long_pairs"]:
        return None
    return sample["aligner"].get("host_long_wait", 0.0)


def roofline_pct(ctx, kernel):
    """The window's bound time of a kernel's launches over their device
    time, in percent; None without a trace or without launches."""
    trace, roof = ctx.get("trace"), ctx["rooflines"].get(kernel)
    if trace is None or roof is None:
        return None
    calls = roof["calls"]
    launches = [(n, b - a) for n, a, b in trace["intervals"]
                if roof["kernel"] in n]
    if not calls or not launches:
        return None
    if len(calls) != len(launches):
        raise RuntimeError(f"{kernel}: {len(calls)} entry calls but "
                           f"{len(launches)} launches in the trace")
    # one stream: the k-th launch in the trace is the k-th call's
    bound = sum(roof["bound_s"](c, ctx["card"], n)
                for c, (n, _) in zip(calls, launches))
    return 100.0 * bound / sum(t for _, t in launches)


def idle_pct(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def peak_mb(ctx):
    peak = ctx.get("peak_window_bytes")
    return None if peak is None else peak / 1e6

"""The metrics read from the program's own spans: each reader on a
hand-built window, a traced CPU run of the cell, which keeps the
program's recorder on through its window, and the breakdown's names of
the idle gaps."""

import importlib.util
import os

import pytest

from tiny_mixes import TINY
from taxbench import run

SPAN_METRICS = {
    "pipeline_host_ms_per_mbp.dna": 600.0,
    "engine_replay_ms_per_mbp.dna": 100.0,
    "engine_fetch_ms_per_mbp.dna": 50.0,
    "engine_wait_ms_per_mbp.dna": 750.0,
    "entry_prep_ms_per_mbp.dna": 600.0,
    "h2d_wait_ms_per_mbp.dna": 300.0,
    "h2d_blocking_per_mbp.dna": 2.0,
}
H2D = {"h2d_wait_ms_per_mbp.dna", "h2d_blocking_per_mbp.dna"}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(run.HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _spans(h2d=True):
    """One 1-Mbp sample's spans, from (name, start, end, parent's name)."""
    rows = [
        ("pipeline.archive", 0.0, 0.1, None),
        ("pipeline.taxonomy", 0.1, 0.2, None),
        ("pipeline.engine", 0.2, 2.2, None),
        ("engine.replay", 0.2, 0.3, "pipeline.engine"),
        ("engine.fetch", 0.3, 0.35, "pipeline.engine"),
        ("engine.align", 0.35, 1.35, "pipeline.engine"),
        ("aligner.device", 0.4, 1.3, "engine.align"),
        ("entry.pack", 0.4, 0.6, "aligner.device"),
        ("pool.ensure", 0.6, 0.9, "aligner.device"),
        ("h2d", 0.7, 0.8, "pool.ensure"),
        ("h2d", 1.0, 1.2, "aligner.device"),
        ("entry.launch", 1.2, 1.3, "aligner.device"),
        ("engine.wait_round", 1.35, 2.0, "pipeline.engine"),
        ("engine.wait_parse", 2.0, 2.1, "pipeline.engine"),
        ("aligner.device_wait", 0.5, 1.9, None),
        ("pipeline.sort", 2.2, 2.3, None),
        ("pipeline.binner", 2.3, 2.5, None),
        ("pipeline.summaries", 2.5, 2.6, None),
    ]
    if not h2d:
        rows = [r for r in rows if r[0] != "h2d"]
    ids = {}
    spans = []
    for k, (name, a, b, parent) in enumerate(rows, 1):
        ids.setdefault(name, k)
        spans.append(dict(name=name, start=a, end=b, id=k,
                          parent=ids.get(parent), thread="MainThread",
                          run=1, batch=0, round=0, count=None))
    return spans


def _ctx(h2d=True, samples=2):
    """A window of 1-Mbp samples, each with the spans of _spans."""
    spans = []
    for k in range(samples):
        for s in _spans(h2d):
            spans.append(dict(s, id=s["id"] + 100 * k,
                              parent=s["parent"] and s["parent"] + 100 * k))
    return {"samples": [{"size": 1_000_000}] * samples,
            "program": {"spans": spans,
                        "counts": {"h2d.blocking": 2 * samples} if h2d
                        else {}}}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_readers(name):
    read = _reader(name)
    assert read(_ctx()) == pytest.approx(SPAN_METRICS[name])
    # nothing kept: a program without the recorder, or no profiler
    assert read(dict(_ctx(), program=None)) is None
    assert read(dict(_ctx(), program={"spans": [], "counts": {}})) is None
    no_copy = read(_ctx(h2d=False))
    if name in H2D:
        assert no_copy is None
    else:
        assert no_copy is not None


def test_traced_cpu_run_reports_span_metrics():
    """A traced run switches the program's recorder on through the window,
    on the CPU as on a card."""
    res = run.run_cell("dna-long", 2**31 + 3, 0.1, 1, device="cpu",
                       traffic=TINY["dna-long"])
    assert res["correct"]
    got = set(res["metrics"])
    assert set(SPAN_METRICS) - H2D <= got
    assert not got & H2D
    for name in set(SPAN_METRICS) - H2D:
        assert res["metrics"][name]["value"] >= 0


def test_runs_leave_the_recorder_alone(monkeypatch):
    """An untraced run never switches the recorder on; a traced one
    switches it off as its window closes and leaves no span in it."""
    from taxtk_torch.engine import metrics

    real = metrics.start_tracing
    calls = []

    def start(*a, **kw):
        calls.append(trace)
        return real(*a, **kw)

    monkeypatch.setattr(metrics, "start_tracing", start)
    metrics.drain()
    for trace in (0, 1):
        res = run.run_cell("dna-long", 2**31 + 3, 0.1, trace, device="cpu",
                           traffic=TINY["dna-long"])
        assert res["correct"]
        assert bool(set(SPAN_METRICS) & set(res["metrics"])) == bool(trace)
        assert not metrics.RECORDER.on
        assert metrics.drain() == {"spans": [], "counts": {}}
    assert calls == [1]


def test_breakdown_names_gaps_by_the_program_spans():
    """Each idle gap takes the innermost span the program kept on the
    workflow's thread at the gap's middle; other threads' spans do not
    count, and where the program kept none there the harness's span
    names it."""
    intervals = [("k", 1.0, 2.0), ("k", 3.0, 4.0), ("k", 6.0, 9.5)]
    harness = [("sample", 0.0, 10.0), ("engine", 0.7, 9.8)]

    def span(name, a, b, thread="MainThread"):
        return dict(name=name, start=a, end=b, thread=thread)

    program = [span("pipeline.engine", 0.6, 9.8),
               span("engine.wait_round", 2.0, 3.0),
               span("aligner.host_long", 2.0, 3.0, thread="taxtk-host-long"),
               span("engine.fetch", 4.5, 6.0),
               span("aligner.device", 5.0, 5.8)]
    got = run.make_breakdown(intervals, harness, 0.0, 10.0, program,
                             "MainThread")
    # gaps, longest first: [4, 6] (middle 5: device), [0, 1] (no program
    # span: the harness's sample), [2, 3] (wait_round, not the host
    # route's thread), [9.5, 10] (pipeline.engine)
    assert got["idle_gaps"] == [["aligner.device", 2.0], ["sample", 1.0],
                                ["engine.wait_round", 1.0],
                                ["pipeline.engine", 0.5]]
    assert got["device_ops"] == [["k", 5.5]]
    # without the program's spans, the harness's name every gap
    assert [g[0] for g in run.make_breakdown(
        intervals, harness, 0.0, 10.0)["idle_gaps"]] == [
        "engine", "sample", "engine", "engine"]

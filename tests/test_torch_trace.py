"""The span recorder of taxtk_torch (engine/metrics.py) on the CPU: nesting
and parents across threads, its clock, recording off and on, and the
spans of a traced run of the binning workflow on a three-contig sample."""

import os
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

from bench_e2e import make_workload  # noqa: E402

from taxtk_torch.engine import metrics  # noqa: E402
from taxtk_torch.engine.metrics import EngineMetrics, SpanRecorder  # noqa: E402

# every span of a traced run_binning_workflow; h2d (and entry.readback)
# open only for a copy to a card
SPANS = {
    "pipeline.archive", "pipeline.taxonomy", "pipeline.stores",
    "pipeline.engine", "pipeline.sort", "pipeline.binner",
    "pipeline.summaries",
    "engine.parse", "engine.wait_parse", "engine.replay", "engine.fetch",
    "engine.align", "engine.wait_round", "engine.emit",
    "aligner.route", "aligner.stage_batch", "aligner.device",
    "aligner.device_wait", "aligner.collect", "aligner.host_long",
    "aligner.host_long_wait",
    "entry.dedupe", "entry.pack", "entry.peq", "entry.meta", "entry.launch",
    "pool.ensure", "pool.pack",
}


SEED = 5


def dna_sample(root, contigs, seed, min_len, max_len):
    """A nucleotide refpack (refdata.fna, mapping.tax, ncbi-taxonomy/)
    and a sample against it, from bench_e2e.make_workload."""
    aln, query, ref_fa, _, tax, _ = make_workload(
        str(root), contigs, seed=seed, min_len=min_len, max_len=max_len)
    os.rename(tax, os.path.join(str(root), "ncbi-taxonomy"))
    return {"refpack": str(root), "query": query, "alignments": aln,
            "refdata": ref_fa}


@pytest.fixture
def tracing():
    """The process's recorder switched on, and off and empty afterwards."""
    metrics.drain()
    metrics.start_tracing()
    try:
        yield metrics
    finally:
        metrics.stop_tracing()
        metrics.drain()


def test_nesting_and_parents_on_two_threads():
    rec = SpanRecorder()
    rec.on = True
    ready = threading.Barrier(2, timeout=10)

    def work(tag):
        with rec.span(tag + ".outer", run=7, batch=len(tag)):
            ready.wait()
            with rec.span(tag + ".inner", round=2, count=5):
                ready.wait()

    threads = [threading.Thread(target=work, args=(t,), name=t)
               for t in ("a", "bb")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans = {s["name"]: s for s in rec.drain()["spans"]}
    assert set(spans) == {"a.outer", "a.inner", "bb.outer", "bb.inner"}
    for tag in ("a", "bb"):
        outer, inner = spans[tag + ".outer"], spans[tag + ".inner"]
        assert outer["parent"] is None
        assert inner["parent"] == outer["id"]
        assert outer["thread"] == inner["thread"] == tag
        assert outer["start"] <= inner["start"] <= inner["end"] <= outer["end"]
        # run and batch come from the parent, round from the site
        assert (inner["run"], inner["batch"], inner["round"]) == (
            7, len(tag), 2)
        assert (inner["count"], outer["count"]) == (5, None)
    assert len({s["id"] for s in spans.values()}) == 4


def test_clock_is_perf_counter():
    assert metrics.clock is time.perf_counter
    rec = SpanRecorder()
    rec.on = True
    before = time.perf_counter()
    with rec.span("x"):
        pass
    after = time.perf_counter()
    (s,) = rec.drain()["spans"]
    assert before <= s["start"] <= s["end"] <= after


def test_off_keeps_nothing_but_sums():
    rec = SpanRecorder()
    sums = {}
    with rec.span("x", sums, "x"):
        time.sleep(0.002)
    with rec.span("y"):
        pass
    rec.count("c")
    assert rec.where() == {}
    assert rec.drain() == {"spans": [], "counts": {}}
    assert sums["x"] >= 0.002
    m = EngineMetrics()
    with m.stage("replay"):
        time.sleep(0.002)
    assert not metrics.RECORDER.on
    assert metrics.drain()["spans"] == []
    assert m.stage_seconds["replay"] >= 0.002


def test_a_profiler_keeps_spans():
    """While a torch profiler traces the process the recorder keeps spans
    and counters, switched on or not; after it, nothing."""
    from torch.profiler import ProfilerActivity, profile

    rec = SpanRecorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("x", count=2):
            rec.count("c")
    with rec.span("y"):
        pass
    got = rec.drain()
    assert [(s["name"], s["count"]) for s in got["spans"]] == [("x", 2)]
    assert got["counts"] == {"c": 1}


def test_a_new_profile_forgets_the_last():
    """Under a profiler alone the recorder keeps one profile's spans: what
    an earlier profile left undrained goes when the next one starts."""
    from torch.profiler import ProfilerActivity, profile

    rec = SpanRecorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("first"):
            rec.count("c")
    with rec.span("between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("second"):
            pass
    got = rec.drain()
    assert [s["name"] for s in got["spans"]] == ["second"]
    assert got["counts"] == {}
    rec.on = True  # switched on, it forgets nothing
    with rec.span("kept"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("third"):
            pass
    assert [s["name"] for s in rec.drain()["spans"]] == ["kept", "third"]


def test_drain_empties():
    rec = SpanRecorder()
    rec.on = True
    sums = {}
    with rec.span("x", sums, "k", count=3):
        rec.count("c", 2)
    got = rec.drain()
    assert [s["name"] for s in got["spans"]] == ["x"]
    assert got["counts"] == {"c": 2}
    assert sums["k"] == got["spans"][0]["end"] - got["spans"][0]["start"]
    assert rec.drain() == {"spans": [], "counts": {}}


def test_workflow_spans(tmp_path, tracing):
    """Every span of a traced run_binning_workflow on the CPU, each child
    on its parent's thread and inside it; the aligner's `device` seconds
    are its spans' sum.  The aligner's caps are lowered so that the
    sample also reaches the host C++ route."""
    from taxtk_torch.engine.aligner import BatchAligner
    from taxtk_torch.ops.seqpool import reset_shared_pools
    from taxtk_torch.pipeline.workflows import run_binning_workflow

    files = dna_sample(tmp_path / "data", 3, SEED, 1000, 2500)
    reset_shared_pools()
    aligner = BatchAligner("dna", device="cpu")
    aligner.long_pattern_threshold = aligner.tpu_long_pattern_cap = 1200
    run_binning_workflow(files["refpack"], files["query"],
                         str(tmp_path / "out"),
                         alignments_file=files["alignments"], macro_batch=2,
                         aligner=aligner, device="cpu")
    spans = tracing.drain()["spans"]
    assert {s["name"] for s in spans} == SPANS
    assert aligner.host_long_pairs
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start"] <= s["end"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["thread"] == s["thread"]
            assert p["start"] <= s["start"] and s["end"] <= p["end"]
    (eng,) = [s for s in spans if s["name"] == "pipeline.engine"]
    for s in spans:
        if s["name"].startswith(("engine.", "aligner.", "entry.", "pool.")):
            assert s["run"] is not None
            assert eng["start"] <= s["start"] and s["end"] <= eng["end"]
    # two macro-batches of three rounds, each round's spans named
    rounds = {(s["batch"], s["round"]) for s in spans
              if s["name"] == "aligner.device"}
    assert {b for b, _ in rounds} == {0, 1}
    device = sum(s["end"] - s["start"] for s in spans
                 if s["name"] == "aligner.device")
    assert device == pytest.approx(aligner.stage_seconds["device"], rel=0.01)
    # the entries' named steps, each a child of aligner.device, cover it
    steps = sum(s["end"] - s["start"] for s in spans
                if s["name"].startswith(("entry.", "pool.", "h2d"))
                and by_id[s["parent"]]["name"] == "aligner.device")
    assert steps >= 0.95 * device


def test_h2d_counts_copies_to_a_card_only(tracing, monkeypatch):
    """On the CPU h2d shares the array's memory and records nothing; to a
    card it is one h2d span with the bytes and one blocking copy (the
    copy itself stood in for here)."""
    import numpy as np
    import torch

    from taxtk_torch.ops import transfer

    a = np.arange(6, dtype=np.int32)
    t = transfer.h2d(a, "cpu")
    assert t.data_ptr() == a.ctypes.data
    assert tracing.drain() == {"spans": [], "counts": {}}
    monkeypatch.setattr(torch.Tensor, "to", lambda self, dev: self.clone())
    got = transfer.h2d(a, torch.device("cuda", 0))
    assert got.tolist() == a.tolist()
    kept = tracing.drain()
    assert [(s["name"], s["count"]) for s in kept["spans"]] == [("h2d", 24)]
    assert kept["counts"] == {transfer.BLOCKING: 1}


def test_taxator_profile_writes_spans(tmp_path, monkeypatch, capsys):
    """taxator --stats --profile DIR: spans.jsonl beside trace.json and the
    span totals on stderr (the host C++ backend, which the CPU profiler
    follows quickly)."""
    import io
    import json
    import sys

    from taxtk_torch.cli import taxator

    files = dna_sample(tmp_path / "data", 2, 11, 1000, 1500)
    ref = files["refpack"]
    with open(files["alignments"]) as fh:
        monkeypatch.setattr(sys, "stdin", io.StringIO(fh.read()))
    monkeypatch.setenv("TAXATORTK_TAXONOMY_NCBI",
                       os.path.join(ref, "ncbi-taxonomy"))
    prof = tmp_path / "prof"
    rc = taxator.main([
        "-a", "rpa", "-g", os.path.join(ref, "mapping.tax"),
        "-q", files["query"], "-f", os.path.join(ref, "refdata.fna"),
        "-i", os.path.join(ref, "refdata.fna.fai"),
        "--device", "cpu", "--dna-backend", "native", "--stats",
        "--profile", str(prof)])
    assert rc == 0
    assert (prof / "trace.json").exists()
    with open(prof / "spans.jsonl") as fh:
        names = {json.loads(line)["name"] for line in fh}
    assert {"engine.replay", "aligner.route", "aligner.host_long"} <= names
    err = capsys.readouterr().err
    assert "taxtk spans: " in err and "aligner.host_long=" in err
    assert not metrics.RECORDER.on

"""Port of taxtk/engine/metrics.py: run metrics, the span recorder and
optional torch.profiler traces.


Replaces the reference's StopWatchCPUTime/STATS plumbing
(reference: core/src/profiling.hh, taxonpredictionmodelsequence.hh:837) at
batch granularity: per-round pair/cell counters, wall times per stage, and
a one-line summary suitable for stderr.  `profile()` wraps a region in a
torch.profiler trace (CPU and, when present, CUDA activity) and writes it
as a Chrome trace.

Every stopwatch of the port is a `span` of one recorder, on `clock`
(time.perf_counter, the host clock a profiler's device timeline is mapped
onto).  A span site names its span and may add its seconds to a
per-object sum (EngineMetrics.stage_seconds, BatchAligner.stage_seconds),
which it does whether or not the recorder keeps spans.  It keeps them
while it is switched on (`start_tracing()`) or a torch profiler traces the
process, so that a profiled run carries the program's spans beside its
device timeline; otherwise it keeps nothing.  Under a profiler alone it
keeps one profile's spans: a profiler that starts forgets what an earlier
profile left undrained.  Each kept span has its name, start, end, its own
id, its parent's (the span open on the same thread when it opened), its
thread, and the run (one RpaEngine.run call), macro-batch and align round
it belongs to, which it takes from its parent unless the site names them,
and at most one count (pairs for an entry span, bytes for a copy).  `count` keeps counters the same way.  `drain()`
hands the kept spans and counters over and empties the recorder.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from torch.autograd import profiler as _profiler

clock = time.perf_counter

_CONTEXT = ("run", "batch", "round")


def _profiled() -> bool:
    """Whether a torch profiler traces the process: torch's own fast
    check, a flag private to torch.autograd.profiler (False where torch
    has none; taxbench/spans.py fails a traced run then)."""
    return getattr(_profiler, "_is_profiler_enabled", False)


class SpanRecorder:
    """Spans and counters of the program, kept while `on` or profiled."""

    def __init__(self):
        self.on = False
        self._profiled = False  # what the last site saw of a profiler
        self._lock = threading.Lock()
        self._spans: List[dict] = []
        self._counts: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._runs = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keeping(self) -> bool:
        """Whether sites keep spans now.  A profiler that starts while
        the recorder is off starts a new profile: the spans and counters
        an earlier profile left undrained go."""
        if self.on:
            return True
        profiled = _profiled()
        if profiled != self._profiled:
            with self._lock:
                if profiled and not self._profiled:
                    self._spans, self._counts = [], {}
                self._profiled = profiled
        return profiled

    def new_run(self) -> int:
        """The id of a new run (one RpaEngine.run call)."""
        return next(self._runs)

    def where(self) -> dict:
        """The run, macro-batch and round of the innermost span open on
        this thread (empty when none is, or nothing is kept): what a span
        opened on another thread on its behalf names."""
        stack = self._stack()
        return dict(stack[-1][1]) if stack else {}

    @contextlib.contextmanager
    def span(self, name: str, sums: Optional[dict] = None,
             key: Optional[str] = None, count: Optional[int] = None,
             **where):
        """Time the block as span `name`; add its seconds to sums[key]
        where sums is given.  where: run=, batch=, round= (those left out
        come from the parent span)."""
        if not self._keeping():
            if sums is None:
                yield
                return
            t = clock()
            try:
                yield
            finally:
                sums[key] = sums.get(key, 0.0) + (clock() - t)
            return
        stack = self._stack()
        parent = stack[-1] if stack else (None, {})
        ctx = {k: where.get(k, parent[1].get(k)) for k in _CONTEXT}
        sid = next(self._ids)
        stack.append((sid, ctx))
        t = clock()
        try:
            yield
        finally:
            end = clock()
            stack.pop()
            if sums is not None:
                sums[key] = sums.get(key, 0.0) + (end - t)
            rec = dict(name=name, start=t, end=end, id=sid, parent=parent[0],
                       thread=threading.current_thread().name, count=count,
                       **ctx)
            with self._lock:
                self._spans.append(rec)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to counter `name` (while spans are kept)."""
        if self._keeping():
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + n

    def drain(self) -> dict:
        """{"spans": [...], "counts": {...}} kept so far, which the
        recorder then forgets."""
        with self._lock:
            out = {"spans": self._spans, "counts": self._counts}
            self._spans, self._counts = [], {}
        return out


RECORDER = SpanRecorder()
span = RECORDER.span
count = RECORDER.count
where = RECORDER.where
new_run = RECORDER.new_run
drain = RECORDER.drain


def start_tracing() -> None:
    """Keep every span and counter from now on (drain() hands them over)."""
    RECORDER.on = True


def stop_tracing() -> None:
    RECORDER.on = False


def format_totals(spans: Iterable[dict], counts: Dict[str, int]) -> str:
    """Each span name's seconds and number of spans, and the counters, as
    one stderr line."""
    totals: Dict[str, List[float]] = {}
    for s in spans:
        t = totals.setdefault(s["name"], [0.0, 0])
        t[0] += s["end"] - s["start"]
        t[1] += 1
    return "taxtk spans: " + " ".join(
        [f"{k}={s:.2f}s/{n}" for k, (s, n) in sorted(totals.items())]
        + [f"{k}={v}" for k, v in sorted(counts.items())])


def write_spans(path: str, spans: Iterable[dict]) -> None:
    """The spans, one JSON object a line."""
    with open(path, "w") as fh:
        for s in spans:
            fh.write(json.dumps(s) + "\n")


@dataclass
class EngineMetrics:
    record_sets: int = 0
    pairs: int = 0
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=clock)
    # the run, and the macro-batch and round, that stage spans name
    run: Optional[int] = None
    context: Dict[str, int] = field(default_factory=dict)

    def stage(self, name: str):
        """Span engine.<name>, summed into stage_seconds[name]."""
        return span("engine." + name, self.stage_seconds, name, run=self.run,
                    **self.context)

    def span(self, name: str, **where):
        """Span engine.<name>, not summed."""
        return span("engine." + name, run=self.run, **where)

    def summary(self) -> str:
        total = clock() - self._t0
        stages = " ".join(
            f"{k}={v:.2f}s" for k, v in sorted(self.stage_seconds.items())
        )
        return (
            f"taxtk: {self.record_sets} record sets, {self.pairs} realignments "
            f"in {total:.2f}s ({stages})"
        )

    def report(self, stream=sys.stderr):
        print(self.summary(), file=stream)


@contextlib.contextmanager
def profile(trace_dir: Optional[str]):
    """torch.profiler trace around a region, written to
    trace_dir/trace.json (no-op when trace_dir is None)."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

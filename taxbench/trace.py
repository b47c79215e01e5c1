"""The traced run's device timeline, read from torch.profiler's trace.

The profiler records CUDA activity only (kernels, copies, memsets), so that
it costs the host little; the harness keeps its own host spans with
time.perf_counter.  One spin kernel launched just before the window ties
the two clocks together: the profiler's time of its end is the host's time
of the synchronize that followed it.
"""

from __future__ import annotations

import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK_CYCLES = 200_000


class DeviceTrace:
    """Context manager around the window: profiles CUDA activity and, on
    exit, parses the exported trace into device intervals on the host's
    perf_counter clock."""

    def __init__(self, workdir):
        self.path = os.path.join(workdir, "trace.json")
        self.events = []  # (name, start_s, end_s), host clock, by start

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        self._mark_host = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        self._prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            trace = json.load(f)
        os.unlink(self.path)
        raw = [e for e in trace.get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        marks = [e for e in raw if "sleep" in e["name"].lower()
                 or "spin" in e["name"].lower()]
        if not marks:
            raise RuntimeError("the profiler's trace has no clock mark")
        mark = min(marks, key=lambda e: e["ts"])
        base = (mark["ts"] + mark["dur"]) / 1e6
        self.events = sorted(
            ((e["name"], self._mark_host + e["ts"] / 1e6 - base,
              self._mark_host + (e["ts"] + e["dur"]) / 1e6 - base)
             for e in raw if e is not mark), key=lambda x: x[1])
        return False

    def window(self, t0, t1):
        """Device intervals clipped to [t0, t1]."""
        return [(n, max(a, t0), min(b, t1)) for n, a, b in self.events
                if b > t0 and a < t1]

    @staticmethod
    def busy_s(intervals):
        """Seconds covered by at least one interval."""
        busy, end = 0.0, None
        for _, a, b in sorted(intervals, key=lambda x: x[1]):
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy

    @staticmethod
    def gaps(intervals, t0, t1):
        """(start, end) of each stretch of [t0, t1] with nothing on the
        device."""
        out, cur = [], t0
        for _, a, b in sorted(intervals, key=lambda x: x[1]):
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if t1 > cur:
            out.append((cur, t1))
        return out


def short_name(name):
    """A kernel's name without its argument list and template noise."""
    base = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return base.split("(")[0].strip()[:120]

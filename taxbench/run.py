"""The benchmark of taxtk_torch: one run of one cell.

    python3 taxbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and taxtk_torch.
The cell names a configuration (taxbench/configs/<name>.json) and a
traffic mix (taxbench/traffic/<name>.json).

Set-up makes the refpack and one sample from the seed (the mix's
generator, taxbench/generators/), starts CUDA, loads the configuration's
kernels (built into taxtk_torch/build/ on a checkout's first run) and runs
the sample once cold.  The window then runs the sample again and again,
back to back, each time as a fresh `taxtk-binning --alignments` process
would see it (a fresh aligner and device pool, no query index), through
taxtk_torch.pipeline.workflows.run_binning_workflow, until --seconds have
passed; the last sample that started finishes inside it.  Once the window
has closed, the plain reference (taxbench/reference.py) works out the
value of every pair RPA asks for, the GFF3 lines and the bins of contigs
drawn from the seed, and every window sample's are compared with them.

Every metric is read by taxbench/metrics/<name>.py; with --trace 1 the
window also runs under torch.profiler (CUDA activity only), with the
program's span recorder switched on, and each `<kernel>_roofline`
metric's kernel is described by taxbench/rooflines/<kernel>.py.  The last line of standard output is one
JSON object; the compared numbers and their limits also end standard
error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from collections import Counter  # noqa: E402
from unittest import mock  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "taxtk")
CACHE = os.path.join(ROOT, ".taxbench-cache")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name):
    """(cell, configuration, traffic, metrics) of a cell of BENCHMARK.json;
    metrics: the end-to-end and per-layer entries that the cell reports.
    A name `<config>/<traffic>` pairs a configuration and a mix that no
    cell pairs, on one card, with only the metrics every cell reports."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name in cells:
        cell = cells[name]
    elif "/" in name:
        config_name, traffic_name = name.split("/", 1)
        cell = {"name": name, "config": config_name,
                "traffic": traffic_name, "chips": 1}
    else:
        raise SystemExit(f"unknown workload {name!r}; one of "
                         f"{', '.join(cells)}, or <config>/<traffic>")
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")

    def mine(entries):
        return [m for m in entries if name in m.get("workloads", [name])]

    return cell, config, traffic, (mine(bench["end_to_end"]),
                                   mine(bench["per_layer"]))


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sample_contigs(alignments, traffic, seed):
    """The contigs the reference checks, drawn from the seed.  The mix's
    `check` gives length `classes`, [shortest, longest] of a record set's
    query range (the aligner routes a pair by its shorter side, which is
    about that length), and the `pairs` each class needs.  A set of n > 1
    records asks for about 3n - 2 pairs (n against the query, n - 1 for
    each of about two anchors); a set of one asks none.  Contigs come in
    an order shuffled by the seed, and each is taken while it brings
    pairs to a class that has fewer than it needs."""
    from collections import namedtuple

    import numpy as np

    from taxbench.reference import record_sets

    Rec = namedtuple("Rec", "qs qe order")
    runs = {}
    with open(alignments) as fh:
        for order, line in enumerate(fh):
            if line.strip():
                f = line.split("\t", 3)
                runs.setdefault(f[0], []).append(
                    Rec(int(f[1]), int(f[2]), order))
    classes = traffic["check"]["classes"]
    need = traffic["check"]["pairs"]
    have = [0] * len(classes)
    qids = list(runs)
    rng = np.random.RandomState((seed * 7919 + 17) % (1 << 32))
    taken = []
    for i in rng.permutation(len(qids)):
        adds = [0] * len(classes)
        for rs in record_sets(runs[qids[i]]):
            span = max(r.qe for r in rs) - min(r.qs for r in rs) + 1
            for c, (lo, hi) in enumerate(classes):
                if lo <= span <= hi and len(rs) > 1:
                    adds[c] += 3 * len(rs) - 2
        if any(a and h < need for a, h in zip(adds, have)):
            taken.append(qids[i])
            have = [h + a for h, a in zip(have, adds)]
        if min(have) >= need:
            break
    return sorted(taken, key=qids.index)


class Spans:
    """The harness's host spans of the window (name, start, end) and the
    seconds of the workflow's stages by name, timed from outside the
    program: RpaEngine.run, the binner and the summaries (a copy of
    bench_torch.stage_seconds)."""

    def __init__(self):
        self.spans = []
        self.seconds = {}

    @contextlib.contextmanager
    def active(self):
        from taxtk_torch.engine.executor import RpaEngine
        from taxtk_torch.pipeline import workflows

        def timed(name, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    end = time.perf_counter()
                    self.seconds[name] = self.seconds.get(name, 0.0) + end - t
                    self.spans.append((name, t, end))
            return run

        with mock.patch.object(RpaEngine, "run",
                               timed("engine", RpaEngine.run)), \
                mock.patch.object(workflows, "run_binner",
                                  timed("binner", workflows.run_binner)), \
                mock.patch.object(workflows, "binning_to_summary",
                                  timed("summaries",
                                        workflows.binning_to_summary)):
            yield self


ROUND_ARGS = ("tasks", "pair_caches", "reqs_per_task")


@contextlib.contextmanager
def around_align_round(before=None, after=None):
    """Patches RpaEngine._align_round so that before(args) runs ahead of
    each round and after(args) once it has filled its pair caches.  args
    maps the round's parameters, bound by name through the real method's
    signature, to what the call passed (the same objects: a hook may fill
    `pair_caches` in place); the call itself goes on unchanged, so a
    parameter that the method adds or moves passes through."""
    from taxtk_torch.engine.executor import RpaEngine

    real = RpaEngine._align_round
    sig = inspect.signature(real)
    missing = [n for n in ROUND_ARGS if n not in sig.parameters]
    if missing:
        raise RuntimeError("RpaEngine._align_round has no parameter "
                           + ", ".join(missing))

    @functools.wraps(real)
    def align_round(*a, **kw):
        args = sig.bind(*a, **kw).arguments
        if before is not None:
            before(args)
        result = yield from real(*a, **kw)
        if after is not None:
            after(args)
        return result

    with mock.patch.object(RpaEngine, "_align_round", align_round):
        yield


class Capture:
    """Keeps, for the checked contigs, each RPA task, its pair cache and
    every key its replay asked for, around RpaEngine._align_round;
    references only, read once the window has closed.  The replay reads
    only keys it asked for; a key is asked for in the order RPA aligns it,
    and the engine may serve it from the other order's value (its mirror
    fill), so the cache's value of every asked key is what RPA read."""

    def __init__(self, contigs):
        self.contigs = set(contigs)
        self.tasks = []  # (task, its pair cache, the keys it asked for)
        self.seen = {}  # id -> a macro-batch's pair caches, kept alive

    def _round(self, args):
        tasks, pair_caches = args["tasks"], args["pair_caches"]
        mine = self.seen.get(id(pair_caches))
        if mine is None:
            mine = [(ti, (task, pair_caches[ti], set()))
                    for ti, task in enumerate(tasks)
                    if task.qid in self.contigs]
            self.seen[id(pair_caches)] = (pair_caches, mine)
            self.tasks.extend(entry for _, entry in mine)
        else:
            mine = mine[1]
        for ti, (_, _, keys) in mine:
            keys.update(args["reqs_per_task"][ti])

    def active(self):
        return around_align_round(before=self._round)

    def take(self):
        out, self.tasks, self.seen = self.tasks, [], {}
        return out


class ProgramSpans:
    """The program's own spans and counters of a traced window: its
    recorder (taxtk_torch/engine/metrics.py) switched on as the window
    opens and off as it closes, and what it kept then, drained."""

    def __init__(self):
        self.kept = None

    @contextlib.contextmanager
    def active(self):
        from taxtk_torch.engine import metrics

        metrics.drain()  # nothing from before the window
        metrics.start_tracing()
        try:
            yield self
        finally:
            metrics.stop_tracing()
            self.kept = metrics.drain()


class Recorder:
    """Each call of a roofline's entry in the window (rooflines/<kernel>.py:
    MODULE.ENTRY, one launch a call), as its `record` reads it."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.spec = load_file(os.path.join(HERE, "rooflines", kernel + ".py"),
                              "taxbench_roofline_" + kernel)
        self.calls = []

    @contextlib.contextmanager
    def active(self):
        module = importlib.import_module(self.spec.MODULE)
        real = getattr(module, self.spec.ENTRY)

        def entry(*a, **kw):
            self.calls.append(self.spec.record(*a, **kw))
            return real(*a, **kw)

        with mock.patch.object(module, self.spec.ENTRY, entry):
            yield self


def reference_key(task, key):
    """The reference's key of an engine's pair key of a task."""
    def rec(r):
        return (r.reference_identifier, r.reference_start, r.reference_stop,
                r.query_start, r.query_stop)

    kind, i, j = key
    return (task.qid, task.qrstart, task.qrstop, rec(task.records[i]),
            None if kind == "q" else rec(task.records[j]))


def task_pairs(task, cache, asked):
    """The values of the pairs a task asked for, keyed as the reference
    keys its pairs."""
    out = {}
    for key in asked:
        val = cache.get(key)
        out[reference_key(task, key)] = (
            None if val is None else (val.distance, val.similarity))
    return out


def compare(want, got):
    """Counts by which `got` (a window sample's GFF3 lines, bins and the
    values of the pairs RPA asked for, of the checked contigs) departs
    from the reference's `want`."""
    import numpy as np

    lines = 0
    for qid, ref_lines in want["gff3"].items():
        have = Counter(got["gff3"].get(qid, []))
        need = Counter(ref_lines)
        lines += max(sum((need - have).values()), sum((have - need).values()))
    bins = sum(got["bins"].get(name) != line
               for name, line in want["bins"].items())
    pairs = 0
    for k, v in got["pairs"].items():
        w = want["pairs"].get(k)
        if (v is None or w is None
                or np.float32(v[0]).tobytes() != np.float32(w[0]).tobytes()
                or np.float32(v[1]).tobytes() != np.float32(w[1]).tobytes()):
            pairs += 1
    return {"gff3_lines_differing": lines, "bins_differing": bins,
            "pairs_differing": pairs, "pairs_compared": len(got["pairs"])}


def read_outputs(paths, contigs, glob):
    """The GFF3 lines and bin lines of the checked contigs, and the line
    counts of both files."""
    import re

    want = set(contigs)
    names = {re.match(glob, q).group(1) for q in contigs}
    gff3, bins, n_gff3, n_bins = {}, {}, 0, 0
    with open(paths["gff3"]) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            n_gff3 += 1
            qid = line.split("\t", 1)[0]
            if qid in want:
                gff3.setdefault(qid, []).append(line.rstrip("\n"))
    with open(paths["binning"]) as fh:
        for line in fh:
            if not line.strip() or line.startswith(("#", "@")):
                continue
            n_bins += 1
            name = line.split("\t", 1)[0]
            if name in names:
                bins[name] = line.rstrip("\n")
    return dict(gff3=gff3, bins=bins, n_gff3=n_gff3, n_bins=n_bins)


def run_sample(files, config, device, outdir, contigs):
    """One sample through taxtk-binning --alignments, as a fresh process
    sees it: a fresh device pool and aligner, and no query index."""
    import torch
    from taxtk_torch.engine.aligner import BatchAligner
    from taxtk_torch.ops.seqpool import reset_shared_pools
    from taxtk_torch.pipeline.workflows import run_binning_workflow

    reset_shared_pools()
    aligner = BatchAligner("protein" if config["protein"] else "dna",
                           device=device)
    backend = (aligner.protein_backend if config["protein"]
               else aligner.dna_backend)
    if torch.device(device).type == "cuda" and backend != config["aligner"]:
        raise RuntimeError(f"the default aligner on the card is {backend}; "
                           f"the configuration states {config['aligner']}")
    fai = files["query"] + ".fai"
    if os.path.exists(fai):
        os.unlink(fai)
    t = time.perf_counter()
    paths = run_binning_workflow(
        files["refpack"], files["query"], outdir,
        alignments_file=files["alignments"], protein=config["protein"],
        speedup=config["exclude_factor"], macro_batch=config["macro_batch"],
        glob_regex=config["binner_glob"], aligner=aligner, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    out = read_outputs(paths, contigs, config["binner_glob"])
    stats = aligner.stats()
    out.update(wall_s=wall, aligner=stats["stage_seconds"],
               host_long_pairs=stats["host_long_pairs"],
               pool=stats.get("pool", dict(bytes_shipped=0)))
    shutil.rmtree(outdir, ignore_errors=True)
    return out


def card_info(device):
    """The card's name, SM count, maximum SM clock and power limit."""
    import torch

    props = torch.cuda.get_device_properties(device)
    info = dict(kind=torch.cuda.get_device_name(device),
                sms=props.multi_processor_count)
    try:
        q = subprocess.run(
            ["nvidia-smi", "-i", str(torch.device(device).index or 0),
             "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        mhz, watts = (float(x) for x in q.stdout.split(","))
    except (OSError, subprocess.SubprocessError, ValueError):
        # the H100 SXM's maximum SM clock where nvidia-smi cannot say
        mhz, watts = getattr(props, "clock_rate", 1_980_000) / 1e3, float("nan")
    info.update(max_sm_mhz=mhz, power_limit_w=watts,
                int_rate=info["sms"] * 128 * mhz * 1e6)
    return info


def run_cell(name, seed, seconds, trace, device="cuda", traffic=None,
             fault=None):
    """One run of a cell; returns the result object.  device="cpu" and
    `traffic` (a smaller mix) serve the CPU tests; `fault(files=,
    contigs=, config=, device=)` gives a context manager planted around
    the window: a fault of the tests, or the control (control.py)."""
    cell, config, mix, (e2e, per_layer) = cell_spec(name)
    mix = traffic or mix
    import torch

    from taxbench import workload
    from taxbench.reference import Reference, record_sets

    on_card = torch.device(device).type == "cuda"
    parts = {"import_s": time.perf_counter() - T_START}
    workdir = tempfile.mkdtemp(prefix="taxbench-")
    try:
        t = time.perf_counter()
        files = workload.make(mix, os.path.join(workdir, "data"), seed)
        contigs = sample_contigs(files["alignments"], mix, seed)
        parts["workload_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if on_card:
            torch.cuda.init()
            torch.zeros(1, device=device)
            torch.cuda.synchronize()
        parts["context_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for name in config["host_libs"]:  # the host C++ (g++ on first use)
            importlib.import_module(name).load()
        if on_card:
            from taxtk_torch.ops import cuda_build

            cuda_build.build(config["kernels"])
            for k in config["kernels"]:
                cuda_build.load(k)
        parts["kernels_s"] = time.perf_counter() - t
        # objects made so far live for the whole run: the collector leaves
        # them alone, as it would in a fresh process with less to scan
        gc.collect()
        gc.freeze()
        t = time.perf_counter()
        cold = run_sample(files, config, device,
                          os.path.join(workdir, "cold"), contigs)
        parts["cold_sample_s"] = time.perf_counter() - t
        parts["cold_sample_wall_s"] = cold["wall_s"]
        log("taxbench setup: " + json.dumps(parts))

        capture, spans = Capture(contigs), Spans()
        recorders = [Recorder(m["name"][: -len("_roofline")])
                     for m in per_layer if m["name"].endswith("_roofline")]
        samples, attempted, failed = [], 0, 0
        gc.collect()
        gc.freeze()
        peak_setup = 0
        if on_card:
            torch.cuda.synchronize()
            peak_setup = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            if trace and on_card:
                from taxbench.trace import DeviceTrace

                dtrace = stack.enter_context(DeviceTrace(workdir))
            else:
                dtrace = None
            stack.enter_context(capture.active())
            stack.enter_context(spans.active())
            if trace:
                for r in recorders:
                    stack.enter_context(r.active())
            if fault is not None:
                stack.enter_context(fault(files=files, contigs=contigs,
                                          config=config, device=device))
            program = ProgramSpans()
            if trace:
                stack.enter_context(program.active())
            t_open = time.perf_counter()
            setup_s = t_open - T_START
            while True:
                attempted += 1
                t0 = time.perf_counter()
                before = dict(spans.seconds)
                try:
                    rec = run_sample(files, config, device,
                                     os.path.join(workdir, "s%d" % attempted),
                                     contigs)
                except Exception:
                    failed += 1
                    log("taxbench: sample %d failed:\n%s"
                        % (attempted, traceback.format_exc()))
                else:
                    rec["stages"] = {k: v - before.get(k, 0.0)
                                     for k, v in spans.seconds.items()}
                    rec["size"] = files["query_size"]
                    rec["tasks"] = capture.take()
                    samples.append(rec)
                    log("taxbench sample %d: %s" % (attempted, json.dumps(
                        dict(wall_s=rec["wall_s"], stages=rec["stages"],
                             aligner=rec["aligner"],
                             host_long_pairs=rec["host_long_pairs"]))))
                spans.spans.append(("sample", t0, time.perf_counter()))
                # what the sample left alive, the records kept for the
                # check above all, leaves the collector's view as set-up's
                # objects did: a full collection in a later sample would
                # scan it all again, which no fresh process pays
                gc.freeze()
                if time.perf_counter() - t_open >= seconds:
                    break
            t_close = time.perf_counter()
        window_s = t_close - t_open
        peak_window = None
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": "cpu", "count": cell["chips"],
                       "memory_peak_bytes": 0}
        card = {"int_rate": None}
        if on_card:
            peak_window = torch.cuda.max_memory_allocated(device)
            peak_total = max(peak_window, peak_setup)
            card = card_info(device)
            device_info.update(kind=card["kind"],
                               memory_peak_bytes=int(peak_total))
            log("taxbench card: " + json.dumps(card))
        found = forbidden_modules()
        if found:
            raise RuntimeError("loaded modules the benchmark may not load: "
                               + ", ".join(found))

        ctx = {"samples": samples, "window_s": window_s, "setup_s": setup_s,
               "parts": parts, "cold_sample_s": parts["cold_sample_s"],
               "peak_window_bytes": peak_window, "card": card,
               "trace": None, "rooflines": {}, "program": program.kept}
        breakdown = None
        if dtrace is not None:
            ivals = dtrace.window(t_open, t_close)
            busy = dtrace.busy_s(ivals)
            ctx["trace"] = {"intervals": ivals, "busy_s": busy,
                            "window_s": window_s}
            device_info.update(busy_s=busy, window_s=window_s)
            breakdown = make_breakdown(
                ivals, spans.spans, t_open, t_close,
                program.kept["spans"],
                threading.current_thread().name)
        for r in recorders:
            ctx["rooflines"][r.kernel] = {"calls": r.calls,
                                          "kernel": r.spec.KERNEL,
                                          "bound_s": r.spec.bound_s}
        metrics = {}
        for m in (per_layer if trace else e2e):
            reader = load_file(os.path.join(HERE, "metrics",
                                            m["name"] + ".py"),
                               "taxbench_metric_" + m["name"])
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}

        # the program's state goes before the reference runs
        cold = None
        from taxtk_torch.ops.seqpool import reset_shared_pools

        reset_shared_pools()
        gc.unfreeze()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = Reference(files, config["protein"], device=device,
                        exclude_factor=config["exclude_factor"],
                        toppercent=config["toppercent"],
                        min_support=config["binner_min_support"],
                        majority=config["binner_majority"])
        want = ref.check(contigs)
        n_sets = sum(len(record_sets(rs)) for rs in ref.runs.values())
        n_names = len({ref.glob.match(q).group(1) for q in ref.runs})
        totals = Counter()
        for rec in samples:
            got = {"gff3": rec["gff3"], "bins": rec["bins"], "pairs": {}}
            for task, cache, asked in rec.pop("tasks"):
                got["pairs"].update(task_pairs(task, cache, asked))
            totals.update(compare(want, got))
            totals["lines_missing"] += (abs(rec["n_gff3"] - n_sets)
                                        + abs(rec["n_bins"] - n_names))
        ref_s = time.perf_counter() - t
        classes = mix["check"]["classes"]
        per_class = Counter(
            next((f"{lo}-{hi}" for lo, hi in classes
                  if lo <= k[2] - k[1] + 1 <= hi), "other")
            for k in got["pairs"]) if samples else {}
        checks = {
            "samples_failed": [failed, 0],
            "samples_checked": [len(samples), 1],
            "lines_missing": [totals["lines_missing"], 0],
            "gff3_lines_differing": [totals["gff3_lines_differing"], 0],
            "bins_differing": [totals["bins_differing"], 0],
            "pairs_differing": [totals["pairs_differing"], 0],
            "pairs_compared": [totals["pairs_compared"], 1],
        }
        # the first two of each [value, limit] floors; the rest ceilings
        correct = all((v >= lim) if k in ("samples_checked", "pairs_compared")
                      else (v <= lim) for k, (v, lim) in checks.items())
        log("taxbench reference: %.3f s for %d contigs, %d samples compared;"
            " pairs a sample by set length: %s"
            % (ref_s, len(contigs), len(samples), json.dumps(per_class)))
        result = {"correct": bool(correct), "attempted": attempted,
                  "failed": failed, "metrics": metrics,
                  "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def make_breakdown(intervals, spans, t0, t1, program=(), thread=None):
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost span the program kept on `thread`
    (the one that runs the workflow and the engine) at the gap's middle,
    or where it kept none there, by the innermost harness span."""
    from taxbench.trace import DeviceTrace, short_name

    by_op = Counter()
    for n, a, b in intervals:
        by_op[short_name(n)] += b - a
    gaps = DeviceTrace.gaps(intervals, t0, t1)
    mine = [(s["name"], s["start"], s["end"]) for s in program
            if s["thread"] == thread]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        inner = ([s for s in mine if s[1] <= mid <= s[2]]
                 or [s for s in spans if s[1] <= mid <= s[2]])
        label = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                 else "harness")
        named.append([label, b - a])
    return {"device_ops": [[n, s] for n, s in by_op.most_common(10)],
            "idle_gaps": named}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.makedirs(CACHE, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    cell = cell_spec(args.workload)[0]
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        log(f"taxbench: {args.workload} needs {cell['chips']} CUDA "
            f"device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        log("taxbench: loaded modules the benchmark may not load: "
            + ", ".join(found))
        return 3
    for k, c in result["checks"].items():
        rel = ">=" if k in ("samples_checked", "pairs_compared") else "<="
        log(f"{k} {c['value']} {rel} {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

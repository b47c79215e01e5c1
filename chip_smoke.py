#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (taxtk_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  env      CUDA version, card name and power limit;
  build    nvcc builds the six kernels from taxtk_torch/csrc for sm_90a
           (the short, systolic and chunked Myers kernels, the min-plus DNA
           wavefront, both protein kernels), one process each; registers
           and spills per template instance;
  kernels  each Myers kernel against its plain PyTorch version on the card
           and against the port's host C++ Myers, at main-path shapes, on
           the one-off pool and on the shared pool cache, with CUDA-event
           times (the short kernel also at each W its K admits, forced,
           on both layouts; the systolic kernel's plain version on the
           pool cache only, the one-off layout held against the
           pool-cache output, and the kernel also at each KW its shape
           admits, forced; the
           chunked kernel against its plain version at two shapes); the
           DNA wavefront kernel against the host C++
           Myers and its plain version at the aligner's former bucket
           shapes, timed at each R (rows per lane) and, for the single
           long pair, at each band width nw;
  engine   the taxator CLI (nucleotide RPA) on a 300-contig workload of
           1-20 kbp contigs, with the default myers-cuda backend, with
           --dna-backend native, with --dna-backend wavefront-cuda, and with
           myers-cuda and the aligner's systolic_max_pairs = 0 (the
           oversized-round route through the chunked kernel); every GFF3
           must be byte-identical to native's and each kernel of each path
           must have launched; the myers-cuda run times each short and
           each systolic launch with CUDA events, prints each short launch
           (rows, real pairs, N, K, bits, G/W, own word-chars, bound, ms)
           and their sum, and keeps every short launch and its first
           1024-pair systolic launch; the oversized run times each
           chunked launch behind a spin, prints each (entry call, pattern
           block, pairs, texts' longest and summed lengths, bits, own
           word-chars, bound, ms) and their sum, and keeps the host inputs
           of every entry call; the wavefront-cuda run times each DNA
           wavefront launch and keeps its largest;
  kernels  the chunked kernel at its largest launch of the oversized run
           (the most own word-chars), its main shape, on both layouts,
           against the host C++ Myers and the plain version;
           the short kernel at its largest engine launch (the most own
           word-chars) on both layouts, and at every engine launch, each
           at each W, against its plain version and the host C++ Myers,
           with the launches' sums at each W; the systolic kernel and the
           DNA wavefront kernel at their captured launches, the engine's
           own shapes, against their plain versions and the host C++
           Myers, timed at each KW and each R;
  protein  both protein kernels (v5 protein_wavefront, v6 protein_swar)
           against their plain version, element for element, and their
           mutual scores against the host C++ NW, at main-path shapes on
           both pool layouts, with CUDA-event times (each also at each
           band width nw at 1024 x 512 and 256 x 1024, v5 at 64 x 2048);
  golden   every protein pair of both SeqAn golden corpora through both
           protein kernels (v6 where its 16-bit domain holds);
  protein engine
           taxator -b protein -l on the 2000-ORF protein workload with
           wavefront-cuda, with --protein-backend wavefront (the plain
           version) and with TAXTK_PROTEIN_SWAR=1: GFF3s and logs
           byte-identical, both protein kernels launched; the
           wavefront-cuda run times each v5 launch and the SWAR run each
           v6 launch with CUDA events, and each keeps its largest; then
           the GFF3 through the port's binner;
  protein  v5 and v6 each at its largest launch, the engine's own shape,
           against the plain version and the host C++ NW, timed at each
           nw;
  pipeline taxtk-binning (python -m taxtk_torch.cli.pipeline, in this
           process, on the card by default) with --alignments on the DNA
           engine's 300-contig workload and with --protein
           --no-orf-calling on the protein engine's 2000 ORFs, each laid
           out as a refpack; every output file byte-identical to
           run_binning_workflow's with the host C++ aligner (DNA) or the
           plain protein version, myers_short, myers_systolic and
           protein_wavefront launched; wall time, rate and the seconds of
           the engine, binner and summaries stages;
  mesh     the dp x tp mesh: taxator --mesh 1x1 on the DNA engine's
           workload (myers-cuda) and, with -l, on the protein engine's,
           GFF3 (and log) byte-identical to those phases' runs, with
           engine and merge-stage seconds and launches per row; a 2x2
           grid over cuda:0 named four times (tp = 2, taxator's own entry
           with its grid so made), the same GFF3, per-cell pool traffic
           and launches, and the pass-0 merge against the host's
           reductions on every live task of one macro-batch; dryrun_step
           on [cuda:0] * 2 at tp = 2 against its run with the plain
           wavefront on the card; RpaEngine with a bare dp mesh
           (BatchAligner("dna", dna_backend="myers", mesh=Mesh([[cuda:0]]
           * 2)), no engine backend), its GFF3 equal to the engine phase's,
           both rows running pairs and no kernel launched, with its engine
           seconds on a line of their own; two gloo processes (this script with
           --mesh-worker) classifying their host shards with myers-cuda,
           merge_gff3_parts of their parts equal to the single run's; and,
           only with more than one card, --mesh kx1 and 1xk over the
           cards;
  bench    bench_torch.py (the port's bench.py) in a subprocess: its one
           JSON line must hold every family's keys (the kernel GCUPS,
           e2e_*, e2e_config4_*, protein_kernel_*, protein_e2e_*, and the
           scale families' config5_* (BASELINE.json's config 5: 1M
           contigs through the binning pipeline) and config4_stream_*
           (config 4 at 10k contigs): the timed run's wall, Mbp/h, peak
           RSS and device memory, stage and aligner seconds, launches,
           Kernel 1's pairs per launch and pool traffic, and the gate's
           card and native walls at one count with Kernel 1's CUDA-event
           sum; each family with its protocol string) and no
           *_error field, and each scale family's timed and gate runs
           must have launched Kernel 1; the script itself holds each family's
           warm-up GFF3 (the scale families: every output file) against
           its reference run and each kernel family's results against the
           host C++.  The line is printed as it came, after "bench: ".
Then the kernels' JSON record, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}.  Any failure exits non-zero
without the ok line.  Nothing of JAX or of the taxtk package is imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

MEM_RATE = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
# clock cycles the card spins before each timed call's start event (0.5
# ms at 1,980 MHz): longer than any wrapper's host work before its launch
SPIN_CYCLES = 1_000_000
# essential instructions of the Myers recurrence per 32-cell word per char,
# after fusion: the word's match mask (one lookup or select), its MH
# carry-in OR, Xv, Eq & Pv, the add, Xh and Ph (one LOP3 each), Mh, the PH
# and MH shift-ins (one funnel shift or IMAD each, carry included), Pv
# (LOP3), Mv, and the MH carry-out shift (PH's folds into the next word's
# funnel shift)
OPS_PER_WORD_CHAR = 13
# essential INT32-pipe ops per protein DP cell after fusion: one add
# (diagonal + substitution), one add-max (max(left, up) + gap, Hopper's
# VIADDMAX), one max with the diagonal, three compares (diagonal wins,
# left >= up, match), two selects of the stats and one add of both stat
# increments (IADD3).  The table load issues on the load/store unit and
# is not counted.
OPS_PER_CELL = 9
# the same cell two to a 32-bit word, as 16-bit halves, where every score
# of the bucket fits one (v6's domain, _swar_fits): 13 instructions a word
# (csrc/protein_swar.cu's header: the diagonal's add, the DPX max and
# add-max, two masks of an IADD3 and a PRMT each, and each stat's add and
# two LOP3 selects; the match bit rides in the table entry)
SWAR_OPS_PER_CELL = 13 / 2
# essential INT32 ops per min-plus DNA cell: the compare a == b, the DPX
# three-way min of up, left and the diagonal (VIMNMX3), and the +1 on a
# mismatch, an add predicated on the compare that writes over the
# diagonal's register and so is also the select (on a match the cell is
# the diagonal)
DNA_OPS_PER_CELL = 3
KERNEL_SOURCES = ["myers_short", "myers_systolic", "myers_chunked",
                  "dna_wavefront", "protein_wavefront", "protein_swar"]
# H100 SXM: SMs x integer instructions per SM per clock.  Each of an SM's
# four sub-partitions issues one warp instruction a clock; its ALU pipe
# (logic, add, shift, compare: 16 lanes) and its FMA pipe (IMAD, which the
# compiler also uses for adds, moves and shifts by a constant: 16 lanes)
# together take 32 lanes of integer work a clock, the rate of the data
# sheet's 67 TFLOP/s float32 (an FMA being two flops)
INT32_LANES = 132 * 128
# template arguments of the kernels that have them (myers_short<K, W, BITS>,
# myers_chunked<BITS> at KB = 64, myers_systolic<BITS, KW> at KC = 32,
# dna_wavefront<R>)
TEMPLATE_ARGS = {"myers_short": ("K", "W", "bits"),
                 "myers_chunked": ("bits",),
                 "myers_systolic": ("bits", "KW"), "dna_wavefront": ("R",)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event-timed calls of fn, after one warm-up.
    Each start event waits on the card behind a spin of SPIN_CYCLES, so
    that the window opens when fn's launch is already queued and holds
    the kernel, not the host's work in its wrapper before the launch."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed(fn):
    """(fn(), its wall time in ms between two device synchronizations)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    value = fn()
    torch.cuda.synchronize()
    return value, (time.perf_counter() - t) * 1e3


def bound(m, n, bits, int_rate):
    """Least time (ms) for the Myers work of these pairs, and what bounds
    it: the essential ops (OPS_PER_WORD_CHAR per 32-cell word per char,
    over the pairs' own lengths) over the integer issue rate, against the
    bytes each input and output moves once (packed text, peq words, 4
    int32 of metadata and the int32 result per pair) over the memory
    rate."""
    m = np.asarray(m, np.int64)
    n = np.asarray(n, np.int64)
    words = -(-m // 32)
    ops_ms = OPS_PER_WORD_CHAR * float((n * words).sum()) / int_rate * 1e3
    nbytes = float((-(-n // (8 // bits))).sum() + (words * 5 * 4).sum()
                   + len(m) * 5 * 4)
    bytes_ms = nbytes / MEM_RATE * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def make_pairs(rng, B, m_range, n_range, alphabet=4, mutate=0.05):
    """B pairs (a, b): b random with a length in n_range, a a copy of b
    resized to a length in m_range with 5% of its codes redrawn (related
    sequences, as RPA realigns them)."""
    pairs = []
    for _ in range(B):
        n = int(rng.integers(n_range[0], n_range[1] + 1))
        m = int(rng.integers(m_range[0], m_range[1] + 1))
        b = rng.integers(0, alphabet, n).astype(np.uint8)
        a = np.resize(b, m) if n else rng.integers(0, alphabet, m).astype(
            np.uint8)
        mut = rng.random(m) < mutate
        a = a.copy()
        a[mut] = rng.integers(0, alphabet, int(mut.sum()))
        pairs.append((a, b))
    return pairs


def to_batch(pairs):
    B = len(pairs)
    M = max(1, max(len(a) for a, _ in pairs))
    N = max(1, max(len(b) for _, b in pairs))
    ac = np.zeros((B, M), np.uint8)
    bc = np.zeros((B, N), np.uint8)
    al = np.array([len(a) for a, _ in pairs], np.int32)
    bl = np.array([len(b) for _, b in pairs], np.int32)
    for i, (a, b) in enumerate(pairs):
        ac[i, : len(a)] = a
        bc[i, : len(b)] = b
    return ac, bc, al, bl


def phase_env():
    import torch

    name_power = smi("name,power.limit")
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | {name_power}", flush=True)
    return name_power


def phase_build():
    from taxtk_torch.ops import cuda_build

    from taxtk_torch import native
    from taxtk_torch.native import faidx, replay

    t0 = time.time()
    cuda_build.build(KERNEL_SOURCES)
    secs = time.time() - t0
    # the host C++ libraries (Myers, FASTA fetch, RPA replay) build with
    # g++ at first use too; build them here so no engine run pays for it
    t0 = time.time()
    if None in (native.load(), faidx.load(), replay.load()):
        fail("g++ could not build the host C++ libraries")
    host_secs = time.time() - t0
    regs = {}
    for name in KERNEL_SOURCES:
        # ptxas -v: "Compiling entry function '..._kernelILi64ELi2EE...'"
        # (TEMPLATE_ARGS names the template arguments), then the spill
        # line, then "Used N registers"
        key = None
        for ln in cuda_build.ptxas_report(name).splitlines():
            if "Compiling entry function" not in ln:
                if key and "spill stores" in ln:
                    regs[key]["spill_bytes"] = int(
                        re.search(r"(\d+) bytes spill stores", ln).group(1))
                elif key and "registers" in ln:
                    regs[key]["registers"] = int(
                        re.search(r"Used (\d+) registers", ln).group(1))
                continue
            t = re.search(r"kernelI((?:Li\d+E)+)E", ln)
            key = name
            if t:
                nums = re.findall(r"Li(\d+)E", t.group(1))
                names = TEMPLATE_ARGS[name]
                key = name + "<" + ",".join(
                    f"{k}={v}" for k, v in zip(names, nums)) + ">"
            regs[key] = {}
    print(f"build: {len(KERNEL_SOURCES)} kernels in {secs:.1f}s (sm_90a), "
          f"host C++ in "
          f"{host_secs:.1f}s; "
          f"registers {json.dumps(regs)}", flush=True)
    return regs


def _systolic_kw_ms(args, want, reps):
    """Kernel 2 on `args` at each KW its largest pair admits, the wrapper's
    kernel_geometry forced: each output held against `want` (the plain
    version's), and the CUDA-event median of each, so that every run shows
    whether the wrapper's choice of KW was the faster one."""
    import torch

    from taxtk_torch.ops import myers_systolic as ms

    nb = args[-2]
    out = {}
    for kw in (2, 3):
        warps = -(-nb // kw)
        if warps > ms.MAX_WARPS:
            continue
        with mock.patch.object(ms, "kernel_geometry",
                               lambda _nb, kw=kw, w=warps: (kw, w)):
            if not torch.equal(ms.myers_systolic(*args), want):
                fail(f"systolic kernel at KW={kw} != plain version")
            out[f"KW={kw}"] = cuda_ms(lambda: ms.myers_systolic(*args), reps)
    return out


def _short_w_ms(args, want, reps):
    """Kernel 1 on `args` at each W its K admits (myers_cuda.W_SET), the
    wrapper's kernel_geometry forced: each output held against `want` (the
    plain version's, every element), and the CUDA-event median of each,
    so that every run shows whether the wrapper's W was the faster."""
    import torch

    from taxtk_torch.ops import myers_cuda as mc

    real = mc.kernel_geometry
    out = {}
    for w in mc.W_SET[args[6]]:
        with mock.patch.object(mc, "kernel_geometry",
                               lambda K, _w=None, w=w: real(K, w)):
            got = mc.myers_short(*args)
            if not torch.equal(got, want):
                fail(f"short kernel at W={w} != plain version: "
                     f"{int((got != want).sum())} outputs differ")
            if reps:
                out[f"W={w}"] = cuda_ms(lambda: mc.myers_short(*args), reps)
    return out


def _check(kind, pairs, label, int_rate, reps, record, first=False):
    """One case of a kernel, on both input layouts of its entry: a fresh
    shared DevicePoolCache, the main path's layout (pool stride = cache
    capacity, columns from dedupe and slots, peq sliced from the tall pool,
    the systolic height ratchet), and the one-off pool (no cache).  On
    each, the result on the card is held against the plain version on the
    same tensors (every output element) and, after the entry's post step,
    against the host C++ Myers; the systolic kernel's plain version (some
    2-10 s a shape) runs on the pool-cache layout only, and its one-off
    layout's output is held against the pool-cache output (the same slot
    layout) instead; the short kernel is held against it at each W its K
    admits, on both layouts.  Then, on the cache layout, the kernel's
    CUDA-event median over `reps` launches (also at each KW or W), the
    plain version's time and the bound.  first: the main shape, put
    first."""
    import torch

    from taxtk_torch.native import myers_batch
    from taxtk_torch.ops import myers_cuda, myers_systolic
    from taxtk_torch.ops.seqpool import DevicePoolCache

    if kind == "short":
        inputs, kernel, plain_fn = (myers_cuda.short_inputs,
                                    myers_cuda.myers_short,
                                    myers_cuda.myers_short_plain)
    else:
        inputs, kernel, plain_fn = (myers_systolic.systolic_inputs,
                                    myers_systolic.myers_systolic,
                                    myers_systolic.myers_systolic_plain)
    plain_once = kind == "systolic"
    ac, bc, al, bl = to_batch(pairs)
    want = myers_batch(pairs)
    err = 0
    for layout in ("pool cache", "one-off pool"):
        cache = DevicePoolCache("cuda") if layout == "pool cache" else None
        args, post = inputs(ac, bc, al, bl, torch.device("cuda"),
                            pool_cache=cache)
        got = kernel(*args)
        if layout == "pool cache":
            cache_args, cache_got = args, got
        if plain_once and layout == "one-off pool":
            if not torch.equal(got, cache_got):
                fail(f"{kind} kernel differs between layouts on {label}")
        else:
            plain, ms = timed(lambda: plain_fn(*args))
            if not torch.equal(got, plain):
                fail(f"{kind} kernel != plain version on {label} "
                     f"({layout}): {int((got != plain).sum())} outputs "
                     f"differ")
            err = max(err, int((got - plain).abs().max()))
            if layout == "pool cache":
                plain_ms = ms
            if kind == "short":
                ms_by_w = _short_w_ms(args, plain,
                                      reps if layout == "pool cache" else 0)
                if layout == "pool cache":
                    cache_ms_by_w = ms_by_w
        if not np.array_equal(post(got.cpu().numpy()), want):
            fail(f"{kind} kernel != host C++ Myers on {label} ({layout})")
    bits = cache_args[-1]
    rec = dict(label=label, pairs=len(pairs), bits=bits, max_abs_err=err,
               plain_layouts=1 if plain_once else 2,
               ms=cuda_ms(lambda: kernel(*cache_args), reps),
               plain_ms=plain_ms)
    if plain_once:
        rec["ms_by_kw"] = _systolic_kw_ms(cache_args, cache_got, reps)
    else:
        rec["K"] = cache_args[6]
        rec["W"] = myers_cuda.kernel_geometry(rec["K"])[1]
        rec["ms_by_w"] = cache_ms_by_w
    rec["bound_ms"], rec["bound_by"] = bound(
        np.minimum(al, bl), np.maximum(al, bl), bits, int_rate)
    record.insert(0 if first else len(record), rec)
    print(f"kernels: {kind} {label}: {json.dumps(rec)}", flush=True)


def _short_pairs(launch):
    """The (a, b) pairs of a captured Kernel 1 launch."""
    a_codes, b_codes, a_len, b_len = launch["host"]
    return [(a_codes[i, : a_len[i]], b_codes[i, : b_len[i]])
            for i in range(len(a_len))]


def _check_short_launches(launches, reps):
    """Every Kernel 1 launch of the myers-cuda engine run, as phase_engine
    captured it, on a fresh pool cache: at each W its K admits against the
    plain version (every element) and, after post, the host C++ Myers,
    with each W's CUDA-event median.  Then the launches' summed times at
    each W (a launch whose K admits one W counts it under both)."""
    import torch

    from taxtk_torch.native import myers_batch
    from taxtk_torch.ops import myers_cuda
    from taxtk_torch.ops.seqpool import DevicePoolCache

    sums = {"W=1": 0.0, "W=2": 0.0}
    for i, launch in enumerate(launches):
        pairs = _short_pairs(launch)
        args, post = myers_cuda.short_inputs(
            *launch["host"], torch.device("cuda"),
            pool_cache=DevicePoolCache("cuda"))
        plain, plain_ms = timed(lambda: myers_cuda.myers_short_plain(*args))
        if not np.array_equal(post(plain.cpu().numpy()), myers_batch(pairs)):
            fail(f"short plain version != host C++ Myers at engine launch {i}")
        ms_by_w = _short_w_ms(args, plain, reps)
        for key in sums:
            sums[key] += ms_by_w.get(key, min(ms_by_w.values()))
        r = launch["rec"]
        rec = dict(launch=i, rows=r["rows"], N=r["N"], K=r["K"], W=r["W"],
                   ms_in_run=r["ms"], ms_by_w=ms_by_w, plain_ms=plain_ms,
                   bound_ms=r["bound_ms"])
        print(f"kernels: short engine launch {i}: {json.dumps(rec)}",
              flush=True)
    print(f"kernels: short engine launches: "
          f"{json.dumps(dict(launches=len(launches), ms_sum_by_w=sums))}",
          flush=True)


def _check_short_engine(launches, int_rate, reps, record):
    """Kernel 1 at the engine's own shape, its main shape: of the
    myers-cuda engine run's launches (phase_engine captured them all), the
    one with the most own word-chars, on both layouts against the plain
    version and the host C++ Myers at each W (_check).  Recorded first."""
    launch = max(launches, key=lambda x: x["rec"]["word_chars"])
    r = launch["rec"]
    _check("short", _short_pairs(launch),
           f"engine {r['rows']}x{r['N']} K={r['K']}", int_rate, reps, record,
           first=True)


def _check_systolic_engine(cap, int_rate, reps, record):
    """Kernel 2 at the engine's own shape: the arguments of the myers-cuda
    engine run's first 1024-pair long-route launch, as phase_engine
    captured them.  The kernel against the plain version (every output
    element) and, after post, the host C++ Myers; its CUDA-event median
    (also at each KW), the plain version's time and the bound.  Recorded first: it is row 2's
    main shape."""
    import torch

    from taxtk_torch.native import myers_batch
    from taxtk_torch.ops import myers_systolic

    args, post, pairs = cap["args"], cap["post"], cap["pairs"]
    got = myers_systolic.myers_systolic(*args)
    plain, plain_ms = timed(lambda: myers_systolic.myers_systolic_plain(*args))
    if not torch.equal(got, plain):
        fail(f"systolic kernel != plain version at the engine shape: "
             f"{int((got != plain).sum())} outputs differ")
    if not np.array_equal(post(got.cpu().numpy()), myers_batch(pairs)):
        fail("systolic kernel != host C++ Myers at the engine shape")
    al = np.array([len(a) for a, _ in pairs])
    bl = np.array([len(b) for _, b in pairs])
    m, n = np.minimum(al, bl), np.maximum(al, bl)
    bits = args[-1]
    label = f"engine {len(pairs)}x{m.min()}-{m.max()}"
    rec = dict(label=label, pairs=len(pairs), bits=bits,
               text_bp=[int(n.min()), int(n.max())],
               max_abs_err=int((got - plain).abs().max()),
               ms=cuda_ms(lambda: myers_systolic.myers_systolic(*args), reps),
               plain_ms=plain_ms,
               ms_by_kw=_systolic_kw_ms(args, plain, reps))
    rec["bound_ms"], rec["bound_by"] = bound(m, n, bits, int_rate)
    record.insert(0, rec)
    print(f"kernels: systolic {label}: {json.dumps(rec)}", flush=True)


def chunked_bound(n, words, launches, Kb, bits, int_rate):
    """Least time (ms) of chunked-kernel launches, and what bounds it: the
    essential Myers ops (OPS_PER_WORD_CHAR per 32-cell word per char) of
    `words` [B] pattern words per pair over its own text, over the integer
    issue rate, against the bytes `launches` [B] launches move once per
    pair (packed text, the block's Kb peq words, the packed carry stream
    read and written, a 32-bit word each per 16 chars, and nine int32 of
    per-pair input and output) over the memory rate."""
    n = np.asarray(n, np.int64)
    ops_ms = OPS_PER_WORD_CHAR * float((n * words).sum()) / int_rate * 1e3
    per_launch = (-(-n // (8 // bits)) + 2 * 4 * -(-n // 16) + Kb * 5 * 4
                  + 9 * 4)
    bytes_ms = float((launches * per_launch).sum()) / MEM_RATE * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def _block_launch(args, p=0):
    """The arguments of the chunked kernel's launch of pattern block p for
    the entry's args: the launches of the blocks before it run on the card
    (the kernel) to give its carries, score and res."""
    import torch

    from taxtk_torch.ops import myers_chunked as mc

    pool, txt_col, peq, pat_idx, mword, mbit, nlen, mlen, N, Kb, bits = args
    score, res = mlen, torch.maximum(mlen, nlen)
    hin = mc.initial_carries(N, txt_col.shape[0], pool.device)
    for q in range(p + 1):
        step = (pool, txt_col, peq[q * Kb : (q + 1) * Kb], pat_idx,
                mword - q * Kb, mbit, nlen, score, res, hin, bits)
        if q < p:
            score, res, hin = mc.myers_chunked(*step)
    return step


def _chunked_equal(a, b, N, nlen):
    """Whether two outputs (score, res, carry stream) of one chunked launch
    agree: score and res everywhere, the carries at every char j < nlen,
    all a later launch reads."""
    import torch

    from taxtk_torch.ops import myers_chunked as mc

    live = torch.arange(N, device=nlen.device)[:, None] < nlen[None]
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(mc.unpack_carries(a[2], N)[live],
                            mc.unpack_carries(b[2], N)[live]))


def _check_chunked(pairs, label, int_rate, reps, record, plain):
    """One case of the chunked kernel on both layouts of its entry (the
    one-off pool and a fresh DevicePoolCache, the main path's): every
    launch of the entry on the card, its distances against the host C++
    Myers.  On the cache layout, the entry's CUDA-event time (`entry_ms`);
    with `plain`, the first launch against the plain version (score, res,
    and the carry stream where a later launch reads it); and the first
    launch's CUDA-event median (`ms`), held against that launch's bound
    and plain time."""
    import torch

    from taxtk_torch.native import myers_batch
    from taxtk_torch.ops import myers_chunked as mc
    from taxtk_torch.ops.seqpool import DevicePoolCache

    ac, bc, al, bl = to_batch(pairs)
    want = myers_batch(pairs)
    for layout in ("one-off pool", "pool cache"):
        cache = DevicePoolCache("cuda") if layout == "pool cache" else None
        args, post = mc.chunked_inputs(ac, bc, al, bl, torch.device("cuda"),
                                       pool_cache=cache)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = mc.run_chunked(*args)
        end.record()
        if not np.array_equal(post(got.cpu().numpy()), want):
            fail(f"chunked kernel != host C++ Myers on {label} ({layout})")
    entry_ms = start.elapsed_time(end)
    step = _block_launch(args)
    err, plain_ms = 0, None
    if plain:
        got = mc.myers_chunked(*step)
        want_step, plain_ms = timed(lambda: mc.myers_chunked_plain(*step))
        if not _chunked_equal(got, want_step, args[8], args[6]):
            fail(f"chunked kernel != plain version on {label}")
        err = max(int((got[0] - want_step[0]).abs().max()),
                  int((got[1] - want_step[1]).abs().max()))
    Kb, bits = args[9], args[10]
    m, n = np.minimum(al, bl), np.maximum(al, bl)
    words = -(-m // 32)
    blocks = -(-words // Kb)
    rec = dict(label=label, pairs=len(pairs), bits=bits,
               blocks=int(blocks.max()), max_abs_err=err,
               plain_checked=plain,
               ms=cuda_ms(lambda: mc.myers_chunked(*step), reps),
               plain_ms=plain_ms, entry_ms=entry_ms)
    rec["bound_ms"], rec["bound_by"] = chunked_bound(
        n, np.minimum(words, Kb), 1, Kb, bits, int_rate)
    rec["entry_bound_ms"], _ = chunked_bound(n, words, blocks, Kb, bits,
                                             int_rate)
    record.append(rec)
    print(f"kernels: chunked {label}: {json.dumps(rec)}", flush=True)


def wavefront_bound(al, bl, int_rate):
    """Least time (ms) for the min-plus DP of these pairs, and what bounds
    it: DNA_OPS_PER_CELL INT32 ops per cell of each pair's own alen x blen
    over the integer issue rate, against the bytes moved once (both sides'
    codes, the two int32 lengths and the int32 result) over the memory
    rate."""
    al = np.asarray(al, np.int64)
    bl = np.asarray(bl, np.int64)
    ops_ms = DNA_OPS_PER_CELL * float((al * bl).sum()) / int_rate * 1e3
    bytes_ms = float((al + bl).sum() + 12 * len(al)) / MEM_RATE * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def _wavefront_forced_ms(args, want, reps, **force):
    """Row 6 on `args` with one of kernel_geometry's choices forced (R=...
    or nw=...): its output held against `want` (the plain version's) and
    its CUDA-event median."""
    import torch

    from taxtk_torch.ops import dna_wavefront as dw

    real = dw.kernel_geometry
    with mock.patch.object(dw, "kernel_geometry",
                           lambda *a, **k: real(*a, **{**k, **force})):
        if not torch.equal(dw._launch(*args), want):
            fail(f"dna_wavefront at {force} != plain version")
        return cuda_ms(lambda: dw._launch(*args), reps)


def _check_wavefront(batch, label, int_rate, reps, record, by_nw=False,
                     first=False):
    """One launch of the DNA wavefront kernel on a padded batch (ac, bc,
    al, bl) as the aligner forms it: its distances against the host C++
    Myers and, element for element, the plain version's; CUDA-event
    median, the plain version's time, the bound, and the time at each R
    (rows per lane) and, with by_nw, at each band width nw, each forced
    and held against the plain version.  first: the main shape, put
    first."""
    import torch

    from taxtk_torch.native import myers_batch
    from taxtk_torch.ops import dna_wavefront as dw
    from taxtk_torch.ops.dna_align import (edit_distance_wavefront,
                                           wavefront_inputs)

    ac, bc, al, bl = batch
    pairs = [(ac[i, : al[i]], bc[i, : bl[i]]) for i in range(len(al))]
    args = wavefront_inputs(ac, bc, al, bl, "cuda")
    got = dw.dna_wavefront(*args)
    if not np.array_equal(got.cpu().numpy(), myers_batch(pairs)):
        fail(f"dna_wavefront != host C++ Myers on {label}")
    plain, plain_ms = timed(lambda: edit_distance_wavefront(*args))
    if not torch.equal(got, plain):
        fail(f"dna_wavefront != plain version on {label}")
    R, nw = dw.kernel_geometry(len(al), ac.shape[1], bc.shape[1])[:2]
    rec = dict(label=label, pairs=len(al), L=int(ac.shape[1]), R=R, nw=nw,
               cells=int((al.astype(np.int64) * bl).sum()),
               max_abs_err=int((got - plain).abs().max()),
               # timed as the entry launches it: lengths checked on the
               # host, so no wait on the card before the launch
               ms=cuda_ms(lambda: dw._launch(*args), reps),
               plain_ms=plain_ms,
               ms_by_R={f"R={r}": _wavefront_forced_ms(args, plain, reps, R=r)
                        for r in dw.ROWS_PER_LANE})
    if by_nw:
        rec["ms_by_nw"] = {f"nw={w}": _wavefront_forced_ms(args, plain, reps,
                                                           nw=w)
                           for w in (1, 2, 4, 8, 16)}
    rec["bound_ms"], rec["bound_by"] = wavefront_bound(al, bl, int_rate)
    record.insert(0 if first else len(record), rec)
    print(f"kernels: wavefront {label}: {json.dumps(rec)}", flush=True)


def phase_kernels(int_rate, long_shapes=((64, 25_000), (16, 50_000),
                                         (4, 98_000))):
    """Each kernel against its plain version and the host C++ Myers.  The
    first case of each kernel is its main-path shape and gives its times
    (the main shapes of Kernels 1 and 2 and row 6, the engine's own
    launches, are checked after the engine phase and put first)."""
    rng = np.random.default_rng(1234)
    short, long_, chunked, wave = [], [], [], []
    # Kernel 1: 2048 pairs at 2048 bp (the aligner's max_batch_cells cap
    # allows 2048 pairs there, though the engine's launches hold at most
    # 512 rows; K = 64, 2-bit), then the 8192-pair group the aligner forms
    # only for short texts
    _check("short", make_pairs(rng, 2048, (1025, 2048), (1025, 2048)),
           "2048x2048", int_rate, 5, short)
    _check("short", make_pairs(rng, 8192, (1025, 2048), (1025, 2048)),
           "8192x2048", int_rate, 5, short)
    # ragged lengths with empty sides, 2-bit and 4-bit (N codes) wires
    for alpha, label in ((4, "ragged-2bit"), (5, "ragged-4bit-N")):
        _check("short", make_pairs(rng, 3000, (0, 2048), (0, 2048), alpha),
               label, int_rate, 3, short)
    # Kernel 2: few long pairs, from 25 kbp to the 98 kbp pattern cap
    for B, L in long_shapes:
        _check("systolic", make_pairs(rng, B, (L - 500, L), (L, L + 500)),
               f"{B}x{L // 1000}k", int_rate, 3, long_)
    _check("systolic", make_pairs(rng, 48, (2049, 12_000), (2049, 16_000), 5),
           "ragged-4bit-N", int_rate, 3, long_)
    # the chunked kernel: the same long shapes (the plain version at the
    # first, launch by launch), a ragged 4-bit batch with N codes (also
    # against the plain version) and a full 1024-pair chunk of the
    # oversized-round route
    for i, (B, L) in enumerate(long_shapes):
        _check_chunked(make_pairs(rng, B, (L - 500, L), (L, L + 500)),
                       f"{B}x{L // 1000}k", int_rate, 3, chunked, i == 0)
    _check_chunked(make_pairs(rng, 48, (2049, 12_000), (2049, 16_000), 5),
                   "ragged-4bit-N", int_rate, 3, chunked, True)
    _check_chunked(make_pairs(rng, 1024, (2049, 6000), (2049, 6500)),
                   "1024x2049-6000", int_rate, 3, chunked, False)
    # the DNA wavefront kernel at the aligner's square buckets, each capped
    # at max_batch_cells // L^2 pairs: 1 at L = 32768, 4 at 8192, 64 at
    # 2048, 4096 at 256; then a ragged bucket with N codes and length-1
    # sides
    for B, L in ((1, 32768), (4, 8192), (64, 2048), (4096, 256)):
        lo = 19_000 if L == 32768 else L // 2 + 1
        hi = 20_000 if L == 32768 else L
        _check_wavefront(_bucket(make_pairs(rng, B, (lo, hi), (lo, hi)), L),
                         f"{B}x{L}", int_rate, 3, wave, by_nw=B == 1)
    ragged = make_pairs(rng, 1500, (1, 512), (1, 512), 5)
    for i in range(0, 1500, 50):
        a, b = ragged[i]
        ragged[i] = (a[:1], b) if i % 100 else (a, b[:1])
    _check_wavefront(_bucket(ragged, 512), "ragged-4bit-N", int_rate, 3,
                     wave)
    return short, long_, chunked, wave


def run_cli(argv, aln_path):
    """taxtk_torch.cli.taxator.main in this process (what
    `python -m taxtk_torch.cli.taxator` runs), stdin from aln_path, on a
    cold shared pool cache, so the pool stats and the time are this run's
    own.  Returns (gff3, seconds, aligner stats from --stats)."""
    from taxtk_torch.cli import taxator
    from taxtk_torch.ops.seqpool import reset_shared_pools

    reset_shared_pools()
    out, err = io.StringIO(), io.StringIO()
    with open(aln_path) as stdin:
        saved, sys.stdin = sys.stdin, stdin
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                t = time.perf_counter()
                rc = taxator.main(argv + ["--stats"])
                secs = time.perf_counter() - t
        finally:
            sys.stdin = saved
    if rc != 0:
        fail(f"taxator {' '.join(argv)} exited {rc}: {err.getvalue()}")
    line = [ln for ln in err.getvalue().splitlines()
            if ln.startswith("taxtk_torch aligner: ")]
    stats = json.loads(line[-1].split(": ", 1)[1])
    return out.getvalue(), secs, stats


class LaunchCapture:
    """One kernel inside one engine run, seen from outside its wrapper
    (whose count it leaves alone): CUDA events recorded on the stream
    around each launch (the module's `lib` seam, `_lib()` by default,
    patched), with no sync inside the run, and what `keep(kept, host,
    out)` keeps of the entry's inputs (`host`: the numpy a_codes, b_codes,
    a_len, b_len handed to the module's `inputs` function, which is
    patched; `out`: what it returned).  spin: each start event waits
    behind a spin of SPIN_CYCLES on the card, as in cuda_ms, so that the
    window holds the launch and not the host's call into the library."""

    def __init__(self, module, inputs, keep, lib="_lib", spin=False):
        self.module, self.inputs, self.keep = module, inputs, keep
        self.lib, self.spin = lib, spin
        self.events = []
        self.kept = None

    @contextlib.contextmanager
    def active(self):
        import torch

        real = getattr(self.module, self.inputs)
        lib = getattr(self.module, self.lib)

        def capture_inputs(a_codes, b_codes, a_len, b_len, *rest, **kw):
            out = real(a_codes, b_codes, a_len, b_len, *rest, **kw)
            self.kept = self.keep(self.kept, (a_codes, b_codes, a_len, b_len),
                                  out)
            return out

        def timed_lib():
            fn = lib()

            def launch(*a):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                if self.spin:
                    torch.cuda._sleep(SPIN_CYCLES)
                start.record()
                rc = fn(*a)
                end.record()
                self.events.append((start, end))
                return rc
            return launch

        with mock.patch.object(self.module, self.inputs, capture_inputs), \
                mock.patch.object(self.module, self.lib, timed_lib):
            yield self

    def kernel_ms(self):
        """Each launch's CUDA-event time (ms), after one sync."""
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def keep_first_systolic(kept, host, out, B=1024):
    """Kernel 2's capture: a copy of the arguments of the first launch of
    B pairs (row 2's main shape)."""
    import torch

    a_codes, b_codes, a_len, b_len = host
    if kept is not None or len(a_len) != B:
        return kept
    args, post = out
    return dict(args=tuple(x.clone() if torch.is_tensor(x) else x
                           for x in args),
                post=post,
                pairs=[(a_codes[i, : a_len[i]], b_codes[i, : b_len[i]])
                       for i in range(B)])


def keep_short_launches(kept, host, out):
    """Kernel 1's capture: a copy of the host inputs of every launch, with
    the launch's K and bits (args[6], args[7] of short_inputs)."""
    args = out[0]
    return (kept or []) + [dict(host=tuple(np.array(x) for x in host),
                                K=args[6], bits=args[7])]


def short_launch_record(launch, ms, int_rate):
    """What chip_smoke prints of one Kernel 1 engine launch: rows, real
    pairs (rows less the aligner's trailing 1 x 1 dummy rows), N (the text
    bucket, the padded width of the launch's codes), K, bits, the kernel's
    geometry (G lanes a pair, W words a lane), the pairs' own word-chars
    (the sum of n * ceil(m / 32)), the bound and the launch's CUDA-event
    time."""
    from taxtk_torch.ops.myers_cuda import kernel_geometry

    a_codes, b_codes, a_len, b_len = launch["host"]
    m = np.minimum(a_len, b_len).astype(np.int64)
    n = np.maximum(a_len, b_len).astype(np.int64)
    real = len(a_len)
    while real and a_len[real - 1] == 1 and b_len[real - 1] == 1:
        real -= 1
    G, W = kernel_geometry(launch["K"])[:2]
    rec = dict(rows=len(a_len), real=real, N=int(b_codes.shape[1]),
               K=launch["K"], bits=launch["bits"], G=G, W=W,
               word_chars=int((n * -(-m // 32)).sum()), ms=ms)
    rec["bound_ms"], rec["bound_by"] = bound(m, n, launch["bits"], int_rate)
    return rec


def keep_largest_wavefront(kept, host, out):
    """Row 6's and row 4's capture: the host inputs of the launch with the
    most DP cells (each row's main shape since its redesign)."""
    a_len, b_len = host[2], host[3]
    cells = int((np.asarray(a_len, np.int64) * b_len).sum())
    if kept is not None and kept["cells"] >= cells:
        return kept
    return dict(cells=cells, host=host)


def keep_chunked_calls(kept, host, out):
    """Row 3's capture: a copy of the host inputs of every entry call, with
    its launches (one per pattern block of Kb words, args[9]) and bits."""
    args = out[0]
    Kb = args[9]
    return (kept or []) + [dict(host=tuple(np.array(x) for x in host),
                                blocks=args[2].shape[0] // Kb, Kb=Kb,
                                bits=args[10])]


def chunked_launch_records(calls, ms, int_rate):
    """What chip_smoke prints of each row-3 launch of the oversized run, in
    launch order: its entry call and pattern block, pairs, the texts'
    longest and summed lengths, bits, the pairs' own word-chars in this
    block (the sum of n * the pattern words of the pair that lie in it),
    the launch's CUDA-event time and its bound."""
    recs = []
    for c, call in enumerate(calls):
        _, _, a_len, b_len = call["host"]
        m = np.minimum(a_len, b_len).astype(np.int64)
        n = np.maximum(a_len, b_len).astype(np.int64)
        words = -(-m // 32)
        Kb, bits = call["Kb"], call["bits"]
        for p in range(call["blocks"]):
            own = np.clip(words - p * Kb, 0, Kb)
            rec = dict(call=c, block=p, pairs=len(a_len),
                       text_max=int(n.max()), text_sum=int(n.sum()),
                       bits=bits, word_chars=int((n * own).sum()),
                       ms=ms[len(recs)])
            rec["bound_ms"], rec["bound_by"] = chunked_bound(
                n, own, 1, Kb, bits, int_rate)
            recs.append(rec)
    return recs


def _check_chunked_engine(calls, recs, int_rate, reps, record):
    """Row 3 at the engine's own shape, its main shape: of the oversized
    run's launches, the one with the most own word-chars.  Its entry call
    runs on both layouts of the entry (the one-off pool and a fresh
    DevicePoolCache), its distances against the host C++ Myers; the launch
    itself, on the cache layout, against the plain version (score, res and
    the carries a later launch reads), and on the one-off layout against
    the cache layout's output.  Then its CUDA-event median, the plain
    version's time and the bound.  Recorded first."""
    import torch

    from taxtk_torch.native import myers_batch
    from taxtk_torch.ops import myers_chunked as mc
    from taxtk_torch.ops.seqpool import DevicePoolCache

    r = max(recs, key=lambda x: x["word_chars"])
    host = calls[r["call"]]["host"]
    a_codes, b_codes, a_len, b_len = host
    pairs = [(a_codes[i, : a_len[i]], b_codes[i, : b_len[i]])
             for i in range(len(a_len))]
    want = myers_batch(pairs)
    got = {}
    for layout in ("one-off pool", "pool cache"):
        cache = DevicePoolCache("cuda") if layout == "pool cache" else None
        args, post = mc.chunked_inputs(*host, torch.device("cuda"),
                                       pool_cache=cache)
        if not np.array_equal(post(mc.run_chunked(*args).cpu().numpy()),
                              want):
            fail(f"chunked kernel != host C++ Myers at the engine shape "
                 f"({layout})")
        step = _block_launch(args, r["block"])
        got[layout] = mc.myers_chunked(*step)
    N, nlen = args[8], args[6]
    plain, plain_ms = timed(lambda: mc.myers_chunked_plain(*step))
    if not _chunked_equal(got["pool cache"], plain, N, nlen):
        fail("chunked kernel != plain version at the engine shape")
    if not _chunked_equal(got["one-off pool"], got["pool cache"], N, nlen):
        fail("chunked kernel differs between layouts at the engine shape")
    label = (f"engine {r['pairs']}x{r['text_max']} block {r['block']} "
             f"(launch {recs.index(r)})")
    rec = dict(label=label, pairs=r["pairs"], bits=r["bits"],
               block=r["block"], text_max=r["text_max"],
               text_sum=r["text_sum"], word_chars=r["word_chars"],
               max_abs_err=max(
                   int((got["pool cache"][0] - plain[0]).abs().max()),
                   int((got["pool cache"][1] - plain[1]).abs().max())),
               plain_checked=True, ms_in_run=r["ms"],
               ms=cuda_ms(lambda: mc.myers_chunked(*step), reps),
               plain_ms=plain_ms, bound_ms=r["bound_ms"],
               bound_by=r["bound_by"])
    record.insert(0, rec)
    print(f"kernels: chunked {label}: {json.dumps(rec)}", flush=True)


def kernel_wrappers():
    """Each kernel's wrapper by name; `launches` on a wrapper counts its
    kernel's launches."""
    from taxtk_torch.ops import (dna_wavefront, myers_chunked, myers_cuda,
                                 myers_systolic, protein_cuda)

    return {"myers_short": myers_cuda.myers_short,
            "myers_systolic": myers_systolic.myers_systolic,
            "myers_chunked": myers_chunked.myers_chunked,
            "dna_wavefront": dna_wavefront.dna_wavefront,
            "protein_wavefront": protein_cuda.protein_wavefront,
            "protein_swar": protein_cuda.protein_swar}


def phase_engine(int_rate, n_contigs=300):
    """The port's main paths on make_workload: nucleotide taxator with
    myers-cuda, with --dna-backend native, with wavefront-cuda, and with
    myers-cuda and the aligner's systolic_max_pairs = 0 (taxtk's
    oversized-round route, which has no CLI flag).  Each GFF3 must equal
    native's.  The myers-cuda run also times each Kernel 1 and Kernel 2
    launch, prints each Kernel 1 launch with its bound, and keeps the host
    inputs of every Kernel 1 launch and the first 1024-pair Kernel 2
    launch's arguments; the oversized run times each row-3 launch behind
    the spin, prints each with its bound, and keeps the host inputs of
    every entry call; the wavefront-cuda run times each row-6 launch and
    keeps the inputs of its largest (LaunchCapture).
    Returns each kernel's launch count from its path's run, the four
    captures (row 3's with its launch records) and native's GFF3."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from bench_e2e import make_workload

    from taxtk_torch.engine import aligner as aligner_mod
    from taxtk_torch.ops import (dna_wavefront, myers_chunked, myers_cuda,
                                 myers_systolic)

    wrappers = kernel_wrappers()
    launches = {}

    def counted(run, names):
        """run() with the named kernels' counts set to 0 just before; every
        count read just after."""
        for w in wrappers.values():
            w.launches = 0
        value = run()
        counts = {k: w.launches for k, w in wrappers.items()}
        for name in names:
            if counts[name] <= 0:
                fail(f"the main path never launched {name}")
            launches[name] = counts[name]
        return value, counts

    class OversizedAligner(aligner_mod.BatchAligner):
        """Every long chunk to the chunked entry (taxtk's
        systolic_max_pairs = 0)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.systolic_max_pairs = 0

    def run_oversized():
        with mock.patch.object(aligner_mod, "BatchAligner", OversizedAligner):
            return run_cli(argv, aln)

    mbp_h = lambda bp, s: bp / 1e6 / (s / 3600)  # noqa: E731
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        t = time.time()
        aln, qfa, rfa, mapping, tax_dir, total_qbp = make_workload(
            d, n_contigs, seed=7, min_len=1000, max_len=20000)
        gen_s = time.time() - t
        os.environ["TAXATORTK_TAXONOMY_NCBI"] = tax_dir
        argv = ["-g", mapping, "-q", qfa, "-f", rfa, "-i", rfa + ".fai"]
        capture = LaunchCapture(myers_systolic, "systolic_inputs",
                                keep_first_systolic)
        short_cap = LaunchCapture(myers_cuda, "short_inputs",
                                  keep_short_launches)
        with capture.active(), short_cap.active():
            runs["myers-cuda"] = counted(lambda: run_cli(argv, aln),
                                         ("myers_short", "myers_systolic"))
        k2_ms = capture.kernel_ms()
        if capture.kept is None or len(k2_ms) != launches["myers_systolic"]:
            fail("the myers-cuda run made no 1024-pair Kernel 2 launch, or "
                 "its launches were not all timed")
        k1_ms = short_cap.kernel_ms()
        if (len(k1_ms) != launches["myers_short"]
                or len(short_cap.kept) != len(k1_ms)):
            fail("the myers-cuda run's Kernel 1 launches were not all timed")
        for i, (launch, ms) in enumerate(zip(short_cap.kept, k1_ms)):
            launch["rec"] = short_launch_record(launch, ms, int_rate)
            print(f"engine: myers_short launch {i}: "
                  f"{json.dumps(launch['rec'])}", flush=True)
        runs["native"] = counted(
            lambda: run_cli(argv + ["--dna-backend", "native"], aln), ())
        # every row-3 launch of the oversized run timed behind the spin,
        # the host inputs of each entry call kept
        chunk_cap = LaunchCapture(myers_chunked, "chunked_inputs",
                                  keep_chunked_calls, spin=True)
        with chunk_cap.active():
            runs["oversized"] = counted(run_oversized, ("myers_chunked",))
        c_ms = chunk_cap.kernel_ms()
        if (len(c_ms) != launches["myers_chunked"] or chunk_cap.kept is None
                or sum(c["blocks"] for c in chunk_cap.kept) != len(c_ms)):
            fail("the oversized run's row-3 launches were not all timed")
        c_recs = chunked_launch_records(chunk_cap.kept, c_ms, int_rate)
        for i, r in enumerate(c_recs):
            print(f"engine: myers_chunked launch {i}: {json.dumps(r)}",
                  flush=True)
        wave_cap = LaunchCapture(dna_wavefront, "wavefront_inputs",
                                 keep_largest_wavefront)
        with wave_cap.active():
            runs["wavefront-cuda"] = counted(
                lambda: run_cli(argv + ["--dna-backend", "wavefront-cuda"],
                                aln),
                ("dna_wavefront",))
        w_ms = wave_cap.kernel_ms()
        if wave_cap.kept is None or len(w_ms) != launches["dna_wavefront"]:
            fail("the wavefront-cuda run's row-6 launches were not all timed")
    gff_native = runs["native"][0][0]
    n_lines = gff_native.count("\n")
    if not gff_native.startswith("##gff-version 3\n") or n_lines < n_contigs:
        fail(f"GFF3 has {n_lines} lines for {n_contigs} contigs")
    for label in ("myers-cuda", "oversized", "wavefront-cuda"):
        if runs[label][0][0] != gff_native:
            fail(f"{label} GFF3 differs from --dna-backend native")
    rec = dict(contigs=n_contigs, query_bp=total_qbp, gff3_lines=n_lines,
               workload_s=gen_s, gff3_identical=True)
    for label, ((_, secs, stats), counts) in runs.items():
        rec[label] = dict(engine_s=secs, mbp_per_h=mbp_h(total_qbp, secs),
                          launches=counts, stats=stats)
    rec["myers-cuda"]["myers_systolic_ms"] = k2_ms
    rec["myers-cuda"]["myers_short_ms"] = k1_ms
    rec["myers-cuda"]["myers_short_ms_sum"] = sum(k1_ms)
    rec["myers-cuda"]["myers_short_bound_ms_sum"] = sum(
        launch["rec"]["bound_ms"] for launch in short_cap.kept)
    rec["myers-cuda"]["myers_systolic_ms_sum"] = sum(k2_ms)
    rec["oversized"]["myers_chunked_ms"] = c_ms
    rec["oversized"]["myers_chunked_ms_sum"] = sum(c_ms)
    rec["oversized"]["myers_chunked_bound_ms_sum"] = sum(
        r["bound_ms"] for r in c_recs)
    rec["wavefront-cuda"]["dna_wavefront_ms"] = w_ms
    rec["wavefront-cuda"]["dna_wavefront_ms_sum"] = sum(w_ms)
    print(f"engine: {json.dumps(rec)}", flush=True)
    return (launches, capture.kept, wave_cap.kept, short_cap.kept,
            (chunk_cap.kept, c_recs), gff_native)


def protein_bound(al, bl, int_rate, packed):
    """Least time (ms) for the protein DP of these pairs, and what bounds
    it: the INT32 ops per cell of each pair's own alen x blen over the
    integer issue rate, against the bytes moved once (the codes of both
    sides, four int32 of per-pair input, the int32 [3, B] result) over the
    memory rate.  v5 and v6 compute the same function, so a shape has one
    bound for both: SWAR_OPS_PER_CELL where its bucket lies in v6's
    domain (packed), since two cells a word is then the least work;
    OPS_PER_CELL outside it, where a score may not fit a 16-bit half."""
    al = np.asarray(al, np.int64)
    bl = np.asarray(bl, np.int64)
    per_cell = SWAR_OPS_PER_CELL if packed else OPS_PER_CELL
    ops_ms = per_cell * float((al * bl).sum()) / int_rate * 1e3
    bytes_ms = float((al + bl).sum() + 28 * len(al)) / MEM_RATE * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def standard_residues():
    """Codes of the 20 standard amino acids (bench.py's alphabet)."""
    from taxtk_torch.ops.blosum import AA_ORDER

    return np.array([AA_ORDER.index(c) for c in "ACDEFGHIKLMNPQRSTVWY"],
                    np.uint8)


def make_protein_pairs(rng, B, len_range, redraw=(0.10, 0.35),
                       empty=0.0, xstar=0.0):
    """B related protein pairs, as RPA realigns them: a random over the
    20 standard residues with a length in len_range, b a copy of a resized
    to a length in len_range with 10-35% of its residues redrawn.  Then a
    share `empty` of sides emptied and a share `xstar` of codes set to X
    or *."""
    std = standard_residues()
    pairs = []
    for _ in range(B):
        m = int(rng.integers(len_range[0], len_range[1] + 1))
        n = int(rng.integers(len_range[0], len_range[1] + 1))
        a = std[rng.integers(0, 20, m)]
        b = np.resize(a, n).copy()
        red = rng.random(n) < rng.uniform(*redraw)
        b[red] = std[rng.integers(0, 20, int(red.sum()))]
        for s in (a, b):
            s[rng.random(len(s)) < xstar] = rng.choice([25, 26])
        if rng.random() < empty:
            a = a[:0]
        if rng.random() < empty:
            b = b[:0]
        pairs.append((a, b))
    return pairs


def _bucket(pairs, L):
    """The aligner's padded square bucket of side L."""
    ac, bc, al, bl = to_batch(pairs)
    pad = lambda x: np.pad(x, ((0, 0), (0, L - x.shape[1])))  # noqa: E731
    return pad(ac), pad(bc), al, bl


# each protein kernel's kernel_geometry swar flag and the band widths
# timed
PROTEIN_GEOMETRY = {"protein_wavefront": (False, (4, 8, 16)),
                    "protein_swar": (True, (2, 4, 8, 16))}


def _protein_nw_ms(name, args, want, reps, nw):
    """Protein kernel `name` on `args` with its geometry's nw forced: its
    output held against `want` (the plain version's) and its CUDA-event
    median."""
    import torch

    from taxtk_torch.ops import protein_cuda as pc

    real = pc.kernel_geometry
    fn = getattr(pc, name)
    with mock.patch.object(pc, "kernel_geometry",
                           lambda B, M, N, nw_=None, swar=False:
                           real(B, M, N, nw, swar)):
        if not torch.equal(fn(*args), want):
            fail(f"{name} at nw={nw} != plain version")
        return cuda_ms(lambda: fn(*args), reps)


def _check_protein(batch, label, int_rate, reps, records,
                   names=("protein_wavefront", "protein_swar"),
                   layouts=("one-off pool", "pool cache"), first=False,
                   by_nw=False):
    """One main-path launch (ac, bc, al, bl, padded to the bucket) of the
    named protein kernels (v6 only inside its domain), on the entry's
    layouts: the one-off pool and a fresh DevicePoolCache (the main
    path's, timed).  On each, every output element is held against the
    plain version on the same tensors, and the mutual scores against the
    host C++ NW.  Then, on the cache layout, each kernel's CUDA-event
    median over `reps` launches, the plain version's time and the bound;
    with by_nw, each kernel also at each band width nw of
    PROTEIN_GEOMETRY, forced.  first: the main shape, put first."""
    import torch

    from taxtk_torch.native import protein_nw_batch
    from taxtk_torch.ops import protein_cuda as pc
    from taxtk_torch.ops.seqpool import DevicePoolCache

    ac, bc, al, bl = batch
    M, N = ac.shape[1], bc.shape[1]
    pairs = [(ac[i, : al[i]], bc[i, : bl[i]]) for i in range(len(al))]
    want = protein_nw_batch(pairs, n_threads=0)
    packed = pc._swar_fits(*pc._shapes(M, N)[:2])
    kernels = [(name, getattr(pc, name)) for name in names
               if name != "protein_swar" or packed]
    err = 0
    for layout in layouts:
        cache = DevicePoolCache("cuda") if layout == "pool cache" else None
        args = pc.protein_inputs(ac, bc, al, bl, torch.device("cuda"), cache)
        plain, plain_ms = timed(lambda: pc.protein_plain(*args))
        for name, fn in kernels:
            got = fn(*args)
            if not torch.equal(got, plain):
                fail(f"{name} != plain version on {label} ({layout}): "
                     f"{int((got != plain).any(0).sum())} pairs differ")
            if not np.array_equal(got[0].cpu().numpy(), want):
                fail(f"{name} mutual scores != host C++ NW on {label} "
                     f"({layout})")
            err = max(err, int((got - plain).abs().max()))
    bnd, by = protein_bound(al, bl, int_rate, packed)
    for name, fn in kernels:
        rec = dict(label=label, pairs=len(al), L=int(M),
                   cells=int((al.astype(np.int64) * bl).sum()),
                   max_abs_err=err, ms=cuda_ms(lambda: fn(*args), reps),
                   plain_ms=plain_ms, bound_ms=bnd, bound_by=by)
        swar, widths = PROTEIN_GEOMETRY[name]
        rec["nw"] = pc.kernel_geometry(len(al), M, N, swar=swar)[0]
        if by_nw:
            rec["ms_by_nw"] = {f"nw={w}": _protein_nw_ms(name, args, plain,
                                                          reps, w)
                               for w in widths}
        recs = records.setdefault(name, [])
        recs.insert(0 if first else len(recs), rec)
        print(f"protein: {name} {label}: {json.dumps(rec)}", flush=True)


def phase_protein(int_rate):
    """Both protein kernels at the main path's shapes.  The first shape,
    the aligner's full 512 bucket, gives the times."""
    rng = np.random.default_rng(4321)
    records = {}
    # the aligner caps a bucket at max_batch_cells // L^2 pairs: 1024 at
    # L = 512, 4096 at L = 256, 64 at L = 2048 (outside v6's domain)
    _check_protein(_bucket(make_protein_pairs(rng, 1024, (257, 512)), 512),
                   "1024x512", int_rate, 5, records, by_nw=True)
    _check_protein(_bucket(make_protein_pairs(rng, 4096, (129, 256)), 256),
                   "4096x256", int_rate, 5, records)
    # bench.py's canonical launch: 512 unrelated pairs of exactly 256 aa
    r7 = np.random.RandomState(7)
    std = standard_residues()
    a = std[r7.randint(0, 20, (512, 256))]
    b = std[r7.randint(0, 20, (512, 256))]
    _check_protein(_bucket(list(zip(a, b)), 256), "512x256x256", int_rate, 5,
                   records)
    _check_protein(_bucket(make_protein_pairs(rng, 64, (1025, 2048)), 2048),
                   "64x2048", int_rate, 3, records, by_nw=True)
    _check_protein(_bucket(make_protein_pairs(rng, 1500, (60, 400),
                                              empty=0.03, xstar=0.02), 512),
                   "ragged-60-400", int_rate, 3, records)
    # v6's tallest bucket (the aligner's cap: 256 pairs at L = 1024),
    # where kernel_geometry's nw rule for row 5 is set
    _check_protein(_bucket(make_protein_pairs(rng, 256, (513, 1024)), 1024),
                   "256x1024", int_rate, 3, records, by_nw=True)
    return records


def phase_golden():
    """Every protein pair of both SeqAn golden corpora through both
    kernels, bucketed by pow2 of the longer side as
    tests/test_seqan_golden.py buckets them; v6 only where _swar_fits."""
    from taxtk_torch.ops import protein_cuda as pc
    from taxtk_torch.ops.seqpool import DevicePoolCache
    from taxtk_torch.refpack.store import encode_protein

    rows = []
    for name in ("seqan_golden.tsv", "seqan_golden_r2.tsv"):
        with open(os.path.join(ROOT, "tests", "fixtures", name)) as f:
            for line in f:
                if line.startswith("prot\t"):
                    _, a, b, vals = line.rstrip("\n").split("\t")
                    rows.append((encode_protein(a), encode_protein(b),
                                 tuple(map(int, vals.split(",")))))
    buckets = {}
    for i, (a, b, _) in enumerate(rows):
        L = 1
        while L < max(len(a), len(b)):
            L <<= 1
        buckets.setdefault(L, []).append(i)
    n_v6 = 0
    cache = DevicePoolCache("cuda")
    for L, idxs in sorted(buckets.items()):
        ac, bc, al, bl = _bucket([rows[i][:2] for i in idxs], L)
        fits = pc._swar_fits(*pc._shapes(L, L)[:2])
        for swar in ((False, True) if fits else (False,)):
            got = pc.batched_protein_align_cuda(ac, bc, al, bl,
                                                device="cuda",
                                                pool_cache=cache, swar=swar)
            for r, i in enumerate(idxs):
                have = (int(got["selfscore"][r]), int(got["mutual"][r]),
                        int(got["matches"][r]), int(got["mismatches"][r]),
                        int(got["gaps"][r]))
                if have != rows[i][2]:
                    fail(f"golden protein pair {i} ({'v6' if swar else 'v5'}"
                         f"): {have} != {rows[i][2]}")
            n_v6 += len(idxs) if swar else 0
    rec = dict(pairs=len(rows), v5_pairs=len(rows), v6_pairs=n_v6,
               buckets=sorted(buckets))
    print(f"golden: {json.dumps(rec)}", flush=True)


def run_binner(gff3: str) -> str:
    """taxtk_torch.cli.binner.main on the GFF3's body, sorted by query as
    the binning pipeline sorts it; returns the bioboxes output."""
    from taxtk_torch.cli import binner

    body = sorted((ln for ln in gff3.splitlines() if not ln.startswith("#")),
                  key=lambda ln: ln.split("\t")[0])
    out = io.StringIO()
    saved, sys.stdin = sys.stdin, io.StringIO("\n".join(body) + "\n")
    try:
        with contextlib.redirect_stdout(out):
            rc = binner.main(["-n", "s", "-g", "([^_]+)_.*", "-l",
                              os.devnull])
    finally:
        sys.stdin = saved
    if rc != 0:
        fail(f"binner exited {rc}")
    return out.getvalue()


# the protein engine runs whose kernel launches are timed: the kernel and
# its wrapper's C-entry seam
PROTEIN_CAPTURES = {"wavefront-cuda": ("protein_wavefront", "_lib"),
                    "wavefront-cuda-swar": ("protein_swar", "_swar_lib")}


def phase_protein_engine(n_orfs=2000):
    """The protein main path: taxator -b protein -l on bench.py's protein
    workload with wavefront-cuda, the plain wavefront backend and
    TAXTK_PROTEIN_SWAR=1; GFF3s and logs byte-identical; then the binner.
    The first run times each row-4 launch with CUDA events and keeps the
    inputs of its largest (LaunchCapture), the third does so for row 5.
    Returns the protein kernels' launch counts (v5 from the first run, v6
    from the third), the two captures, by kernel, and the first run's GFF3
    and -l log."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from bench_e2e import make_workload_protein

    from taxtk_torch.ops import protein_cuda as pc

    runs = {}
    launches = {}
    caps = {label: LaunchCapture(pc, "protein_inputs",
                                 keep_largest_wavefront, lib=lib)
            for label, (_, lib) in PROTEIN_CAPTURES.items()}
    ms = {}
    with tempfile.TemporaryDirectory() as d:
        t = time.time()
        aln, qfa, rfa, mapping, tax_dir, total_qaa = make_workload_protein(
            d, n_orfs)
        gen_s = time.time() - t
        os.environ["TAXATORTK_TAXONOMY_NCBI"] = tax_dir
        base = ["-b", "protein", "-g", mapping, "-q", qfa, "-f", rfa,
                "-i", rfa + ".fai"]
        for label, extra, swar in (("wavefront-cuda", [], False),
                                   ("wavefront", ["--protein-backend",
                                                  "wavefront"], False),
                                   ("wavefront-cuda-swar", [], True)):
            log = os.path.join(d, f"{label}.log")
            if swar:
                os.environ["TAXTK_PROTEIN_SWAR"] = "1"
            pc.protein_wavefront.launches = 0
            pc.protein_swar.launches = 0
            # row 4's launches in the default run and row 5's in the SWAR
            # run, timed and the largest kept (the wrappers' counts are
            # left alone)
            cap = caps.get(label)
            try:
                with cap.active() if cap else contextlib.nullcontext():
                    gff, secs, stats = run_cli(base + ["-l", log] + extra,
                                               aln)
            finally:
                os.environ.pop("TAXTK_PROTEIN_SWAR", None)
            if cap:
                ms[label] = cap.kernel_ms()
            counts = {"protein_wavefront": pc.protein_wavefront.launches,
                      "protein_swar": pc.protein_swar.launches}
            with open(log) as f:
                runs[label] = (gff, f.read(), secs, stats, counts)
        # the binner reads the same taxonomy dump
        bins = run_binner(runs["wavefront-cuda"][0])
    gff0, log0 = runs["wavefront-cuda"][:2]
    for label, (gff, log, *_rest) in runs.items():
        if gff != gff0:
            fail(f"protein GFF3 of {label} differs from wavefront-cuda")
        if log != log0:
            fail(f"protein -l log of {label} differs from wavefront-cuda")
    n_lines = gff0.count("\n")
    if not gff0.startswith("##gff-version 3\n") or n_lines < n_orfs // 2:
        fail(f"protein GFF3 has {n_lines} lines for {n_orfs} ORFs")
    if "+ALN" not in log0:
        fail("the protein -l log holds no alignment art")
    launches["protein_wavefront"] = runs["wavefront-cuda"][4][
        "protein_wavefront"]
    launches["protein_swar"] = runs["wavefront-cuda-swar"][4]["protein_swar"]
    for name, n in launches.items():
        if n <= 0:
            fail(f"the protein main path never launched {name}")
    for label, (name, _) in PROTEIN_CAPTURES.items():
        if caps[label].kept is None or len(ms[label]) != launches[name]:
            fail(f"the {label} protein run's {name} launches were not all "
                 "timed")
    if runs["wavefront"][4] != {"protein_wavefront": 0, "protein_swar": 0}:
        fail("the plain wavefront backend launched a kernel")
    rows = [ln for ln in bins.splitlines()
            if ln and not ln.startswith(("#", "@"))]
    if "\n@Version:" not in bins or not rows:
        fail("the binner wrote no bioboxes body")
    maa_h = lambda s: total_qaa / 1e6 / (s / 3600)  # noqa: E731
    rec = dict(orfs=n_orfs, query_aa=total_qaa, gff3_lines=n_lines,
               log_bytes=len(log0), workload_s=gen_s,
               gff3_and_logs_identical=True, bioboxes_rows=len(rows))
    for label, (_, _, secs, stats, counts) in runs.items():
        rec[label] = dict(engine_s=secs, maa_per_h=maa_h(secs),
                          launches=counts, stats=stats)
    for label, (name, _) in PROTEIN_CAPTURES.items():
        rec[label][f"{name}_ms"] = ms[label]
        rec[label][f"{name}_ms_sum"] = sum(ms[label])
    print(f"protein engine: {json.dumps(rec)}", flush=True)
    return launches, {name: caps[label].kept
                      for label, (name, _) in PROTEIN_CAPTURES.items()}, (
                          gff0, log0)


def phase_pipeline(n_contigs=300, n_orfs=2000):
    """taxtk-binning, the port's pipeline CLI (taxtk_torch.cli.pipeline.main
    in this process, on the card by default), with --alignments on the DNA
    engine phase's workload and with --protein --no-orf-calling on the
    protein engine phase's, each laid out as a refpack.  The reference
    bytes: run_binning_workflow on the same refpack with the host C++
    aligner (DNA) or the plain protein version (protein).  Every output
    file must be byte-identical, and the CLI run must launch the kernels
    of its path (counts set to 0 just before it, read just after)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from bench_e2e import make_workload, make_workload_protein
    from bench_torch import outdir_bytes, stage_seconds

    from taxtk_torch.cli import pipeline
    from taxtk_torch.engine.aligner import BatchAligner
    from taxtk_torch.ops.seqpool import reset_shared_pools
    from taxtk_torch.pipeline.workflows import run_binning_workflow

    wrappers = kernel_wrappers()

    def counted(run):
        """(run(), its wall seconds, its stage seconds, every kernel's
        launches in it), on a cold shared pool cache."""
        reset_shared_pools()
        for w in wrappers.values():
            w.launches = 0
        stages = {}
        with stage_seconds(stages):
            torch.cuda.synchronize()
            t = time.perf_counter()
            value = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        return value, secs, stages, {k: w.launches
                                     for k, w in wrappers.items()}

    def cli(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = pipeline.main(argv)
        if rc != 0:
            fail(f"taxtk-binning {' '.join(argv)} exited {rc}: "
                 f"{err.getvalue()}")
        return out.getvalue()

    rec = {}
    for label, make, n, protein, kernels, aligner in (
            ("dna", make_workload, n_contigs, False,
             ("myers_short", "myers_systolic"),
             lambda: BatchAligner("dna", dna_backend="native",
                                  device="cuda")),
            ("protein", make_workload_protein, n_orfs, True,
             ("protein_wavefront",),
             lambda: BatchAligner("protein", protein_backend="wavefront",
                                  device="cuda"))):
        with tempfile.TemporaryDirectory() as d:
            kw = dict(min_len=1000, max_len=20000) if not protein else {}
            aln, qfa, _, _, _, total = make(d, n, seed=7, **kw)
            os.symlink("tax", os.path.join(d, "ncbi-taxonomy"))
            ref_out, cli_out = os.path.join(d, "ref"), os.path.join(d, "cli")
            with contextlib.redirect_stderr(io.StringIO()):
                _, ref_s, ref_stages, ref_counts = counted(
                    lambda: run_binning_workflow(d, qfa, ref_out,
                                                 alignments_file=aln,
                                                 protein=protein,
                                                 aligner=aligner()))
            if any(ref_counts.values()):
                fail(f"the {label} pipeline's reference run launched a "
                     f"kernel: {ref_counts}")
            argv = [d, qfa, cli_out, "--alignments", aln]
            if protein:
                argv += ["--protein", "--no-orf-calling"]
            stdout, secs, stages, counts = counted(lambda: cli(argv))
            want, got = outdir_bytes(ref_out), outdir_bytes(cli_out)
        if sorted(got) != sorted(want):
            fail(f"the {label} pipeline wrote {sorted(got)}, the reference "
                 f"{sorted(want)}")
        for name in want:
            if got[name] != want[name]:
                fail(f"the {label} pipeline's {name} differs from the "
                     "reference run's")
        for name in kernels:
            if counts[name] <= 0:
                fail(f"the {label} pipeline never launched {name}")
        gff3_lines = got["sample.gff3"].count(b"\n")
        if (not got["sample.gff3"].startswith(b"##gff-version 3\n")
                or gff3_lines < (n if not protein else n // 2)):
            fail(f"the {label} pipeline's GFF3 has {gff3_lines} lines")
        binning_lines = sum(
            1 for ln in got["sample.binning"].splitlines()
            if ln and not ln.startswith((b"#", b"@")))
        if not stdout.startswith(f"Results are in '{cli_out}/'.") or \
                binning_lines == 0:
            fail(f"the {label} pipeline printed {stdout[:200]!r} and binned "
                 f"{binning_lines} rows")
        rate = total / 1e6 / (secs / 3600)
        rec[label] = {
            "queries": n, "query_" + ("aa" if protein else "bp"): total,
            "wall_s": secs, ("maa_per_h" if protein else "mbp_per_h"): rate,
            "stages_s": dict(stages, rest=secs - sum(stages.values())),
            "launches": counts, "gff3_lines": gff3_lines,
            "binning_lines": binning_lines, "files_identical": len(want),
            "reference_s": ref_s, "reference_stages_s": ref_stages}
    print(f"pipeline: {json.dumps(rec)}", flush=True)


def _resolved_sets(aln, mapping, tax):
    """The record sets taxator makes of an alignments file (its parser,
    taxonomy resolution and grouping, CLI defaults)."""
    from taxtk_torch.cli.taxator import _resolved_records
    from taxtk_torch.engine.recordsets import iter_record_sets
    from taxtk_torch.formats.mapping import load_seqid_taxid_mapping

    with open(aln) as f:
        return list(iter_record_sets(
            _resolved_records(f, load_seqid_taxid_mapping(mapping), tax),
            True, False))


@contextlib.contextmanager
def capture_engines():
    """Every RpaEngine run inside appends its engine to the list yielded,
    so that its metrics (stage seconds, unrounded) and stores can be read
    after the run."""
    from taxtk_torch.engine.executor import RpaEngine

    engines = []
    real = RpaEngine.run

    def run(self, *args, **kwargs):
        engines.append(self)
        return real(self, *args, **kwargs)

    with mock.patch.object(RpaEngine, "run", run):
        yield engines


@contextlib.contextmanager
def cell_launches(per_cell):
    """Each kernel's launches per grid cell, summed into per_cell["r,c"]:
    the wrappers' counts read around each cell's dispatch (cells are
    recognised by their pool caches, one per cell on a grid that names a
    device more than once)."""
    from taxtk_torch.engine.aligner import BatchAligner

    wrappers = kernel_wrappers()
    real = BatchAligner._dispatch_set

    def dispatch_set(self, pairs, work, dev_long, results, finishers,
                     device, pool_cache):
        before = {k: w.launches for k, w in wrappers.items()}
        out = real(self, pairs, work, dev_long, results, finishers, device,
                   pool_cache)
        cell = next((f"{r},{c}" for (r, c), p in self._pool_caches.items()
                     if p is pool_cache), "single")
        acc = per_cell.setdefault(cell, {})
        for k, w in wrappers.items():
            if w.launches > before[k]:
                acc[k] = acc.get(k, 0) + w.launches - before[k]
        return out

    with mock.patch.object(BatchAligner, "_dispatch_set", dispatch_set):
        yield per_cell


def _merge_matches_host(engine, rsets):
    """The pass-0 merge of one macro-batch against the host's reductions
    (the best record by dist asc, sim desc, score desc, index asc; the LCA
    of the co-optimal and of all nodes; the max support) on every live
    task; returns the number of live tasks."""
    from taxtk_torch.engine.executor import SegmentCache, drive_sync
    from taxtk_torch.models.rpa import RpaTask

    tax = engine.tax
    tasks = [RpaTask(tax, rs, engine.exclude_factor, engine.toppercent)
             for rs in rsets[:engine.macro_batch]]
    caches = [SegmentCache(t, engine.query_store, engine.db_store,
                           engine.protein) for t in tasks]
    pair_caches = [dict() for _ in tasks]
    drive_sync(engine._align_round(tasks, caches, pair_caches,
                                   [t.prepare() for t in tasks]))
    merged = engine._pass0_collective_merge(tasks, pair_caches)
    live = 0
    for ti, t in enumerate(tasks):
        if t.result is not None:
            continue
        live += 1
        dists, sims = t.pass0_table(pair_caches[ti])
        best = min(range(t.n), key=lambda i: (
            dists[i], -sims[i], -float(t.records[i].score), i))
        co = [t.records[i].reference_node for i in range(t.n)
              if dists[i] == dists[best] and sims[i] == sims[best]
              and t.records[i].score == t.records[best].score]
        m = merged[ti]
        got = (int(m["best_slot"]), float(m["best_dist"]),
               float(m["best_sim"]), int(m["rtax"]),
               int(m["lca_allnodes"]), int(m["support"]))
        want = (best, float(dists[best]), float(sims[best]),
                tax.lca_reduce(co),
                tax.lca_reduce([r.reference_node for r in t.records]),
                max(int(s) for s in sims))
        if got != want:
            fail(f"pass-0 merge of task {ti} ({t.qrseqname}): {got}, the "
                 f"host's {want}")
    if live == 0 or len(merged) != live:
        fail(f"the merge covered {len(merged)} of {live} live tasks")
    return live


def mesh_worker(workdir):
    """One process of the mesh phase's multi-host run (chip_smoke.py
    --mesh-worker DIR, TAXTK_COORDINATOR / TAXTK_NUM_PROCESSES /
    TAXTK_PROCESS_ID set): joins the gloo group, classifies its host shard
    of DIR's workload with myers-cuda, writes DIR/part.<rank>.gff3 and
    prints its launches and engine seconds."""
    import torch
    import torch.distributed as dist

    from taxtk_torch.constants import DEFAULT_RANKS
    from taxtk_torch.engine.executor import RpaEngine
    from taxtk_torch.parallel.distributed import host_shard, initialize
    from taxtk_torch.refpack.store import IndexedFastaStore, InMemoryFastaStore
    from taxtk_torch.taxonomy.flat import load_taxonomy_from_environment

    pid = initialize()
    n = int(os.environ["TAXTK_NUM_PROCESSES"])
    if (dist.get_rank(), dist.get_world_size()) != (pid, n):
        fail(f"rank {dist.get_rank()} of {dist.get_world_size()}")
    os.environ["TAXATORTK_TAXONOMY_NCBI"] = os.path.join(workdir, "tax")
    ranks = list(DEFAULT_RANKS)
    tax = load_taxonomy_from_environment(ranks).prune_to_marked_ranks(ranks)
    rsets = _resolved_sets(os.path.join(workdir, "sample.alignments"),
                           os.path.join(workdir, "mapping.tax"), tax)
    rfa = os.path.join(workdir, "refdata.fna")
    engine = RpaEngine(tax, InMemoryFastaStore(os.path.join(workdir,
                                                            "query.fna")),
                       IndexedFastaStore(rfa, rfa + ".fai"), device="cuda")
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = io.StringIO()
    t = time.perf_counter()
    engine.run(host_shard(iter(rsets), pid, n), out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "taxtk"))
    if bad:
        fail(f"the worker imported {bad[:5]}")
    with open(os.path.join(workdir, f"part.{pid}.gff3"), "w") as f:
        f.write(out.getvalue())
    print("mesh worker: " + json.dumps(dict(
        rank=pid, engine_s=secs, record_sets=engine.metrics.record_sets,
        launches={k: w.launches for k, w in wrappers.items()})), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_run(workdir, nprocs=2):
    """nprocs mesh workers on the card; returns their JSON records.  Every
    worker is waited for, and killed if it outlives its time."""
    port = _free_port()
    procs = []
    try:
        for pid in range(nprocs):
            env = dict(os.environ, TAXTK_COORDINATOR=f"127.0.0.1:{port}",
                       TAXTK_NUM_PROCESSES=str(nprocs),
                       TAXTK_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-worker",
                 workdir], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        recs = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                fail(f"mesh worker exited {p.returncode}: {err[-3000:]}")
            line = [ln for ln in out.splitlines()
                    if ln.startswith("mesh worker: ")]
            recs.append(json.loads(line[-1].split(": ", 1)[1]))
        return recs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _in_turns(run, want, label, kernels):
    """run(extra argv) -> (output, record), four times in turns: single
    device, --mesh 1x1, --mesh 1x1, single device.  Every output must
    equal `want` and every run launch `kernels`.  Returns the records of
    the single-device runs and of the 1x1 runs."""
    recs = {"single": [], "1x1": []}
    for kind in ("single", "1x1", "1x1", "single"):
        out, r = run(["--mesh", "1x1"] if kind == "1x1" else [])
        if out != want:
            fail(f"{label} {kind} output differs from the engine phase's")
        for name in kernels:
            if not r["launches"].get(name):
                fail(f"{label} {kind} never launched {name}")
        recs[kind].append(r)
    return recs["single"], recs["1x1"]


def bare_mesh_run(tax, aln, mapping, qfa, rfa, want):
    """RpaEngine with a bare dp mesh, two rows naming cuda:0: the aligner
    BatchAligner("dna", dna_backend="myers", mesh=Mesh([[cuda:0]] * 2))
    spreads its pairs over the rows' cells (_dispatch_mesh, the plain
    recurrence), with no engine backend attached.  Its GFF3 must equal
    `want` and both rows must have run pairs (each cell that does has a
    pool in the aligner's stats).  Every kernel's count is set to 0 just
    before and read just after: the myers backend runs the plain
    versions, so a launch is a fault.  Returns the step's record."""
    import torch

    from taxtk_torch.cli.taxator import _open_db_store, _open_store
    from taxtk_torch.engine.aligner import BatchAligner
    from taxtk_torch.engine.executor import RpaEngine
    from taxtk_torch.ops.seqpool import reset_shared_pools
    from taxtk_torch.parallel.mesh import Mesh

    reset_shared_pools()
    card = torch.device("cuda", 0)
    aligner = BatchAligner("dna", dna_backend="myers", device="cuda",
                           mesh=Mesh([[card]] * 2))
    engine = RpaEngine(tax, _open_store(qfa, None, None),
                       _open_db_store([rfa], [rfa + ".fai"], None),
                       aligner=aligner, device="cuda")
    rsets = _resolved_sets(aln, mapping, tax)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = io.StringIO()
    t = time.perf_counter()
    engine.run(iter(rsets), out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    print(f"mesh: bare 2x1 engine s: {secs}", flush=True)
    if out.getvalue() != want:
        fail("the bare mesh's GFF3 differs from the engine phase's")
    if launches:
        fail(f"the bare mesh's myers backend launched kernels {launches}")
    stats = aligner.stats()
    cells = sorted(stats.get("cell_pools", {}))
    if cells != ["0,0", "1,0"]:
        fail(f"the bare mesh ran pairs on cells {cells}, not on both rows")
    return dict(engine_s=secs, cells=stats["cell_pools"],
                stage_s=engine.metrics.stage_seconds, aligner=stats)


def phase_mesh(dna_gff3, protein_out, n_contigs=300, n_orfs=2000):
    """The dp x tp mesh on the card (see the module docstring), held
    against the engine phases' DNA GFF3 and protein (GFF3, -l log)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from bench_e2e import make_workload, make_workload_protein

    from taxtk_torch.cli import taxator
    from taxtk_torch.ops import dna_align
    from taxtk_torch.parallel import distributed, mesh

    wrappers = kernel_wrappers()
    rec = {}

    def counted_cli(argv, aln):
        """run_cli with every kernel's count set to 0 just before and read
        just after, and the run's engine."""
        for w in wrappers.values():
            w.launches = 0
        with capture_engines() as engines:
            gff, secs, stats = run_cli(argv, aln)
        counts = {k: w.launches for k, w in wrappers.items()
                  if w.launches}
        return gff, dict(engine_s=secs, merge_s=engines[-1].metrics
                         .stage_seconds.get("merge"),
                         stage_s=engines[-1].metrics.stage_seconds,
                         launches=counts, aligner=stats), engines[-1]

    cards = [torch.device("cuda", 0)]
    with tempfile.TemporaryDirectory() as d:
        aln, qfa, rfa, mapping, tax_dir, _ = make_workload(
            d, n_contigs, seed=7, min_len=1000, max_len=20000)
        os.environ["TAXATORTK_TAXONOMY_NCBI"] = tax_dir
        argv = ["-g", mapping, "-q", qfa, "-f", rfa, "-i", rfa + ".fai"]
        # 1. taxator --mesh 1x1 on the card, as a user runs it, in turns
        # with the single-device run (single, 1x1, 1x1, single)
        rec["dna_single"], rec["dna_1x1"] = _in_turns(
            lambda extra: counted_cli(argv + extra, aln)[:2],
            dna_gff3, "DNA", ("myers_short", "myers_systolic"))
        # 2. a 2x2 grid that names cuda:0 four times, through taxator's
        # own entry (its --mesh takes distinct cards only)
        grid = mesh.make_mesh(4, tp=2, devices=cards * 4)
        per_cell = {}
        with mock.patch.object(taxator, "_make_mesh",
                               lambda spec, device: grid), \
                cell_launches(per_cell):
            gff, rec["dna_2x2"], engine = counted_cli(
                argv + ["--mesh", "2x2"], aln)
        if gff != dna_gff3:
            fail("the 2x2 grid's GFF3 differs from the engine phase's")
        rec["dna_2x2"]["cell_launches"] = per_cell
        if len([c for c in per_cell if c != "single"]) < 2:
            fail(f"the 2x2 grid ran on cells {sorted(per_cell)}")
        rec["dna_2x2"]["merge_live_tasks"] = _merge_matches_host(
            engine, _resolved_sets(aln, mapping, engine.tax))
        # 3. dryrun_step on [cuda:0] * 2 at tp = 2, against the same step
        # with the plain wavefront on the card
        pair = mesh.make_mesh(2, tp=2, devices=cards * 2)
        wrappers["dna_wavefront"].launches = 0
        t = time.perf_counter()
        got = mesh.dryrun_step(pair, engine.tax.path, B=256, S=16, L=256)
        dry_s = time.perf_counter() - t
        dry_launches = wrappers["dna_wavefront"].launches
        with mock.patch.object(mesh, "batched_edit_distance_wavefront",
                               dna_align.batched_edit_distance):
            want = mesh.dryrun_step(pair, engine.tax.path, B=256, S=16,
                                    L=256)
        for g, w in zip(got[:3], want[:3]):
            if not np.array_equal(g, w):
                fail("dryrun_step differs from its plain version")
        if dry_launches != 2:
            fail(f"dryrun_step launched dna_wavefront {dry_launches} times")
        rec["dryrun"] = dict(shape=[256, 16, 256], seconds=dry_s,
                             launches=dry_launches)
        # 4. a bare dp mesh (no engine backend): the myers backend's pairs
        # spread over two rows naming cuda:0
        rec["dna_bare_2x1"] = bare_mesh_run(engine.tax, aln, mapping, qfa,
                                            rfa, dna_gff3)
        # 5. two gloo processes on the card, one host shard each
        recs = _gloo_run(d)
        parts = [os.path.join(d, f"part.{p}.gff3") for p in range(2)]
        merged, single = (os.path.join(d, x) for x in ("merged.gff3",
                                                       "single.gff3"))
        distributed.merge_gff3_parts(parts, merged)
        with open(single + ".in", "w") as f:
            f.write(dna_gff3)
        distributed.merge_gff3_parts([single + ".in"], single)
        with open(merged, "rb") as a, open(single, "rb") as b:
            if a.read() != b.read():
                fail("the two processes' merged GFF3 differs from the "
                     "single run's")
        for r in recs:
            if not r["launches"]["myers_short"]:
                fail(f"mesh worker {r['rank']} never launched myers_short")
        rec["gloo_2"] = recs
        # 6. real cards, where there are several
        k = torch.cuda.device_count()
        if k > 1:
            for spec in (f"{k}x1", f"1x{k}"):
                gff, rec[f"dna_{spec}"], _ = counted_cli(
                    argv + ["--mesh", spec], aln)
                if gff != dna_gff3:
                    fail(f"--mesh {spec} GFF3 differs from the engine "
                         "phase's")
        else:
            print("mesh: --mesh kx1 and 1xk over real cards not run: "
                  f"{k} card visible", flush=True)
    with tempfile.TemporaryDirectory() as d:
        aln, qfa, rfa, mapping, tax_dir, _ = make_workload_protein(d, n_orfs)
        os.environ["TAXATORTK_TAXONOMY_NCBI"] = tax_dir
        logs = iter(range(4))

        def protein_run(extra):
            log = os.path.join(d, f"mesh{next(logs)}.log")  # -l appends
            gff, run, _ = counted_cli(
                ["-b", "protein", "-g", mapping, "-q", qfa, "-f", rfa, "-i",
                 rfa + ".fai", "-l", log] + extra, aln)
            with open(log) as f:
                return (gff, f.read()), run

        rec["protein_single"], rec["protein_1x1"] = _in_turns(
            protein_run, protein_out, "protein -l",
            ("protein_wavefront",))
    print(f"mesh: {json.dumps(rec)}", flush=True)


# what each scale family of bench_torch.py (bench_scale) prints, after
# its name and "_"
SCALE_KEYS = (
    "contigs", "query_mbp", "wall_s", "mbp_per_hour", "gate_contigs",
    "gate_wall_s", "gate_native_wall_s", "gate_vs_native", "gate_files",
    "binned", "peak_rss_mb", "rss_before_mb", "peak_mem_mb", "stage_s",
    "aligner_s", "pairs", "host_long_pairs", "launches", "kernel2_launches",
    "pairs_per_launch", "gate_launches", "gate_kernel1_ms_sum",
    "gate_kernel1_bound_ms_sum", "pool", "protocol")
# the scale families bench_torch.py runs by default (config5_dense only
# when named)
SCALE_FAMILIES = ("config5", "config4_stream")
# what bench_torch.py's line must hold: each family's headline, spread and
# protocol (the config-4 family also its launch record and peak memory),
# and every key of the default scale families
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "protocol", "iqr_pct",
    "roofline_pct", "e2e_mbp_per_hour", "e2e_spread_pct",
    "e2e_cold_engine_s", "e2e_h2d_mb", "e2e_protocol",
    "e2e_config4_mbp_per_hour", "e2e_config4_spread_pct",
    "e2e_config4_launches", "e2e_config4_host_long_pairs",
    "e2e_config4_systolic_launches", "e2e_config4_peak_mem_mb",
    "e2e_config4_pool_resets", "e2e_config4_protocol",
    "protein_kernel_gcups", "protein_kernel_swar_gcups",
    "protein_vs_baseline", "protein_kernel_protocol",
    "protein_e2e_maa_per_hour", "protein_e2e_spread_pct",
    "protein_e2e_protocol", "card_name", "card_power_limit") + tuple(
        f"{fam}_{k}" for fam in SCALE_FAMILIES for k in SCALE_KEYS)


def phase_bench(timeout_s=800):
    """bench_torch.py in a subprocess, as a user runs it; prints its JSON
    line after checking that it holds BENCH_KEYS and no *_error field, and
    that each scale family's timed and gate runs launched Kernel 1."""
    t = time.time()
    try:
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        fail(f"bench_torch.py ran past {timeout_s} s")
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode != 0 or len(lines) != 1:
        fail(f"bench_torch.py exited {r.returncode}: {r.stderr[-3000:]}")
    rec = json.loads(lines[0])
    missing = [k for k in BENCH_KEYS if rec.get(k) is None]
    errors = [k for k in rec if k.endswith("_error")]
    if missing or errors:
        fail(f"bench_torch.py line lacks {missing} or has {errors}")
    for fam in SCALE_FAMILIES:
        for run in ("launches", "gate_launches"):
            if rec[f"{fam}_{run}"].get("myers_short", 0) <= 0:
                fail(f"bench_torch.py's {fam} ({run}) never launched "
                     "myers_short")
    print(f"bench: {lines[0]}", flush=True)
    print(f"bench: done in {time.time() - t:.1f} s", flush=True)


KERNELS = (
    ("myers_short", "taxtk_torch/csrc/myers_short.cu",
     "taxtk/ops/pallas_myers.py:121"),
    ("myers_systolic", "taxtk_torch/csrc/myers_systolic.cu",
     "taxtk/ops/pallas_myers_systolic.py:70"),
    ("myers_chunked", "taxtk_torch/csrc/myers_chunked.cu",
     "taxtk/ops/pallas_myers.py:253"),
    ("dna_wavefront", "taxtk_torch/csrc/dna_wavefront.cu",
     "taxtk/ops/pallas_dna.py:26"),
    ("protein_wavefront", "taxtk_torch/csrc/protein_wavefront.cu",
     "taxtk/ops/pallas_protein.py:105"),
    ("protein_swar", "taxtk_torch/csrc/protein_swar.cu",
     "taxtk/ops/pallas_protein.py:267"),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import taxtk_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the taxtk_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    name_power = phase_env()
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_rate = INT32_LANES * clock_mhz * 1e6
    phase_build()
    short, long_, chunked, wave = phase_kernels(int_rate)
    (launches, systolic_launch, wave_launch, short_launches,
     chunked_launches, dna_gff3) = phase_engine(int_rate)
    _check_chunked_engine(*chunked_launches, int_rate, 5, chunked)
    _check_short_engine(short_launches, int_rate, 5, short)
    _check_short_launches(short_launches, 5)
    _check_systolic_engine(systolic_launch, int_rate, 5, long_)
    # row 6 at the engine's own shape, its main shape: the inputs of the
    # wavefront-cuda run's largest launch
    B, L = wave_launch["host"][0].shape
    _check_wavefront(wave_launch["host"], f"engine {B}x{L}", int_rate, 5,
                     wave, first=True)
    prot = phase_protein(int_rate)
    phase_golden()
    prot_launches, prot_kept, protein_out = phase_protein_engine()
    launches.update(prot_launches)
    # rows 4 and 5 at the engine's own shapes, their main shapes: the
    # inputs of the largest launch of the wavefront-cuda protein run (row
    # 4) and of the SWAR run (row 5), on the pool cache
    for name, kept in prot_kept.items():
        B, L = kept["host"][0].shape
        _check_protein(kept["host"], f"engine {B}x{L}", int_rate, 5, prot,
                       names=(name,), layouts=("pool cache",), first=True,
                       by_nw=True)
    phase_pipeline()
    phase_mesh(dna_gff3, protein_out)
    phase_bench()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "taxtk"))
    if bad:
        fail(f"imported {bad[:5]}")
    kernels = []
    recs_of = dict(myers_short=short, myers_systolic=long_,
                   myers_chunked=chunked, dna_wavefront=wave, **prot)
    for name, source, replaces in KERNELS:
        recs = recs_of[name]
        main_rec = recs[0]  # the main-path shape
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
            bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
            library_ms=None, shape=main_rec["label"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2]))
    sys.exit(main())

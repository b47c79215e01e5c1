"""Batched alignment service: ragged pair lists -> bucketed device batches.

Port of taxtk/engine/aligner.py (BatchAligner).  The RPA executor hands
over every pair a macro-batch's alignment round needs.  In DNA mode the
aligner routes each pair by the length of its shorter side, exactly as
taxtk does:

  * <= 2048 bp: pow2 text-length buckets through the short Myers entry
    (ops/myers_cuda.py, Kernel 1);
  * above that, up to a 98,304 bp pattern and a 262,144 bp text: one
    length-sorted stream cut into 1024-pair chunks through the
    block-systolic entry (ops/myers_systolic.py, Kernel 2), or, for a
    chunk of at least `systolic_max_pairs` pairs (the oversized-round
    route; never at the default 1 << 30), through the pattern-block-
    chunked entry (ops/myers_chunked.py);
  * beyond the caps: the host C++ Myers on a thread, concurrently.

DNA backends: "myers-cuda" (the kernels; the default on the card),
"myers" (the kernels' plain PyTorch versions, on any device), "native"
(the host C++ Myers for every pair), "wavefront-cuda" (the min-plus
wavefront kernel of ops/dna_wavefront.py) and "wavefront" (its plain
version, ops/dna_align.py).  The two wavefront backends have no long
route: every pair goes to a square pow2 bucket of its longer side, as in
protein mode; wavefront-cuda sends each bucket class of a call to the
kernel in one launch (_run_wavefront_class).

In protein mode every pair with two non-empty sides goes to one square
pow2 bucket of its longer side, each capped at max_batch_cells // L^2
pairs.  Protein backends: "wavefront-cuda" (the BLOSUM62 wavefront
kernels of ops/protein_cuda.py, v5 or, with TAXTK_PROTEIN_SWAR=1, v6;
the default on the card) and "wavefront" (ops/protein_ref.py, the plain
recurrence; the default on the CPU).

On a dp x tp mesh (parallel/engine_mesh.py, attached by the engine as
`mesh_backend`), each pair runs on one cell of the grid: the tp column of
its reference's refpack shard and a dp row from a stable hash of its text
side, as in taxtk.  Each cell's pairs take the same dispatch as the
single-device route (_dispatch_set), on the cell's device and with the
cell's own pool cache.

A bare mesh (`BatchAligner(mesh=...)` with no engine backend attached)
spreads the "myers" backend's pairs over its grid the same way
(_dispatch_mesh, every pair in column 0).  It stands for taxtk's
`BatchAligner._myers_sharded` (taxtk/engine/aligner.py:727-765), which
splits each bucket into one contiguous slice a dp row; the distances are
the same, and here each cell's buckets run asynchronously with its own
pool, long pairs included.

There is no fallback: a kernel that cannot build or launch raises.
Distances are exact; float32 stats as in taxtk.
"""

from __future__ import annotations

import contextlib
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.rpa import AlignValue, f32
from ..ops.dna_align import batched_edit_distance, dna_alignment_stats
from ..ops.dna_wavefront import batched_edit_distance_wavefront
from ..ops.myers_chunked import batched_edit_distance_long
from ..ops.myers_cuda import MAX_K, batched_edit_distance_short
from ..ops.myers_systolic import batched_edit_distance_systolic
from ..ops.host import WORD
from ..ops.protein_cuda import batched_protein_align_cuda
from ..ops.protein_ref import batched_protein_align
from ..utils.errors import TaxtkError
from .metrics import span, where

DNA_BACKENDS = ("myers-cuda", "myers", "native", "wavefront-cuda",
                "wavefront")
MYERS_BACKENDS = ("myers-cuda", "myers")
PROTEIN_BACKENDS = ("wavefront-cuda", "wavefront")
# taxtk's names of its kernel routes, taken as names of the port's
BACKEND_ALIASES = {"myers-pallas": "myers-cuda",
                   "wavefront-pallas": "wavefront-cuda"}
# device caps of the long route (taxtk/ops/pallas_myers.py): patterns up
# to 96 kbp (96 systolic blocks, inside one 128-slot row) and texts up to
# 256 kbp stay on the device; beyond -> host C++
LONG_PATTERN_CAP = 98304
LONG_TEXT_CAP = 262144


def _pow2ceil(x: int, minimum: int = 16) -> int:
    n = minimum
    while n < x:
        n <<= 1
    return n


class _DevPending:
    """A dispatched device bucket: the result's host copy (started
    non-blocking at dispatch), the CUDA event recorded after it, post
    (host array -> values) and fill (values -> results).  The copy and
    the event go on the current stream of the result's own card, which
    need not be the current card (a mesh cell's)."""

    __slots__ = ("host", "event", "post", "fill")

    def __init__(self, dev: torch.Tensor, post, fill):
        self.event = None
        if dev.device.type == "cuda":
            with span("entry.readback"), torch.cuda.device(dev.device):
                stream = torch.cuda.current_stream(dev.device)
                self.host = torch.empty(dev.shape, dtype=dev.dtype,
                                        pin_memory=True)
                with torch.cuda.stream(stream):
                    self.host.copy_(dev, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record(stream)
        else:
            self.host = dev
        self.post = post
        self.fill = fill

    def wait(self):
        if self.event is not None:
            self.event.synchronize()

    def run(self):
        self.fill(self.post(self.host.numpy()))


class BatchAligner:
    """mode: "dna" (edit distance + the reference's approximate stats) or
    "protein" (BLOSUM62 global alignment + traceback stats).

    dna_backend: "myers-cuda" | "myers" | "native" | "wavefront-cuda" |
    "wavefront" (default: myers-cuda on a CUDA device, myers on the CPU).
    protein_backend: "wavefront-cuda" | "wavefront" (default:
    wavefront-cuda on a CUDA device, wavefront on the CPU).  taxtk's
    "myers-pallas" and "wavefront-pallas" name the kernel routes,
    "myers-cuda" and "wavefront-cuda".  device:
    "cuda" (default) or "cpu".

    mesh: an optional parallel/mesh.py Mesh.  With no engine backend
    attached (RpaEngine attaches one when it is given the mesh), a
    "myers" DNA aligner spreads its pairs over the mesh's dp rows, as
    taxtk's does; every other backend and a protein aligner ignore it.
    """

    # align_pairs(deferred=True) returns a finish() callable (the engine's
    # macro-batch pipeline feature-detects this attribute)
    supports_deferred = True

    def __init__(
        self,
        mode: str = "dna",
        max_batch_cells: int = 1 << 28,
        dna_backend: str | None = None,
        protein_backend: str | None = None,
        device="cuda",
        mesh=None,
    ):
        if mode not in ("dna", "protein"):
            raise TaxtkError(f"unknown aligner mode {mode!r}; dna or protein")
        self.mode = mode
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        self.dna_backend = BACKEND_ALIASES.get(dna_backend, dna_backend) or (
            "myers-cuda" if on_card else "myers")
        self.protein_backend = BACKEND_ALIASES.get(
            protein_backend, protein_backend) or (
            "wavefront-cuda" if on_card else "wavefront")
        for kind, name, known in (("dna", self.dna_backend, DNA_BACKENDS),
                                  ("protein", self.protein_backend,
                                   PROTEIN_BACKENDS)):
            if name not in known:
                raise TaxtkError(
                    f"unknown {kind} backend {name!r}; one of "
                    f"{', '.join(known)}"
                )
        # cap on batch * M * N cells per launch (bucket pair counts)
        self.max_batch_cells = max_batch_cells
        # shorter sides above this leave the short buckets for the
        # systolic stream: the short kernel's K <= 64 words (2048 bp)
        self.long_pattern_threshold = MAX_K * WORD
        self.tpu_long_pattern_cap = LONG_PATTERN_CAP
        self.tpu_long_text_cap = LONG_TEXT_CAP
        # long chunks of at least this many pairs take the chunked entry
        # instead of the systolic one (taxtk's oversized-round route)
        self.systolic_max_pairs = 1 << 30
        self.pairs_aligned = 0
        self.cells_computed = 0
        # pairs sent to the host C++ Myers (every pair on "native")
        self.host_long_pairs = 0
        # per-phase seconds (kernel vs staging): the sums of the aligner.*
        # spans of the same names (_stage)
        self.stage_seconds = {}
        # cross-round device-resident sequence pool (ops/seqpool.py),
        # shared by every aligner on this device
        self.pool_cache = None
        if (self.dna_backend in MYERS_BACKENDS if mode == "dna"
                else self.protein_backend == "wavefront-cuda"):
            from ..ops.seqpool import shared_pool_cache

            self.pool_cache = shared_pool_cache(self.device)
        self._plain = self.dna_backend == "myers"
        # dp x tp engine backend (parallel/engine_mesh.py), set by RpaEngine
        # when a mesh is in play: each pair then runs on its grid cell
        self.mesh_backend = None
        self._pool_caches: Dict[Tuple[int, int], object] = {}  # per cell
        self.mesh = mesh  # a bare mesh; see _grid

    def stats(self) -> dict:
        """Counters of this aligner and of its device pool (for --stats)."""
        out = dict(pairs=self.pairs_aligned, cells=self.cells_computed,
                   host_long_pairs=self.host_long_pairs,
                   stage_seconds=dict(self.stage_seconds))
        if self.pool_cache is not None:
            c = self.pool_cache
            out["pool"] = dict(hits=c.hits, misses=c.misses,
                               bytes_shipped=c.bytes_shipped, resets=c.resets)
        if self._pool_caches:
            out["cell_pools"] = {
                f"{r},{c}": dict(hits=p.hits, misses=p.misses,
                                 bytes_shipped=p.bytes_shipped,
                                 resets=p.resets)
                for (r, c), p in sorted(self._pool_caches.items())}
        return out

    def _grid(self):
        """The [dp][tp] devices the pairs spread over, or None: the engine
        backend's mesh, else a bare mesh for the "myers" DNA backend
        (taxtk aligner.py:630-640 shards only its XLA myers backend over a
        bare mesh)."""
        if self.mesh_backend is not None:
            return self.mesh_backend.mesh.devices
        if (self.mesh is not None and self.mode == "dna"
                and self.dna_backend == "myers"):
            return self.mesh.devices
        return None

    def _stage(self, name, count=None, **ctx):
        """Span aligner.<name>, summed into stage_seconds[name]."""
        return span("aligner." + name, self.stage_seconds, name, count=count,
                    **ctx)

    def _run_host_long(self, pairs, idxs, results):
        # cells_computed for these pairs is counted by the caller before
        # the thread starts (a shared counter updated here would race)
        from ..native import myers_batch

        dists = myers_batch([pairs[k] for k in idxs])
        for k, d in zip(idxs, dists):
            a, b = pairs[k]
            dist = int(d)
            lendiff = abs(len(a) - len(b))
            matches = min(len(a), len(b)) - (dist - lendiff)
            results[k] = AlignValue(distance=f32(dist), similarity=f32(matches))

    def align_pairs(
        self,
        pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
        shard_ids: Optional[Sequence[int]] = None,
        deferred: bool = False,
    ) -> List[AlignValue]:
        """pairs: list of (a_codes, b_codes) uint8 arrays.

        shard_ids: the tp column of each pair (the refpack shard owning its
        reference segment); read only with a mesh (_grid), where None puts
        every pair in column 0.

        deferred=True dispatches all device work and returns a zero-arg
        finish() callable that blocks on the readbacks and returns the
        results list (the macro-batch pipeline overlaps that wait with
        another batch's host replay)."""
        results: List[AlignValue] = [None] * len(pairs)  # type: ignore
        # the round these pairs belong to, named by the spans that other
        # threads open on its behalf
        ctx = where()

        with span("aligner.route", count=len(pairs)):
            dna = self.mode == "dna"
            native_all = dna and self.dna_backend == "native"
            myers = dna and self.dna_backend in MYERS_BACKENDS
            work: List[int] = []
            dev_long: List[int] = []
            host_long: List[int] = []
            for k, (a, b) in enumerate(pairs):
                if len(a) == 0 or len(b) == 0:
                    results[k] = self._empty_pair(len(a), len(b))
                elif native_all:
                    host_long.append(k)
                elif (myers and min(len(a), len(b))
                      > self.long_pattern_threshold):
                    if (
                        min(len(a), len(b)) <= self.tpu_long_pattern_cap
                        and max(len(a), len(b)) <= self.tpu_long_text_cap
                    ):
                        dev_long.append(k)
                    else:
                        host_long.append(k)
                else:
                    work.append(k)

        host_thread = None
        if host_long:
            # the C++ batch releases the GIL and work-steals across cores,
            # so host alignment hides behind the device buckets
            for k in host_long:
                a, b = pairs[k]
                self.cells_computed += len(a) * len(b)
            self.host_long_pairs += len(host_long)
            host_error: List[BaseException] = []

            def _host_work():
                with self._stage("host_long", len(host_long), **ctx):
                    try:
                        self._run_host_long(pairs, host_long, results)
                    except BaseException as e:  # re-raised by finish()
                        host_error.append(e)

            host_thread = threading.Thread(target=_host_work,
                                           name="taxtk-host-long")
            host_thread.start()

        # dispatch every bucket before blocking on any readback: kernels
        # queue on the stream and each D2H copy starts behind its kernel
        finishers: List[_DevPending] = []
        grid = self._grid()
        if grid is not None:
            if shard_ids is None:  # tp = 1: every pair in column 0
                shard_ids = [0] * len(pairs)
            self._dispatch_mesh(grid, pairs, work, dev_long, shard_ids,
                                results, finishers)
        else:
            self._dispatch_set(pairs, work, dev_long, results, finishers,
                               self.device, self.pool_cache)

        def finish():
            with self._stage("device_wait", **ctx):
                for f in finishers:
                    f.wait()
            with self._stage("collect", **ctx):
                for f in finishers:
                    f.run()
            if host_thread is not None:
                # host_long_wait: how long the host C++ outlasted the
                # device buckets (0 when the card set the pace)
                with self._stage("host_long_wait", **ctx):
                    host_thread.join()
                if host_error:
                    raise host_error[0]
            self.pairs_aligned += len(pairs)
            return results

        if deferred:
            return finish
        return finish()

    def _dispatch_set(self, pairs, work, dev_long, results, finishers,
                      device, pool_cache):
        """Dispatch one device's pairs: the long ones as one sorted stream
        (_dispatch_long), the rest through the shape buckets, on `device`
        with `pool_cache`."""
        if dev_long:
            self._dispatch_long(pairs, dev_long, results, finishers, device,
                                pool_cache)
        self._dispatch_buckets(pairs, work, results, finishers, device,
                               pool_cache)

    def _dispatch_mesh(self, grid, pairs, work, dev_long, shard_ids,
                       results, finishers):
        """Partition the pairs over the [dp][tp] `grid` and run
        _dispatch_set per cell (taxtk aligner.py:390-429).  The tp column
        is the pair's refpack shard; the dp row a stable content hash of
        its text side (the longer), so a segment's pass-1/2 re-alignments
        land on the cell whose pool already holds it; _balance_dp_rows
        then bounds the skew.  A CUDA cell dispatches with its card as the
        current one."""
        dp, tp = len(grid), len(grid[0])

        def dp_row(k):
            if dp == 1:
                return 0
            a, b = pairs[k]
            t = b if len(b) >= len(a) else a
            key = b"%d:%s:%s" % (len(t), t[:16].tobytes(), t[-16:].tobytes())
            return zlib.crc32(key) % dp

        per_cell: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {}
        for lst, slot in ((work, 0), (dev_long, 1)):
            for k in lst:
                c = shard_ids[k]
                per_cell.setdefault((dp_row(k), c), ([], []))[slot].append(k)
        if dp > 1:
            self._balance_dp_rows(per_cell, dp, tp)
        for (r, c) in sorted(per_cell):
            w, dl = per_cell[(r, c)]
            dev = resolve_device(grid[r][c])
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                self._dispatch_set(pairs, w, dl, results, finishers, dev,
                                   self._device_pool(r, c))

    @staticmethod
    def _balance_dp_rows(per_dev, dp, tp):
        """Cap per-row load within each tp column at fair share + half a
        fair share and spill the overflow to the least-loaded rows
        (deterministic order).  The content-stable dp_row routing keeps
        segments pool-resident, but a workload where one segment is the
        text of many pairs would land the whole set on one row and idle
        the others; spilling only the overflow fraction bounds the
        imbalance while keeping locality for everything under the cap.
        (cap = 1.5x fair share, NOT 2x: at dp=2 a fully skewed column is
        exactly 2x fair share, so a 2x cap never binds there — round-4
        advisor finding.)  Copy of taxtk's."""
        for c in range(tp):
            rows = {r: per_dev.get((r, c)) for r in range(dp)}
            loads = {
                r: (len(v[0]) + len(v[1])) if v else 0
                for r, v in rows.items()
            }
            total = sum(loads.values())
            if not total:
                continue
            fair = -(-total // dp)
            # floor of 2: moving a lone pair off a 2-pair row buys nothing
            # (launch overhead dominates) and would unsettle pool locality
            cap = max(2, fair + total // (2 * dp))
            spill: List[Tuple[int, int]] = []  # (k, slot)
            for r in sorted(rows):
                v = rows[r]
                if v is None or loads[r] <= cap:
                    continue
                excess = loads[r] - cap
                # drain short-bucket work (slot 0) before long pairs,
                # taking from each list's tail (keeps the head — oldest,
                # most likely pool-resident — in place)
                for slot in (0, 1):
                    while excess and v[slot]:
                        spill.append((v[slot].pop(), slot))
                        excess -= 1
                        loads[r] -= 1
                    if not excess:
                        break
            for k, slot in spill:
                r = min(sorted(loads), key=lambda x: loads[x])
                per_dev.setdefault((r, c), ([], []))[slot].append(k)
                loads[r] += 1

    def _device_pool(self, r, c):
        """The pool cache of grid cell (r, c), or None where the backend
        has no pool.  A device that appears once in the grid uses its
        process-wide cache (taxtk's per-device cache, shared with
        single-device runs); a device the grid names more than once gives
        each of its cells a cache of its own."""
        if self.pool_cache is None:
            return None
        p = self._pool_caches.get((r, c))
        if p is None:
            from ..ops.seqpool import shared_pool_cache

            grid = self._grid()
            dev = grid[r][c]
            repeats = sum(d == dev for row in grid for d in row) > 1
            p = self._pool_caches[(r, c)] = shared_pool_cache(
                dev, key=(r, c) if repeats else None)
        return p

    def _dispatch_buckets(self, pairs, work, results, finishers, device,
                          pool_cache):
        if self.mode == "protein" or self.dna_backend not in MYERS_BACKENDS:
            # protein and the DNA wavefront backends: one square bucket
            # per pow2 of the longer side
            buckets = {}
            for k in work:
                a, b = pairs[k]
                buckets.setdefault(_pow2ceil(max(len(a), len(b))), []).append(k)
            for L, idxs in buckets.items():
                max_pairs = max(1, self.max_batch_cells // (L * L))
                if self.mode == "dna" and self.dna_backend == "wavefront-cuda":
                    self._run_wavefront_class(pairs, idxs, L, max_pairs,
                                              results, finishers, device)
                    continue
                for off in range(0, len(idxs), max_pairs):
                    self._run_bucket(pairs, idxs[off : off + max_pairs], L, L,
                                     results, finishers, device, pool_cache)
            return
        # Myers cost is pairs x text x ceil(pattern/32): only the text
        # length needs bucketing; everything else pads internally
        buckets = {}
        for k in work:
            a, b = pairs[k]
            buckets.setdefault(_pow2ceil(max(len(a), len(b))), []).append(k)
        for N, idxs in buckets.items():
            # floor at one 1024-pair tile, cap at the 8192-pair group
            max_pairs = min(
                8192, max(1024, self.max_batch_cells // max(1, (N * N) // 32))
            )
            for off in range(0, len(idxs), max_pairs):
                self._run_bucket(pairs, idxs[off : off + max_pairs], N, N,
                                 results, finishers, device, pool_cache)

    def _dispatch_long(self, pairs, idxs_all, results, finishers, device,
                       pool_cache):
        """Long pairs through the block-systolic kernel: ONE stream sorted
        by text length (descending) and cut into 1024-pair chunks, so each
        launch holds pairs of similar lengths.  A chunk of at least
        systolic_max_pairs pairs takes the chunked entry instead."""
        idxs = sorted(
            idxs_all,
            key=lambda k: -max(len(pairs[k][0]), len(pairs[k][1])),
        )
        for off in range(0, len(idxs), 1024):
            chunk = idxs[off : off + 1024]
            B = len(chunk)
            with self._stage("stage_batch", B):
                maxa = max(len(pairs[k][0]) for k in chunk)
                maxb = max(len(pairs[k][1]) for k in chunk)
                a_codes = np.zeros((B, maxa), np.uint8)
                b_codes = np.zeros((B, maxb), np.uint8)
                a_len = np.zeros(B, np.int32)
                b_len = np.zeros(B, np.int32)
                for r, k in enumerate(chunk):
                    a, b = pairs[k]
                    a_codes[r, : len(a)] = a
                    b_codes[r, : len(b)] = b
                    a_len[r] = len(a)
                    b_len[r] = len(b)
                self.cells_computed += int(
                    (a_len.astype(np.int64) * b_len).sum())

            def fill_long(dist, chunk=chunk, a_len=a_len, b_len=b_len):
                for r, k in enumerate(chunk):
                    d = int(dist[r])
                    lendiff = abs(int(a_len[r]) - int(b_len[r]))
                    matches = min(int(a_len[r]), int(b_len[r])) - (d - lendiff)
                    results[k] = AlignValue(
                        distance=f32(d), similarity=f32(matches)
                    )

            entry = (batched_edit_distance_systolic
                     if B < self.systolic_max_pairs
                     else batched_edit_distance_long)
            with self._stage("device", B):
                dev, post = entry(
                    a_codes, b_codes, a_len, b_len, device=device,
                    lazy="device", pool_cache=pool_cache, plain=self._plain,
                )
                finishers.append(_DevPending(dev, post, fill_long))

    def _run_wavefront_class(self, pairs, idxs, L, sub_pairs, results,
                             finishers, device):
        """One pow2 class of the wavefront-cuda backend: its pairs go to the
        min-plus kernel in one launch, without dummy rows, up to the
        kernel's own device memory (B x (L + 1) scratch cells <=
        max_batch_cells; its footprint is O(B * L), so taxtk's L^2 cap has
        no reason here).  cells_computed counts as taxtk's sub-buckets of
        sub_pairs pairs do, their dummy 1 x 1 rows included."""
        for off in range(0, len(idxs), sub_pairs):
            B = min(sub_pairs, len(idxs) - off)
            self.cells_computed += _pow2ceil(B, minimum=8) - B
        launch_pairs = max(1, self.max_batch_cells // (L + 1))
        for off in range(0, len(idxs), launch_pairs):
            self._run_bucket(pairs, idxs[off : off + launch_pairs], L, L,
                             results, finishers, device, None,
                             dummy_rows=False)

    def _run_bucket(self, pairs, idxs, M, N, results, finishers, device,
                    pool_cache, dummy_rows=True):
        B = len(idxs)
        with self._stage("stage_batch", B):
            Bpad = _pow2ceil(B, minimum=8) if dummy_rows else B
            a_codes = np.zeros((Bpad, M), dtype=np.uint8)
            b_codes = np.zeros((Bpad, N), dtype=np.uint8)
            a_len = np.zeros(Bpad, dtype=np.int32)
            b_len = np.zeros(Bpad, dtype=np.int32)
            for r, k in enumerate(idxs):
                a, b = pairs[k]
                a_codes[r, : len(a)] = a
                b_codes[r, : len(b)] = b
                a_len[r] = len(a)
                b_len[r] = len(b)
            a_len[B:] = 1  # dummy rows
            b_len[B:] = 1
            self.cells_computed += int((a_len * b_len).sum())
        if self.mode == "protein":
            def fill_protein(out, idxs=idxs):
                dist = out["distance"]  # already float32 (post() math)
                sim = out["similarity"]
                for r, k in enumerate(idxs):
                    results[k] = AlignValue(dist[r], sim[r])

            with self._stage("device", B):
                if self.protein_backend == "wavefront-cuda":
                    dev, post = batched_protein_align_cuda(
                        a_codes, b_codes, a_len, b_len, device=device,
                        lazy="device", pool_cache=pool_cache,
                    )
                else:
                    dev, post = batched_protein_align(
                        a_codes, b_codes, a_len, b_len, device=device,
                        lazy="device",
                    )
                finishers.append(_DevPending(dev, post, fill_protein))
            return

        def fill_dna(dist, idxs=idxs, a_len=a_len, b_len=b_len):
            # float32 arrays, so each value is an np.float32
            stats = dna_alignment_stats(dist, a_len, b_len)
            dist32, matches32 = stats["distance"], stats["similarity"]
            for r, k in enumerate(idxs):
                results[k] = AlignValue(dist32[r], matches32[r])

        with self._stage("device", B):
            if self.dna_backend == "wavefront-cuda":
                dev, post = batched_edit_distance_wavefront(
                    a_codes, b_codes, a_len, b_len, device=device,
                    lazy="device")
            elif self.dna_backend == "wavefront":
                dev, post = batched_edit_distance(
                    a_codes, b_codes, a_len, b_len, device=device,
                    lazy="device")
            else:
                dev, post = batched_edit_distance_short(
                    a_codes, b_codes, a_len, b_len, device=device,
                    lazy="device", pool_cache=pool_cache, plain=self._plain,
                )
            finishers.append(_DevPending(dev, post, fill_dna))

    def _empty_pair(self, la: int, lb: int) -> AlignValue:
        if self.mode == "dna":
            return AlignValue(distance=f32(max(la, lb)), similarity=f32(0))
        # protein with an empty side: all-gap alignment
        return AlignValue(distance=f32(0.0), similarity=f32(0.0))

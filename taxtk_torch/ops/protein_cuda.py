"""Protein entry: the BLOSUM62 wavefront kernels and their plain version.

Mirrors taxtk/ops/pallas_protein.py::batched_protein_align_pallas
(:627-769).  Per pair it computes the global linear-gap (-1) BLOSUM62
score and the match and diagonal-step counts of the SeqAn-preferred
optimal path (diagonal > consume-B > consume-A), packed as dc << 16 |
matches, plus the per-pair BLOSUM self-scores; `post` turns them into the
reference's float32 distance and similarity.

Both layouts read the pair's codes from a sequence pool (bits=8: one raw
code per byte, 0xFF beyond each row's length): the resident
DevicePoolCache (the main path) or, without a cache, a one-off pool of the
round's deduped rows.  Two kernels compute the same function:

  * `protein_wavefront` (csrc/protein_wavefront.cu) replaces the v5 kernel
    `_make_kernel` (:105): a block per pair, its 32-row strips on a band
    of warps (`kernel_geometry` sets out the launch);
  * `protein_swar` (csrc/protein_swar.cu) replaces the v6 SWAR kernel
    `_make_kernel_swar` (:267): two pairs per 32-bit word as 16-bit
    halves, a block per pair of pairs, their 32-row strips on a band of
    warps (`kernel_geometry` with swar).  The entry takes it when
    TAXTK_PROTEIN_SWAR=1 (or swar=True) and the bucket lies in v6's
    domain (`_swar_fits`).

On CUDA tensors each wrapper launches its kernel and counts the launch;
on CPU tensors it runs `protein_plain`, the recurrence of
ops/protein_ref.py under the v5 substitution table.  The tables are the
carried-over parameters: `_PACKED` and `_DIAG` are copies of taxtk's, and
the kernels' 32 x 32 table is unpacked from `_PACKED`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..device import resolve_device
from . import cuda_build
from .blosum import BLOSUM62, GAP_SCORE
from .host import _dedupe_pool, _pack_text_pool, _pow2
from .protein_ref import nw_stats
from .transfer import h2d

_AA_N = BLOSUM62.shape[0]
_BIAS = 4  # BLOSUM62 min is -4 -> nibble range [0, 15]
_CODES = 32  # 5-bit clamped code space: 27 residues + sentinel slots
_NWORDS = _CODES // 8  # 4 int32 words hold 32 nibbles
LANE = 128
# row 4's geometry (csrc/protein_wavefront.cu): warps per band, at most
# MAX_WARPS.  chip_smoke.py times nw = 4, 8 and 16 (ms_by_nw; on an NVIDIA
# H100 80GB HBM3 at 700 W): 8 and 4 tie at L = 256 and 512, where 16 is
# 8-30% slower (a band's 64-step lag per warp outweighs the bands it
# saves); at L = 2048, 16 is 1.35x faster than 8.
MAX_WARPS = 16
BAND_WARPS = 8
TALL_BAND_WARPS = 16  # for buckets of more than TALL_ROWS rows
TALL_ROWS = 1024
# row 5's warps per band (csrc/protein_swar.cu; kernel_geometry with
# swar): one per SWAR_ROWS rows of the bucket, TALL_BAND_WARPS above
# SWAR_TALL_ROWS.  chip_smoke.py times nw = 2, 4, 8 and 16 (ms_by_nw; on
# an NVIDIA H100 80GB HBM3 at 700 W): 2 is the fastest at L = 256 (the
# engine's largest launch), 4 at L = 512 and 16 at L = 1024, v6's
# tallest bucket
SWAR_ROWS = 128
SWAR_TALL_ROWS = 512
# the shared protein pool height class: one class serves every ORF-scale
# bucket, taller buckets get their own pow2 class (pallas_protein.py:624)
_POOL_HC_FLOOR = 1024


def _round_up(x, m):
    return -(-x // m) * m


def _shapes(M, N):
    """v5's derived extents of an (M, N) bucket (pallas_protein.py:223,
    without its pair tiling): pattern lanes Mp, last anti-diagonal
    steps_end and text window fwd_w.  They fix the pool height class and
    the SWAR domain and bias."""
    Mp = _round_up(max(M, 1), LANE)
    steps_end = Mp + max(N, 1)
    fwd_w = _round_up(steps_end, 128)
    return Mp, steps_end, fwd_w


def _swar_fits(Mp: int, steps_end: int) -> bool:
    return (steps_end + 8) + 11 * Mp < (1 << 14)


# nibble-packed BLOSUM column table over the 5-bit clamped code space:
# _PACKED[w, a] = int32 packing (BLOSUM62[a, 8w+j] + 4) << 4j for j in
# 0..7; sentinel rows/columns (codes >= 27) pack nibble 0 (score -4)
def _packed_table():
    tbl = np.zeros((_NWORDS, _CODES), np.int64)
    for a in range(_AA_N):
        for c in range(_AA_N):
            tbl[c // 8, a] |= (int(BLOSUM62[a, c]) + _BIAS) << (4 * (c % 8))
    return tbl.astype(np.uint32).view(np.int32).reshape(_NWORDS, _CODES)


_PACKED = _packed_table()
_DIAG = np.ascontiguousarray(np.diag(BLOSUM62)).astype(np.int32)


def _sub_table():
    """SUB[a, c]: the v5 kernel's score of codes a, c (its nibble
    extraction from _PACKED), -4 wherever either code is a sentinel."""
    words = _PACKED.view(np.uint32)  # [NWORDS, CODES]
    c = np.arange(_CODES)
    nib = (words[c // 8, :].T >> (4 * (c % 8))[None, :].astype(np.uint32)) & 15
    return nib.astype(np.int32) - _BIAS


SUB = _sub_table()
MATCH = np.eye(_CODES, dtype=bool)  # v5: clamped codes equal


def _codes(pool, cols, n):
    """[len(cols), n] int64 codes at positions < n of the bits=8 pool
    columns `cols`, clamped to the 5-bit code space."""
    got = pool[:n].index_select(1, cols.long()).to(torch.int64) & 0xFF
    return got.clamp_(max=_CODES - 1).T


def protein_plain(pool, a_col, b_col, alen, blen, M, N):
    """Plain version of both kernels: int32 [2, B] of mutual score and
    packed stats dc << 16 | matches (wrapping as v5's carry does)."""
    st = nw_stats(_codes(pool, a_col, max(M, 1)), _codes(pool, b_col, max(N, 1)),
                  alen, blen, SUB, MATCH).to(torch.int64)
    madc = ((st[2] << 16) + st[1]) & 0xFFFFFFFF
    madc = torch.where(madc >= 1 << 31, madc - (1 << 32), madc)
    return torch.stack([st[0], madc]).to(torch.int32)


_TABLES: dict = {}


def _sub_on(device) -> torch.Tensor:
    t = _TABLES.get(device)
    if t is None:
        t = _TABLES[device] = torch.from_numpy(SUB.reshape(-1).copy()).to(
            device)
    return t


def _check_args(name, pool, a_col, b_col, alen, blen, M, N):
    B = a_col.shape[0]
    for arg, t in (("a_col", a_col), ("b_col", b_col), ("alen", alen),
                   ("blen", blen)):
        if (t.device != pool.device or t.dtype != torch.int32
                or t.shape != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name}: bad {arg}")
    if (pool.dtype != torch.int8 or pool.dim() != 2 or pool.stride(1) != 1
            or pool.shape[0] < max(M, N)):
        raise ValueError(f"{name}: bad pool")


def _bind(name, n_extra):
    """csrc/<name>.cu's C entry taxtk_<name>, its argument types set;
    n_extra: its trailing int arguments."""
    fn = getattr(cuda_build.load(name), "taxtk_" + name)
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, L] + [P] * 7 + [I, I] + [I] * n_extra + [P]
        fn.restype = ctypes.c_int
    return fn


def _lib():
    """Row 4's C entry (v5)."""
    return _bind("protein_wavefront", 1)


def _swar_lib():
    """Row 5's C entry (v6)."""
    return _bind("protein_swar", 2)


def kernel_geometry(B, M, N, nw=None, swar=False):
    """(nw, bands) of a row-4 launch (row 5's with swar) on a [B, M] x
    [B, N] bucket, from its shape alone; nw may be forced (chip_smoke.py
    times several).

    Row 4 has one block per pair, row 5 one per pair of pairs (pair p in
    the low halves, pair p + ceil(B/2) in the high halves, the block's m
    the larger of their a lengths).  A block's rows (a, never transposed)
    are strips of 32, one warp each, a row a lane (in both halves); a band
    is nw consecutive strips run concurrently, and the bands run in turn:
    band k's warp w takes rows 32 * (k * nw + w) + 1 .. + 32, and the
    band's warps are the first min(nw, strips - k * nw).  nw is
    BAND_WARPS (TALL_BAND_WARPS above TALL_ROWS rows), or for row 5 one
    warp per SWAR_ROWS rows, at least 1 (TALL_BAND_WARPS above
    SWAR_TALL_ROWS rows); in either case at most the strips a pair can
    have.  bands is the most bands a block can have (the wrapper
    allocates the DP row between bands only where it exceeds 1)."""
    strips = -(-max(M, 1) // 32)
    if nw is None:
        if swar:
            nw = (TALL_BAND_WARPS if M > SWAR_TALL_ROWS
                  else max(M // SWAR_ROWS, 1))
        else:
            nw = TALL_BAND_WARPS if M > TALL_ROWS else BAND_WARPS
        nw = min(nw, strips)
    elif not 1 <= nw <= MAX_WARPS:
        name = "protein_swar" if swar else "protein_wavefront"
        raise ValueError(f"{name}: nw={nw} outside [1, {MAX_WARPS}]")
    return nw, -(-strips // nw)


def _launch(fn, name, out, scratch, pool, a_col, b_col, alen, blen, N,
            *extra):
    """Launch C entry `fn` on the current stream of the pool's card;
    `extra` are its trailing int arguments."""
    with torch.cuda.device(pool.device):  # the launch's card
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        rc = fn(pool.data_ptr(), pool.stride(0), a_col.data_ptr(),
                b_col.data_ptr(), alen.data_ptr(), blen.data_ptr(),
                _sub_on(pool.device).data_ptr(), scratch.data_ptr(),
                out.data_ptr(), a_col.shape[0], N, *extra, stream)
    cuda_build.check(rc, f"{name} launch")


def protein_wavefront(pool, a_col, b_col, alen, blen, M: int, N: int):
    """Row-4 kernel (v5) wrapper.  pool int8 [rows >= max(M, N), cap]
    (bits=8 columns); a_col/b_col/alen/blen int32 [B] with alen <= M and
    blen <= N.  Returns int32 [2, B]: mutual score, dc << 16 | matches.
    CPU tensors run the plain version; CUDA tensors launch or raise."""
    if pool.device.type == "cpu":
        return protein_plain(pool, a_col, b_col, alen, blen, M, N)
    if pool.device.type != "cuda":
        raise ValueError(f"protein_wavefront: unsupported device {pool.device}")
    _check_args("protein_wavefront", pool, a_col, b_col, alen, blen, M, N)
    B = a_col.shape[0]
    nw, bands = kernel_geometry(B, M, N)
    width = max(N, 1)
    out = torch.empty((2, B), dtype=torch.int32, device=pool.device)
    # one DP row (score, stats) per pair: the carry between bands
    scratch = torch.empty((max(B, 1) if bands > 1 else 1, width, 2),
                          dtype=torch.int32, device=pool.device)
    _launch(_lib(), "protein_wavefront", out, scratch, pool, a_col, b_col,
            alen, blen, width, nw)
    protein_wavefront.launches += 1
    return out


protein_wavefront.launches = 0


def protein_swar(pool, a_col, b_col, alen, blen, M: int, N: int):
    """Row-5 kernel (v6) wrapper: the same inputs and result as
    protein_wavefront, two pairs per 32-bit word (pair p in the low
    halves, pair p + ceil(B/2) in the high halves; kernel_geometry sets
    out the launch).  Raises for a bucket outside v6's domain (_swar_fits)."""
    if pool.device.type == "cpu":
        return protein_plain(pool, a_col, b_col, alen, blen, M, N)
    if pool.device.type != "cuda":
        raise ValueError(f"protein_swar: unsupported device {pool.device}")
    Mp, steps_end, _ = _shapes(M, N)
    if not _swar_fits(Mp, steps_end):
        raise ValueError(f"protein_swar: a {M} x {N} bucket is outside the "
                         "16-bit halves' domain")
    _check_args("protein_swar", pool, a_col, b_col, alen, blen, M, N)
    B = a_col.shape[0]
    nw, bands = kernel_geometry(B, M, N, swar=True)
    width = max(N, 1)
    out = torch.empty((2, B), dtype=torch.int32, device=pool.device)
    # one packed DP row (score2, matches2, dc2, pad) per pair of pairs:
    # the carry between bands
    scratch = torch.empty((max(-(-B // 2), 1) if bands > 1 else 1, width, 4),
                          dtype=torch.int32, device=pool.device)
    _launch(_swar_lib(), "protein_swar", out, scratch, pool, a_col, b_col,
            alen, blen, width, steps_end + 8, nw)
    protein_swar.launches += 1
    return out


protein_swar.launches = 0


def protein_inputs(a_codes, b_codes, a_len, b_len, device,
                   pool_cache=None):
    """Host prep shared by both kernels: dedupe both sides into pool rows,
    ship the rows not yet resident (or build the one-off pool), and return
    the wrapper arguments (pool, a_col, b_col, alen, blen, M, N)."""
    dev = torch.device(device)
    B, M = a_codes.shape
    N = b_codes.shape[1]
    rows, plen, idx_a, idx_b, keys = _dedupe_pool(a_codes, b_codes, a_len,
                                                  b_len)
    if pool_cache is not None:
        Mp, _, fwd_w = _shapes(M, N)
        Hc = max(_pow2(max(Mp, fwd_w)), _POOL_HC_FLOOR)
        pool, slots = pool_cache.ensure(8, Hc, keys, rows, plen)
    else:
        U = max(len(rows), 1)
        packed = _pack_text_pool(rows, plen, np.ones(len(rows), bool),
                                 max(M, N, 1), U, bits=8)
        pool = h2d(packed, dev)
        slots = np.arange(U, dtype=np.int32)
    t = lambda x: h2d(np.ascontiguousarray(x, np.int32), dev)  # noqa: E731
    return (pool, t(slots[idx_a]), t(slots[idx_b]), t(a_len), t(b_len), M, N)


def self_scores(pool, a_col, b_col, alen, blen, M, N):
    """Per-pair BLOSUM self-scores on the device (pallas_protein.py
    _from_codes :556-566): the diagonal summed over codes < 27 within
    each real length (callers may pad with any byte)."""
    dtab = h2d(_DIAG, pool.device)
    total = 0
    for col, n, ln in ((a_col, M, alen), (b_col, N, blen)):
        codes = _codes(pool, col, max(n, 1))
        pos = torch.arange(codes.shape[1], device=pool.device)[None, :]
        keep = (pos < ln.long()[:, None]) & (codes < _AA_N)
        total = total + torch.where(
            keep, dtab[codes.clamp(max=_AA_N - 1)], 0).sum(1)
    return total.to(torch.int32)


def batched_protein_align_cuda(a_codes, b_codes, a_len, b_len,
                               device="cuda", pool_cache=None, lazy=False,
                               swar: bool | None = None):
    """Port of batched_protein_align_pallas: the same dict of numpy arrays
    (float32 distance/similarity from the verbatim post).

    pool_cache: an ops.seqpool.DevicePoolCache; code rows stay resident
    across calls (bits=8) and only new rows ship.  swar: the v6 kernel
    on (True) or off; None reads TAXTK_PROTEIN_SWAR at call time.  Either way a bucket
    outside `_swar_fits` takes v5, as in taxtk.  lazy="device" returns
    (int32 [3, B] tensor, post) where post maps the host copy to the
    dict."""
    # uint8 coercion: the pool keys its cache on row bytes (:649-655)
    a_codes = np.asarray(a_codes, dtype=np.uint8)
    b_codes = np.asarray(b_codes, dtype=np.uint8)
    a_len = np.asarray(a_len, np.int32)
    b_len = np.asarray(b_len, np.int32)
    B, M = a_codes.shape
    N = b_codes.shape[1]
    Mp, steps_end, _ = _shapes(M, N)
    if swar is None:
        swar = os.environ.get("TAXTK_PROTEIN_SWAR") == "1"
    swar = swar and _swar_fits(Mp, steps_end)

    args = protein_inputs(a_codes, b_codes, a_len, b_len,
                          resolve_device(device), pool_cache)
    if swar:
        raw = protein_swar(*args)
    else:
        raw = protein_wavefront(*args)
    stacked = torch.cat([raw, self_scores(*args)[None]])

    def post(st):
        st = np.asarray(st)
        mutual = st[0, :B]
        madc = st[1, :B]
        selfscore = st[2, :B].astype(np.int64)
        matches = madc & 0xFFFF
        diag = madc >> 16
        # empty-side pairs
        empty = (a_len == 0) | (b_len == 0)
        mutual = np.where(empty, GAP_SCORE * np.maximum(a_len, b_len), mutual)
        matches = np.where(empty, 0, matches)
        diag = np.where(empty, 0, diag)

        mismatches = diag - matches
        gaps = a_len + b_len - 2 * diag
        length = matches + mismatches + gaps
        with np.errstate(divide="ignore", invalid="ignore"):
            normfactor = np.where(
                selfscore != 0,
                length.astype(np.float32) / selfscore.astype(np.float32),
                0,
            ).astype(np.float32)
        distance = (selfscore - 2 * mutual).astype(np.float32) * normfactor
        similarity = (2 * mutual).astype(np.float32) * normfactor
        return {
            "mutual": mutual,
            "selfscore": selfscore,
            "matches": matches,
            "mismatches": mismatches,
            "gaps": gaps,
            "length": length,
            "distance": distance,
            "similarity": similarity,
        }

    if lazy == "device":
        return stacked, post
    return post(stacked.cpu().numpy())

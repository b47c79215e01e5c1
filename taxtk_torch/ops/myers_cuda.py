"""Short-pair Myers entry: Kernel 1 (csrc/myers_short.cu) and its plain
version.

Mirrors taxtk/ops/pallas_myers.py::batched_edit_distance_pallas_myers on
its pool path (_call_pool): sequences are deduped into pool rows, the
rows not yet resident are appended to the device pool, pattern match
masks are built on the device from the packed pool columns
(myers_ref.peq_from_codes, the port of _peq_from_codes), and one kernel
launch reads each pair's text column and peq column in place.

`myers_short` is the wrapper: on CUDA tensors it launches the kernel and
counts the launch in `myers_short.launches`; on CPU tensors it runs the
plain version, `myers_short_plain`, which is the recurrence of
myers_ref.py over the same pool and peq.  The kernel runs a group of lanes
per pair, W pattern words per lane (`kernel_geometry`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..engine.metrics import span
from . import cuda_build
from .host import (
    ALPHA, WORD, _build_pool_wire, _dedupe_pool, _pool_indices, _pow2,
)
from .myers_chunked import batched_edit_distance_long
from .myers_ref import myers_wavefront, peq_from_codes, unpack_columns
from .seqpool import DevicePoolCache
from .transfer import h2d

# the kernel's template set: pattern words K, and at each K the words per
# lane W it is built for (a group of K / W <= 32 lanes per pair)
W_SET = {1: (1,), 2: (1,), 4: (1,), 8: (1,), 16: (1, 2), 32: (1, 2),
         64: (2,)}
K_SET = tuple(W_SET)
MAX_K = K_SET[-1]  # 2048 bp: longer patterns take the chunked entry
# the W a launch takes unless forced: W = 1 where both are built, the
# faster at every K = 16 and 32 launch of the engine run on the H100
# (chip_smoke.py's ms_sum_by_w)
DEFAULT_W = {1: 1, 2: 1, 4: 1, 8: 1, 16: 1, 32: 1, 64: 2}
THREADS = 128  # four warps a block


def kernel_geometry(K: int, w: int | None = None):
    """(G, W, pairs per warp, threads per block) of a Kernel 1 launch with
    K pattern words: a group of G = K / W lanes per pair, W words per lane
    (DEFAULT_W[K] unless w forces one of W_SET[K]), 32 / G pairs a warp.
    From the shape alone: no tensor is read."""
    if K not in W_SET:
        raise ValueError(f"myers_short: K={K} not supported")
    W = DEFAULT_W[K] if w is None else w
    if W not in W_SET[K]:
        raise ValueError(f"myers_short: W={W} not built at K={K}")
    G = K // W
    return G, W, 32 // G, THREADS


def myers_short_plain(pool, txt_col, peq, pat_idx, nlen, mlen, K, bits):
    """Plain version of Kernel 1: the myers_ref recurrence on the texts of
    pool columns txt_col and the peq columns pat_idx.  The 4-bit sentinel
    (15) matches nothing; 2-bit pad (3) lies past n_len and is never
    harvested.  Returns [B] int32 (m_len == 0 is pinned by the caller)."""
    n = int(nlen.max()) if nlen.numel() else 1
    text = unpack_columns(pool, txt_col, n, bits)
    out = myers_wavefront(peq[:K].index_select(2, pat_idx.long()), text,
                          mlen, nlen)
    return out.to(torch.int32)


def _lib():
    lib = cuda_build.load("myers_short")
    fn = lib.taxtk_myers_short
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, L, I, P, P, L, P, P, P, P, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def myers_short(pool, txt_col, peq, pat_idx, nlen, mlen, K: int, bits: int):
    """Kernel 1 wrapper.  pool int8 [rows, cap]; txt_col/pat_idx/nlen/mlen
    int32 [B]; peq int32 [K', ALPHA, U] with K' >= K.  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if pool.device.type == "cpu":
        return myers_short_plain(pool, txt_col, peq, pat_idx, nlen, mlen, K,
                                 bits)
    if pool.device.type != "cuda":
        raise ValueError(f"myers_short: unsupported device {pool.device}")
    if K not in K_SET or bits not in (2, 4):
        raise ValueError(f"myers_short: K={K} bits={bits} not supported")
    W = kernel_geometry(K)[1]
    B = txt_col.shape[0]
    for name, t, dt in (("txt_col", txt_col, torch.int32),
                        ("pat_idx", pat_idx, torch.int32),
                        ("nlen", nlen, torch.int32),
                        ("mlen", mlen, torch.int32)):
        if (t.device != pool.device or t.dtype != dt or t.shape != (B,)
                or not t.is_contiguous()):
            raise ValueError(f"myers_short: bad {name}")
    if (pool.dtype != torch.int8 or pool.dim() != 2 or pool.stride(1) != 1
            or peq.device != pool.device or peq.dtype != torch.int32
            or peq.dim() != 3 or peq.shape[0] < K or peq.shape[1] != ALPHA
            or not peq.is_contiguous()):
        raise ValueError("myers_short: bad pool or peq")
    out = torch.empty(B, dtype=torch.int32, device=pool.device)
    with torch.cuda.device(pool.device):  # the launch's card
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        rc = _lib()(
            pool.data_ptr(), pool.stride(0), pool.shape[0],
            txt_col.data_ptr(), peq.data_ptr(), peq.shape[2],
            pat_idx.data_ptr(), nlen.data_ptr(), mlen.data_ptr(),
            out.data_ptr(), B, K, W, bits, stream,
        )
    cuda_build.check(rc, "myers_short launch")
    myers_short.launches += 1
    return out


myers_short.launches = 0


def short_inputs(a_codes, b_codes, a_len, b_len, device,
                 pool_cache: DevicePoolCache | None = None):
    """Host prep of the short entry: dedupe into pool rows, ship the rows
    not yet resident, build peq on the device.  Returns (args, post):
    `myers_short(*args)` computes the raw distances and post(host) pins
    m_len == 0 and returns numpy distances.

    Spans: entry.dedupe (pool rows and the wire's bits), pool.ensure
    (ops/seqpool.py), entry.pack (the per-pair indices, or the one-off
    pool's wire), entry.peq (the pattern columns' gather and the device
    build) and entry.meta (the per-pair tables' upload)."""
    dev = torch.device(device)
    B = len(a_len)
    with span("entry.dedupe", count=B):
        a_codes = np.asarray(a_codes, dtype=np.uint8)
        b_codes = np.asarray(b_codes, dtype=np.uint8)
        a_len = np.asarray(a_len, np.int32)
        b_len = np.asarray(b_len, np.int32)
        swap = a_len > b_len
        m_len = np.where(swap, b_len, a_len).astype(np.int32)
        n_len = np.where(swap, a_len, b_len).astype(np.int32)
        N = int(n_len.max(initial=1))
        K = _pow2(max(1, -(-int(m_len.max(initial=1)) // WORD)))
        if K > MAX_K:
            raise ValueError(
                f"pattern of {int(m_len.max())} bp exceeds Kernel 1's "
                f"{MAX_K * WORD} bp; batched_edit_distance_short hands such "
                f"batches to the chunked entry"
            )
        Np = -(-N // 4) * 4  # the one-off pool: whole bytes at 2 or 4 bits

        rows, plen, idx_a, idx_b, keys = _dedupe_pool(a_codes, b_codes, a_len,
                                                      b_len)
        Up = len(rows)
        bits = 2 if all(int(r.max(initial=0)) < 4 for r in rows) else 4
    cpb = 8 // bits
    if pool_cache is not None:
        Hc = max(DevicePoolCache.height_class(N), _pow2(K * WORD))
        text_pool, slots = pool_cache.ensure(bits, Hc, keys, rows, plen)
        with span("entry.pack", count=B):
            pat_idx, txt_idx, plen_pat, _, _, _ = _pool_indices(
                plen, idx_a, idx_b, swap, B, B, K, Up)
            txt_col = slots[txt_idx]
        with span("entry.peq", count=B):
            pat_cols = h2d(slots, dev)
            pat_u = text_pool[: K * WORD // cpb].index_select(
                1, pat_cols.long())
            peq = peq_from_codes(pat_u, h2d(plen_pat, dev), K, bits)
    else:
        with span("entry.pack", count=B):
            pat_u_np, plen_pat, text_u, pat_idx, txt_col = _build_pool_wire(
                rows, plen, idx_a, idx_b, swap, B, B, K, Np, Up, bits)
            text_pool = h2d(text_u, dev)
        with span("entry.peq", count=B):
            pat_u = h2d(pat_u_np, dev)
            peq = peq_from_codes(pat_u, h2d(plen_pat, dev), K, bits)
    with span("entry.meta", count=B):
        args = (
            text_pool,
            h2d(np.ascontiguousarray(txt_col, np.int32), dev),
            peq,
            h2d(pat_idx, dev),
            h2d(n_len, dev),
            h2d(m_len, dev),
            K,
            bits,
        )

    def post(host):
        return np.where(m_len == 0, n_len, np.asarray(host).reshape(B))

    return args, post


def batched_edit_distance_short(
    a_codes, b_codes, a_len, b_len,
    device="cuda",
    pool_cache: DevicePoolCache | None = None,
    lazy=False,
    plain: bool = False,
):
    """Exact batched global edit distance (port of
    batched_edit_distance_pallas_myers).  Batches whose shorter sides
    reach past 2048 bp (K > 64 words) go to the pattern-block-chunked
    entry, myers_chunked.batched_edit_distance_long, as in taxtk.

    pool_cache: sequence rows stay device-resident across calls; without
    one the round's rows ship as a one-off pool.  plain=True runs the
    plain version on any device (the aligner's "myers" backend).
    lazy="device" returns (device int32 [B] tensor, post) where post maps
    the host copy to distances; otherwise the distances as numpy."""
    if int(np.minimum(a_len, b_len).max(initial=1)) > MAX_K * WORD:
        return batched_edit_distance_long(
            a_codes, b_codes, a_len, b_len, device=device,
            pool_cache=pool_cache, lazy=lazy, plain=plain)
    args, post = short_inputs(a_codes, b_codes, a_len, b_len,
                              resolve_device(device), pool_cache)
    with span("entry.launch", count=len(a_len)):
        out = myers_short_plain(*args) if plain else myers_short(*args)
    if lazy == "device":
        return out, post
    return post(out.cpu().numpy())

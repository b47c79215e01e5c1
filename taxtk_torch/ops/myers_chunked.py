"""Pattern-block-chunked Myers entry: csrc/myers_chunked.cu and its plain
version.

Port of taxtk/ops/pallas_myers.py::batched_edit_distance_pallas_myers_long
(:480-652) on its pool paths: the cross-round pool cache (:557-576) and the
one-off pool (:577-607).  Sequences are deduped into pool rows, peq is
built on the device for all Kp = n_blocks * Kb pattern words, and one
launch per block of Kb words runs every pair over its whole text.  The
carries at the block edge go from launch to launch through a carry
stream, which starts as ph = 1, mh = 0 above word 0; two buffers swap
between launches.  Score and result ride along; the last launch leaves
the distances.

The carry stream is the port's own layout, packed and pair-major: int32
[B, ceil(N / 16)], word w of pair i holding the PH carries of chars 16w ..
16w+15 in bits 0-15 and their MH carries in bits 16-31 (taxtk's is int8
[N, B], ph | mh << 1 a char; pack_carries and unpack_carries convert).

Left out, as in the short entry: the dense wire path (:608-639), the text
chunk and its shape ladder (the kernel takes lengths at run time).

`myers_chunked` is the wrapper: CUDA tensors launch the kernel (counted in
`myers_chunked.launches`), CPU tensors run `myers_chunked_plain`, which is
myers_ref.myers_block_step over the same pool and peq.  The kernel runs
two warps per pair, one pattern word a lane.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from . import cuda_build
from .host import (
    ALPHA, WORD, _build_pool_wire, _dedupe_pool, _pool_indices, _pow2,
)
from .myers_ref import (
    M32, myers_block_step, peq_from_codes, to_i32, unpack_columns,
)
from .seqpool import DevicePoolCache
from .transfer import h2d

CHUNK_KC = 64  # pattern words per launch (2048 bp), as in taxtk
# the kernel is built for CHUNK_KC only; smaller blocks (block_words) are
# for the plain version, whose CPU tests use taxtk's small test geometry
CARRY_CHARS = 16  # chars per word of the packed carry stream


def carry_words(N: int) -> int:
    """Words per pair of a packed carry stream over N chars."""
    return -(-max(N, 1) // CARRY_CHARS)


def pack_carries(h: torch.Tensor) -> torch.Tensor:
    """taxtk's carry stream int8 [N, B] (ph | mh << 1 a char) -> the
    port's int32 [B, carry_words(N)]: word w of pair i holds the PH
    carries of chars 16w .. 16w+15 in bits 0-15 and their MH carries in
    bits 16-31; chars past N read as 0."""
    N, B = h.shape
    dev = h.device
    x = torch.zeros((carry_words(N) * CARRY_CHARS, B), dtype=torch.int64,
                    device=dev)
    x[:N] = h.to(torch.int64)
    x = x.reshape(-1, CARRY_CHARS, B)
    w = (torch.ones(CARRY_CHARS, dtype=torch.int64, device=dev)
         << torch.arange(CARRY_CHARS, device=dev))[None, :, None]
    ph = ((x & 1) * w).sum(1)
    mh = (((x >> 1) & 1) * w).sum(1)
    return to_i32(ph | (mh << CARRY_CHARS)).T.contiguous()


def unpack_carries(hw: torch.Tensor, N: int) -> torch.Tensor:
    """The port's packed carry stream int32 [B, words] -> taxtk's int8
    [N, B] (ph | mh << 1 a char), for N <= words * 16."""
    j = torch.arange(N, device=hw.device)
    word = (hw.to(torch.int64) & M32).index_select(1, j // CARRY_CHARS)
    shift = j % CARRY_CHARS
    ph = (word >> shift) & 1
    mh = (word >> (shift + CARRY_CHARS)) & 1
    return (ph | (mh << 1)).T.to(torch.int8).contiguous()


def initial_carries(N, B, device):
    """The carry stream above the first pattern word: ph = 1, mh = 0 at
    each of N chars of B pairs."""
    return torch.full((B, carry_words(N)), (1 << CARRY_CHARS) - 1,
                      dtype=torch.int32, device=device)


def myers_chunked_plain(pool, txt_col, peq, pat_idx, mword, mbit, nlen,
                        score, res, hin, bits, hout=None):
    """Plain version of one launch: myers_block_step on the texts of pool
    columns txt_col and the peq columns pat_idx of this block's words
    peq [Kb, ALPHA, U], over the stream's whole extent (hin's words x 16
    chars), the carry streams converted at its boundary.  Returns (score,
    res, hout); hout is written into the given buffer, if any."""
    N = hin.shape[1] * CARRY_CHARS
    text = unpack_columns(pool, txt_col, N, bits)
    score, res, h = myers_block_step(peq.index_select(2, pat_idx.long()),
                                     text, mword, mbit, nlen, score, res,
                                     unpack_carries(hin, N))
    h = pack_carries(h)
    return score, res, h if hout is None else hout.copy_(h)


def _lib():
    lib = cuda_build.load("myers_chunked")
    fn = lib.taxtk_myers_chunked
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, L, I, P, P, L] + [P] * 10 + [I] * 4 + [P]
        fn.restype = ctypes.c_int
    return fn


def myers_chunked(pool, txt_col, peq, pat_idx, mword, mbit, nlen, score, res,
                  hin, bits, hout=None):
    """Kernel wrapper: one launch for the block peq [Kb, ALPHA, U] int32.
    pool int8 [rows, cap]; txt_col/pat_idx/mword/mbit/nlen/score/res int32
    [B]; hin the packed carry stream int32 [B, words] with words * 16 >=
    every nlen.  hout: the buffer of hin's shape to write (allocated when
    None).  CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise.  The kernel writes hout's words that hold a char j <
    nlen only, which is all a later launch reads.  Returns (score, res,
    hout)."""
    if pool.device.type == "cpu":
        return myers_chunked_plain(pool, txt_col, peq, pat_idx, mword, mbit,
                                   nlen, score, res, hin, bits, hout)
    if pool.device.type != "cuda":
        raise ValueError(f"myers_chunked: unsupported device {pool.device}")
    Kb = peq.shape[0]
    if Kb != CHUNK_KC or bits not in (2, 4):
        raise ValueError(f"myers_chunked: Kb={Kb} bits={bits} not supported")
    B = txt_col.shape[0]
    if hout is None:
        hout = torch.empty_like(hin)
    for name, t, dt, shape in (
            ("txt_col", txt_col, torch.int32, (B,)),
            ("pat_idx", pat_idx, torch.int32, (B,)),
            ("mword", mword, torch.int32, (B,)),
            ("mbit", mbit, torch.int32, (B,)),
            ("nlen", nlen, torch.int32, (B,)),
            ("score", score, torch.int32, (B,)),
            ("res", res, torch.int32, (B,)),
            ("hin", hin, torch.int32, (B, hin.shape[-1])),
            ("hout", hout, torch.int32, hin.shape)):
        if (t.device != pool.device or t.dtype != dt or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"myers_chunked: bad {name}")
    if (pool.dtype != torch.int8 or pool.dim() != 2 or pool.stride(1) != 1
            or peq.device != pool.device or peq.dtype != torch.int32
            or peq.dim() != 3 or peq.shape[1] != ALPHA
            or not peq.is_contiguous()):
        raise ValueError("myers_chunked: bad pool or peq")
    score_out = torch.empty_like(score)
    res_out = torch.empty_like(res)
    with torch.cuda.device(pool.device):  # the launch's card
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        rc = _lib()(
            pool.data_ptr(), pool.stride(0), pool.shape[0],
            txt_col.data_ptr(), peq.data_ptr(), peq.shape[2],
            pat_idx.data_ptr(), mword.data_ptr(),
            mbit.data_ptr(), nlen.data_ptr(), score.data_ptr(), res.data_ptr(),
            hin.data_ptr(), score_out.data_ptr(), res_out.data_ptr(),
            hout.data_ptr(), hin.shape[1], B, Kb, bits, stream,
        )
    cuda_build.check(rc, "myers_chunked launch")
    myers_chunked.launches += 1
    return score_out, res_out, hout


myers_chunked.launches = 0


def chunked_inputs(a_codes, b_codes, a_len, b_len, device,
                   block_words=CHUNK_KC,
                   pool_cache: DevicePoolCache | None = None):
    """Host prep of the chunked entry: dedupe into pool rows, ship the rows
    not yet resident, build peq for all Kp words on the device.  Returns
    (args, post): `run_chunked(*args)` computes the raw distances and
    post(host) pins m_len == 0 and returns numpy distances."""
    dev = torch.device(device)
    a_codes = np.asarray(a_codes, dtype=np.uint8)
    b_codes = np.asarray(b_codes, dtype=np.uint8)
    a_len = np.asarray(a_len, np.int32)
    b_len = np.asarray(b_len, np.int32)
    B = a_codes.shape[0]
    swap = a_len > b_len
    m_len = np.where(swap, b_len, a_len).astype(np.int32)
    n_len = np.where(swap, a_len, b_len).astype(np.int32)
    N = int(n_len.max(initial=1))
    K = max(1, -(-int(m_len.max(initial=1)) // WORD))
    Kb = block_words
    Kp = -(-K // Kb) * Kb
    Np = -(-N // 4) * 4  # the one-off text pool: whole bytes at 2 or 4 bits

    rows, plen, idx_a, idx_b, keys = _dedupe_pool(a_codes, b_codes, a_len,
                                                  b_len)
    Up = len(rows)
    bits = 2 if all(int(r.max(initial=0)) < 4 for r in rows) else 4
    cpb = 8 // bits
    if pool_cache is not None:
        Hc = max(DevicePoolCache.height_class(N), _pow2(Kp * WORD))
        text_pool, slots = pool_cache.ensure(bits, Hc, keys, rows, plen)
        pat_idx, txt_idx, plen_pat, _, _, _ = _pool_indices(
            plen, idx_a, idx_b, swap, B, B, Kp, Up)
        pat_u = text_pool[: Kp * WORD // cpb].index_select(
            1, h2d(slots, dev).long())
        txt_col = slots[txt_idx]
    else:
        pat_u_np, plen_pat, text_u, pat_idx, txt_col = _build_pool_wire(
            rows, plen, idx_a, idx_b, swap, B, B, Kp, Np, Up, bits)
        pat_u = h2d(pat_u_np, dev)
        text_pool = h2d(text_u, dev)
    peq = peq_from_codes(pat_u, h2d(plen_pat, dev), Kp, bits)
    t32 = lambda x: h2d(np.ascontiguousarray(x, np.int32), dev)  # noqa: E731
    args = (text_pool, t32(txt_col), peq, t32(pat_idx),
            t32((m_len - 1) >> 5), t32((m_len - 1) & 31), t32(n_len),
            t32(m_len), N, Kb, bits)

    def post(host):
        return np.where(m_len == 0, n_len, np.asarray(host).reshape(B))

    return args, post


def run_chunked(pool, txt_col, peq, pat_idx, mword, mbit, nlen, mlen, N, Kb,
                bits, plain=False):
    """One launch per block of Kb pattern words (plain=True: the plain
    version of each); returns the int32 [B] results of the last."""
    step = myers_chunked_plain if plain else myers_chunked
    score = mlen
    res = torch.maximum(mlen, nlen)
    hin = initial_carries(N, txt_col.shape[0], pool.device)
    spare = torch.empty_like(hin)
    for p in range(peq.shape[0] // Kb):
        score, res, hout = step(pool, txt_col, peq[p * Kb : (p + 1) * Kb],
                                pat_idx, mword - p * Kb, mbit, nlen, score,
                                res, hin, bits, spare)
        hin, spare = hout, hin
    return res


def batched_edit_distance_long(
    a_codes, b_codes, a_len, b_len,
    device="cuda",
    block_words: int = CHUNK_KC,
    pool_cache: DevicePoolCache | None = None,
    lazy=False,
    plain: bool = False,
):
    """Exact batched global edit distance for patterns of any length, one
    launch per block of `block_words` pattern words (port of
    batched_edit_distance_pallas_myers_long).  Same contract as
    myers_cuda.batched_edit_distance_short: pool_cache keeps rows
    device-resident across calls; plain=True runs the plain version on
    any device; lazy="device" returns (device int32 [B] tensor, post)."""
    dev = resolve_device(device)
    if len(a_len) == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        if lazy == "device":
            return empty, lambda host: np.zeros(0, np.int32)
        return np.zeros(0, np.int32)
    args, post = chunked_inputs(a_codes, b_codes, a_len, b_len, dev,
                                block_words, pool_cache)
    out = run_chunked(*args, plain=plain)
    if lazy == "device":
        return out, post
    return post(out.cpu().numpy())

"""Bit-parallel Myers edit distance as plain PyTorch tensor code.

Port of taxtk/ops/myers_batch.py (the XLA "myers" backend): the same
exact global edit distance, the same peq layout [K, ALPHA, B] and the
same per-pair harvest at j == n_len.  This is the plain version that the
CUDA kernels are held against.

PyTorch has no usable unsigned 32-bit arithmetic on the CPU, and `>>` on
int32 is an arithmetic shift, so the recurrence runs on int64 holding
each 32-bit word in [0, 2**32): every add, shift and NOT is masked back
to 32 bits, which keeps every right shift logical.

The text loop visits the (char, word) cells in anti-diagonal order: word
k handles char s - k at step s, so all K words advance together in one
vector step and the loop runs N + K - 1 steps instead of N x K.  Each
word still sees exactly the carries and state of the sequential
recurrence (word k at char j needs word k-1 at char j, done one step
earlier, and itself at char j-1), so the results are identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .host import ALPHA, WORD

M32 = 0xFFFFFFFF


def build_peq(patterns: np.ndarray, m_len: np.ndarray, K: int) -> np.ndarray:
    """patterns [B, M] uint8 codes, m_len [B] -> peq [K, ALPHA, B] uint32
    (copy of taxtk/ops/myers_batch.py::build_peq: the native single-pass
    builder when the library loads, else np.packbits)."""
    B, M = patterns.shape
    assert K * WORD >= M, (K, M)
    from ..native import build_peq_native

    peq = build_peq_native(patterns, m_len, K, ALPHA)
    if peq is not None:
        return peq
    pad = np.full((B, K * WORD), 255, np.uint8)
    pad[:, :M] = patterns
    mask = np.arange(K * WORD)[None, :] < m_len[:, None]
    peq = np.zeros((K, ALPHA, B), dtype=np.uint32)
    for c in range(ALPHA):
        hit = (pad == c) & mask  # [B, K*WORD]
        packed = np.packbits(hit, axis=1, bitorder="little")  # [B, K*4] u8
        words = packed.view("<u4").reshape(B, K)  # [B, K] u32
        peq[:, c, :] = words.T
    return peq


def _precompute(a_codes, b_codes, a_len, b_len):
    """Copy of taxtk/ops/myers_batch.py::_precompute: pattern = the shorter
    side; returns (peq, text [N, B] with sentinel 31 past each text's end,
    hmask, m_len, n_len, K)."""
    B = a_codes.shape[0]
    swap = a_len > b_len
    m_len = np.where(swap, b_len, a_len).astype(np.int32)
    n_len = np.where(swap, a_len, b_len).astype(np.int32)
    Mmax = int(m_len.max(initial=1))
    Nmax = int(n_len.max(initial=1))
    K = max(1, -(-Mmax // WORD))

    W = max(a_codes.shape[1], b_codes.shape[1], 1)
    a_pad = np.full((B, W), 255, np.uint8)
    a_pad[:, : a_codes.shape[1]] = a_codes
    b_pad = np.full((B, W), 255, np.uint8)
    b_pad[:, : b_codes.shape[1]] = b_codes
    patterns = np.where(swap[:, None], b_pad, a_pad)[:, : max(Mmax, 1)]
    text_rows = np.where(swap[:, None], a_pad, b_pad)[:, : max(Nmax, 1)]
    col = np.arange(text_rows.shape[1])[None, :]
    text = np.ascontiguousarray(np.where(col < n_len[:, None], text_rows, 31).T)

    peq = build_peq(patterns, m_len, K)
    last_block = np.maximum(m_len - 1, 0) // WORD  # [B]
    high_bit = np.uint32(1) << ((np.maximum(m_len, 1) - 1) % WORD).astype(np.uint32)
    hmask = np.where(
        np.arange(K)[:, None] == last_block[None, :], high_bit[None, :], 0
    ).astype(np.uint32)
    return peq, text, hmask, m_len, n_len, K


def peq_to_torch(peq: np.ndarray, device) -> torch.Tensor:
    """taxtk's numpy peq [K, ALPHA, B] uint32 (myers_batch.build_peq) ->
    the port's layout: the same [K, ALPHA, B] bits as an int32 tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(peq, np.uint32).view(np.int32)
    ).to(device)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 tensors holding the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def peq_from_codes(pat_u: torch.Tensor, plen_pat: torch.Tensor, K: int,
                   bits: int) -> torch.Tensor:
    """Device-side peq build (taxtk/ops/pallas_myers.py::_peq_from_codes):
    packed pattern codes [K*WORD*bits//8, Up] int8 -> match masks
    [K, ALPHA, Up] int32 (u32 bits).  Positions at or past each pattern's
    plen_pat are masked, which also silences 2-bit pad fields (code 3)."""
    dev = pat_u.device
    cpb = 8 // bits
    mask = (1 << bits) - 1
    W = K * WORD
    idx = torch.arange(W, device=dev)
    rowsb = pat_u.to(torch.int32).index_select(0, idx // cpb)  # [W, Up]
    codes = (rowsb >> ((idx % cpb) * bits)[:, None]) & mask
    valid = idx[:, None] < plen_pat.to(dev)[None, :]
    weights = torch.ones(WORD, dtype=torch.int64, device=dev) << torch.arange(
        WORD, device=dev)
    planes = [
        (((codes == c) & valid).reshape(K, WORD, -1).to(torch.int64)
         * weights[None, :, None]).sum(1)
        for c in range(ALPHA)
    ]
    return to_i32(torch.stack(planes, 1))


def unpack_columns(pool: torch.Tensor, cols: torch.Tensor, n: int,
                   bits: int) -> torch.Tensor:
    """Codes [n, len(cols)] int64 of the packed pool columns `cols`
    (lowest field = even position); rows past the pool read as pad."""
    cpb = 8 // bits
    rows = -(-max(n, 1) // cpb)
    packed = pool[:rows].index_select(1, cols.long()).to(torch.int64) & 0xFF
    if packed.shape[0] < rows:
        pad = torch.full((rows - packed.shape[0], packed.shape[1]), 0xFF,
                         dtype=torch.int64, device=pool.device)
        packed = torch.cat([packed, pad])
    shifts = torch.arange(cpb, device=pool.device) * bits
    codes = (packed[:, None, :] >> shifts[None, :, None]) & ((1 << bits) - 1)
    return codes.reshape(rows * cpb, -1)[: max(n, 1)]


def myers_block_step(peq_blk, text, mword, mbit, nlen, score, res, hin):
    """One block of pattern words over the whole text: the recurrence of
    one launch of taxtk/ops/pallas_myers.py::_make_kernel_chunked.

    peq_blk [Kb, ALPHA, B] (int32 or int64 holding u32 bits) is this
    block's pattern words; text [N, B] codes (a code >= ALPHA matches
    nothing); mword/mbit [B] place the pattern-end cell relative to the
    block (a word outside [0, Kb) means the pattern ends in another block);
    nlen [B]; score/res [B] are carried in from the previous block; hin
    [N, B] holds the carries into word 0 at each text position, ph | mh<<1.
    Pv and Mv start fresh.  The score moves only while j <= nlen, since
    every later block harvests it again at j == nlen.
    Returns (score, res) [B] int32 and hout [N, B] int8, the carries out of
    word Kb-1."""
    K, A, B = peq_blk.shape
    N = text.shape[0]
    dev = peq_blk.device
    i64 = torch.int64
    peqz = torch.cat(
        [peq_blk.to(i64) & M32, torch.zeros((K, 1, B), dtype=i64, device=dev)],
        1)
    text = text.to(i64).clamp(0, A)
    hin = hin.to(i64)
    mword = mword.to(i64)
    nlen = nlen.to(i64)
    ks = torch.arange(K, device=dev)
    hm = torch.where(ks[:, None] == mword[None, :],
                     torch.ones_like(mword) << mbit.to(i64), 0)
    kk = mword.clamp(0, K - 1)  # the word whose char the score follows
    pv = torch.full((K, B), M32, dtype=i64, device=dev)
    mv = torch.zeros((K, B), dtype=i64, device=dev)
    cin_ph = torch.zeros((K, B), dtype=i64, device=dev)
    cin_mh = torch.zeros((K, B), dtype=i64, device=dev)
    score = score.to(i64)
    res = res.to(i64)
    hout = torch.zeros((N, B), dtype=torch.int8, device=dev)
    for s in range(N + K - 1):
        if s < N:  # word 0 takes char s with the carries of hin[s]
            cin_ph[0] = hin[s] & 1
            cin_mh[0] = (hin[s] >> 1) & 1
        j = s - ks  # char of each word at this step
        valid = ((j >= 0) & (j < N))[:, None]
        tc = text.index_select(0, j.clamp(0, N - 1))  # [K, B]
        eq0 = peqz.gather(1, tc[:, None, :])[:, 0, :]
        eq = eq0 | cin_mh
        xv = eq | mv
        add = ((eq & pv) + pv) & M32
        xh = (add ^ pv) | eq
        ph = (mv | ~(xh | pv)) & M32
        mh = pv & xh
        delta = (ph & hm).ne(0).any(0).to(i64) - (mh & hm).ne(0).any(0).to(i64)
        ph_shift = ((ph << 1) & M32) | cin_ph
        mh_shift = ((mh << 1) & M32) | cin_mh
        pv = torch.where(valid, (mh_shift | ~(xv | ph_shift)) & M32, pv)
        mv = torch.where(valid, ph_shift & xv, mv)
        # carries out of word k feed word k+1 at the next step (same char)
        cin_ph[1:] = ph[:-1] >> 31
        cin_mh[1:] = mh[:-1] >> 31
        if s >= K - 1:  # word Kb-1 finished char s - (Kb-1)
            hout[s - K + 1] = ((ph[-1] >> 31) | ((mh[-1] >> 31) << 1)).to(
                torch.int8)
        jp = s - kk + 1  # 1-based char the score word handled at this step
        live = (jp >= 1) & (jp <= N)
        score = score + torch.where(live & (jp <= nlen), delta, 0)
        res = torch.where(live & (jp == nlen), score, res)
    return score.to(torch.int32), res.to(torch.int32), hout


def myers_wavefront(peq, text, m_len, n_len) -> torch.Tensor:
    """The recurrence of taxtk/ops/myers_batch.py::_myers_kernel: the whole
    pattern as one block (myers_block_step) under the top carries ph = 1,
    mh = 0.

    peq [K, ALPHA, B] (int32 or int64 holding u32 bits), text [N, B]
    codes (any code >= ALPHA matches nothing), m_len/n_len [B]
    -> [B] int32: score harvested at j == n_len, max(m_len, n_len) where
    no harvest happens (n_len == 0).  m_len == 0 is pinned by callers."""
    N, B = text.shape
    m_len = m_len.to(torch.int64)
    _score, res, _hout = myers_block_step(
        peq, text, (m_len - 1) >> 5, (m_len - 1) & 31, n_len, m_len,
        torch.maximum(m_len, n_len.to(torch.int64)),
        torch.ones((N, B), dtype=torch.int8, device=peq.device))
    return res


def batched_edit_distance_myers(a_codes, b_codes, a_len, b_len,
                                device="cuda") -> np.ndarray:
    """Port of taxtk/ops/myers_batch.py::batched_edit_distance_myers: host
    peq build, the plain recurrence on `device`, and the empty-pattern pin
    (the bit machinery has no zero-width mode)."""
    dev = resolve_device(device)
    a_codes = np.asarray(a_codes)
    b_codes = np.asarray(b_codes)
    a_len = np.asarray(a_len, np.int32)
    b_len = np.asarray(b_len, np.int32)
    peq, text, _hmask, m_len, n_len, _K = _precompute(
        a_codes, b_codes, a_len, b_len)
    out = myers_wavefront(
        peq_to_torch(peq, dev),
        torch.from_numpy(text).to(dev),
        torch.from_numpy(m_len).to(dev),
        torch.from_numpy(n_len).to(dev),
    )
    out = out.to(torch.int32).cpu().numpy()
    return np.where(m_len == 0, n_len, out)

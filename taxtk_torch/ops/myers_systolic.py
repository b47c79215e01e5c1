"""Long-pair Myers entry: Kernel 2 (csrc/myers_systolic.cu) and its plain
version.

Mirrors taxtk/ops/pallas_myers_systolic.py::batched_edit_distance_systolic
with its pool front end (_stage_and_call_pool): host._pack_systolic lays
each pair's 32-word pattern blocks out as contiguous slots of 128-slot
rows (the plain version's layout and the per-slot output), the pool holds
the sequence columns, and peq is built on the device.  The kernel runs one
CUDA block per pair, through a per-pair table of (first slot, slot count),
with a warp per KW pattern blocks and a lane per KW pattern words
(`kernel_geometry`).  It reads peq and the text by column itself, so the
TPU's staging gathers (_stage_core) have no counterpart here.

`myers_systolic` is the wrapper: CUDA tensors launch the kernel (counted
in `myers_systolic.launches`), CPU tensors run `myers_systolic_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..engine.metrics import span
from . import cuda_build
from .host import (
    ALPHA, LANE, STAG, WORD, _dedupe_pool, _pack_systolic, _pow2,
)
from .myers_ref import M32, peq_from_codes, unpack_columns
from .seqpool import DevicePoolCache
from .transfer import h2d

DEFAULT_KC = 32  # pattern words per slot (1024 bp), as in taxtk
# the kernel is built for DEFAULT_KC only; smaller slots (block_words) are
# for the plain version, whose CPU tests use taxtk's small test geometry
KC_SET = (DEFAULT_KC,)
MAX_KW = 3  # pattern words per lane: 32 warps x 32 lanes x 3 = 96 blocks
MAX_WARPS = 32
# KW = 3 from here on, where it still gives a pair 16 warps or more: on
# the H100 it was the faster at 49 blocks and KW = 2 at 25 and below
# (chip_smoke.py's ms_by_kw)
KW3_BLOCKS = 46
GRAPH_STEPS = 64  # plain-version steps per CUDA graph on the card

_META = ("peq_col", "txt_col", "head", "lanek", "nlen", "mword", "mbit",
         "mlen")
_KERNEL_META = ("peq_col", "txt_col", "nlen", "mword", "mbit", "mlen")


def kernel_geometry(nb_max: int):
    """(KW, warps) of a launch whose largest pair has nb_max 32-word
    blocks: two pattern words per lane (the kernel's source note says why
    not one), three from KW3_BLOCKS on, and the warps that pair needs.
    Raises ValueError past 96 blocks (98,304 bp, the aligner's
    LONG_PATTERN_CAP)."""
    nb_max = max(nb_max, 1)
    kw = 2 if nb_max < KW3_BLOCKS else max(3, -(-nb_max // MAX_WARPS))
    if kw > MAX_KW:
        raise ValueError(f"myers_systolic: {nb_max} pattern blocks exceed "
                         f"the kernel's {MAX_KW * MAX_WARPS}")
    return kw, -(-nb_max // kw)


def myers_systolic_plain(pool, peq, KC, peq_col, txt_col, head, lanek, nlen,
                         mword, mbit, mlen, pair_slots, nb_max, bits):
    """Plain version of Kernel 2: the systolic recurrence written out as
    tensor code with one pattern word per lane and a stagger of one step.

    Word k of slot s (block blk = lanek // STAG of its pair) runs
    blk*KC + k steps behind the pair's first word; its left neighbour on
    the flat (row, slot, word) axis hands it the char and the PH/MH
    carries of the step before, exactly the FIFO of the kernel at KC = 1
    and STAG = 1.  Fresh state at jeff1 == 1, the live window, the
    harvest at jeff1 == n_len and head insertion follow the kernel; each
    slot's result is that of its pattern-end word (word 0 where the slot
    holds no end).  pair_slots and nb_max (the kernel's launch table) are
    not read.  Returns [R, LANE] int32, the kernel's output."""
    dev = pool.device
    i64 = torch.int64
    R = head.shape[0]
    S = R * LANE
    B1 = peq.shape[2]
    ks = torch.arange(KC, device=dev)
    pc = peq_col.reshape(S).to(i64)
    word_row = ((pc // B1)[:, None] * KC + ks[None, :]).reshape(-1)
    word_col = (pc % B1).repeat_interleave(KC)
    peq_w = (peq.to(i64) & M32)[word_row, :, word_col].T  # [ALPHA, L]
    peq_w = torch.cat([peq_w, torch.zeros_like(peq_w[:1])])  # code >= ALPHA
    flat = lambda t: t.reshape(S).to(i64).repeat_interleave(KC)  # noqa: E731
    lag = flat(lanek // STAG) * KC + ks.repeat(S)
    n_w = flat(nlen)
    m_w = flat(mlen)
    mw_slot = mword.reshape(S).to(i64)
    hm = torch.where(
        ks[None, :] == mw_slot[:, None],
        (torch.ones_like(mw_slot) << mbit.reshape(S).to(i64))[:, None], 0,
    ).reshape(-1)
    heads = torch.nonzero(head.reshape(S) == 1).flatten() * KC  # word 0
    steps = int((n_w + lag).max()) if n_w.numel() else 0
    fresh = unpack_columns(pool, txt_col.reshape(S)[heads // KC], steps,
                           bits)  # [steps, n_heads]
    L = S * KC
    pv = torch.full((L,), M32, dtype=i64, device=dev)
    mv = torch.zeros(L, dtype=i64, device=dev)
    c_out = torch.zeros(L, dtype=i64, device=dev)
    ph_out = torch.zeros(L, dtype=i64, device=dev)
    mh_out = torch.zeros(L, dtype=i64, device=dev)
    score = m_w.clone()
    res = torch.maximum(m_w, n_w)
    t_now = torch.zeros(1, dtype=i64, device=dev)

    def step():
        """Step t_now of every word; the state tensors update in place."""
        tc = torch.roll(c_out, 1)
        cin_ph = torch.roll(ph_out, 1)
        cin_mh = torch.roll(mh_out, 1)
        tc.index_copy_(0, heads, fresh.index_select(0, t_now)[0])
        cin_ph.index_fill_(0, heads, 1)
        cin_mh.index_fill_(0, heads, 0)
        jeff1 = t_now + 1 - lag
        enter = jeff1 == 1
        pv0 = torch.where(enter, M32, pv)
        mv0 = torch.where(enter, 0, mv)
        eq0 = peq_w.gather(0, tc.clamp(max=ALPHA)[None])[0]
        eq = eq0 | cin_mh
        xv = eq | mv0
        add = ((eq & pv0) + pv0) & M32
        xh = (add ^ pv0) | eq
        ph = (mv0 | ~(xh | pv0)) & M32
        mh = pv0 & xh
        delta = (ph & hm).ne(0).to(i64) - (mh & hm).ne(0).to(i64)
        ph_shift = ((ph << 1) & M32) | cin_ph
        mh_shift = ((mh << 1) & M32) | cin_mh
        pv.copy_((mh_shift | ~(xv | ph_shift)) & M32)
        mv.copy_(ph_shift & xv)
        live = (jeff1 >= 1) & (jeff1 <= n_w)
        score.add_(torch.where(live, delta, 0))
        res.copy_(torch.where(jeff1 == n_w, score, res))
        c_out.copy_(tc)
        ph_out.copy_(ph >> 31)
        mh_out.copy_(mh >> 31)
        t_now.add_(1)

    done = 0
    if dev.type == "cuda" and steps > 2 + GRAPH_STEPS:
        # some 60 small ops a step, so the loop is bound by the host's
        # launches: on the card, GRAPH_STEPS steps are captured once as a
        # CUDA graph and replayed (the same ops; the first two steps run
        # eagerly on a side stream, as capture wants)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                step()
        torch.cuda.current_stream(dev).wait_stream(side)
        done = 2
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_STEPS):
                step()
        while done + GRAPH_STEPS <= steps:
            graph.replay()
            done += GRAPH_STEPS
    for _ in range(steps - done):
        step()
    k_sel = torch.where((mw_slot >= 0) & (mw_slot < KC), mw_slot, 0)
    out = res.reshape(S, KC).gather(1, k_sel[:, None])[:, 0]
    return out.reshape(R, LANE).to(torch.int32)


def _lib():
    lib = cuda_build.load("myers_systolic")
    fn = lib.taxtk_myers_systolic
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, L, I, P, I] + [P] * 6 + [P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def myers_systolic(pool, peq, KC, peq_col, txt_col, head, lanek, nlen, mword,
                   mbit, mlen, pair_slots, nb_max, bits):
    """Kernel 2 wrapper.  pool int8 [rows, cap]; peq int32
    [nbmax*KC, ALPHA, B1]; every slot array int32 [R, LANE] (txt_col holds
    pool columns); pair_slots int32 [B, 2] (first slot, slot count) and
    nb_max, the largest slot count (a host int: it sizes the launch).  CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Returns [R, LANE] int32."""
    meta = (peq_col, txt_col, head, lanek, nlen, mword, mbit, mlen)
    if pool.device.type == "cpu":
        return myers_systolic_plain(pool, peq, KC, *meta, pair_slots, nb_max,
                                    bits)
    if pool.device.type != "cuda":
        raise ValueError(f"myers_systolic: unsupported device {pool.device}")
    if KC not in KC_SET or bits not in (2, 4):
        raise ValueError(f"myers_systolic: KC={KC} bits={bits} not supported")
    kw, warps = kernel_geometry(nb_max)
    R = head.shape[0]
    for name, t in zip(_META, meta):
        if (t.device != pool.device or t.dtype != torch.int32
                or t.shape != (R, LANE) or not t.is_contiguous()):
            raise ValueError(f"myers_systolic: bad {name}")
    if (pair_slots.device != pool.device or pair_slots.dtype != torch.int32
            or pair_slots.dim() != 2 or pair_slots.shape[1] != 2
            or not pair_slots.is_contiguous()):
        raise ValueError("myers_systolic: bad pair_slots")
    if (pool.dtype != torch.int8 or pool.dim() != 2 or pool.stride(1) != 1
            or peq.device != pool.device or peq.dtype != torch.int32
            or peq.dim() != 3 or peq.shape[1] != ALPHA
            or peq.shape[0] % KC or not peq.is_contiguous()):
        raise ValueError("myers_systolic: bad pool or peq")
    out = torch.empty((R, LANE), dtype=torch.int32, device=pool.device)
    with torch.cuda.device(pool.device):  # the launch's card
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        kmeta = dict(zip(_META, meta))
        rc = _lib()(
            pool.data_ptr(), pool.stride(0), pool.shape[0], peq.data_ptr(),
            peq.shape[2], *(kmeta[k].data_ptr() for k in _KERNEL_META),
            pair_slots.data_ptr(), out.data_ptr(), R * LANE,
            pair_slots.shape[0], kw, warps, bits, stream,
        )
    cuda_build.check(rc, "myers_systolic launch")
    myers_systolic.launches += 1
    return out


myers_systolic.launches = 0


def systolic_inputs(a_codes, b_codes, a_len, b_len, device,
                    block_words=DEFAULT_KC,
                    pool_cache: DevicePoolCache | None = None):
    """Host prep of the systolic entry (B >= 1): slot layout, per-pair
    table, pool append, device peq.  Returns (args, post):
    `myers_systolic(*args)` computes the [R, LANE] slot results and
    post(host) reads each pair's last slot and pins empty sides.

    Spans: entry.pack (the wire's bits and the slot layout), entry.dedupe
    (pool rows), pool.ensure (ops/seqpool.py), entry.peq (the pattern
    columns' gather and the device build) and entry.meta (the slot
    tables and the per-pair table, laid out and uploaded)."""
    dev = torch.device(device)
    B = len(a_len)
    KC = block_words
    with span("entry.pack", count=B):
        a_codes = np.asarray(a_codes, dtype=np.uint8)
        b_codes = np.asarray(b_codes, dtype=np.uint8)
        a_len = np.asarray(a_len, np.int32)
        b_len = np.asarray(b_len, np.int32)
        # 2-bit wire for N-free batches (pad fields read as code 3; results
        # are harvested exactly at n_len and peq masks pattern pads by plen)
        bits = 2 if (int(a_codes.max(initial=0)) < 4
                     and int(b_codes.max(initial=0)) < 4) else 4
        inputs, (R, Np, nbmax) = _pack_systolic(
            a_codes, b_codes, a_len, b_len, KC,
            build_pools=pool_cache is None, bits=bits)
    cpb = 8 // bits
    B1 = _pow2(B + 1)
    txt_col = inputs["txt_col"]  # pair column (B: unused) per slot
    if pool_cache is not None:
        with span("entry.dedupe", count=B):
            rows, plen, idx_a, idx_b, keys = _dedupe_pool(
                a_codes, b_codes, a_len, b_len)
            swap = a_len > b_len
            pat_entry = np.where(swap, idx_b, idx_a)
            txt_entry = np.where(swap, idx_a, idx_b)
        Hc = max(DevicePoolCache.height_class(Np), _pow2(nbmax * KC * WORD))
        # height ratchet: reuse the tallest class this cache has used, so
        # a smaller later round hits the rows the first round shipped
        Hc = max(Hc, pool_cache.systolic_hc)
        pool_cache.systolic_hc = Hc
        text_pool, slots = pool_cache.ensure(bits, Hc, keys, rows, plen)
        with span("entry.peq", count=B):
            pat_cols = np.zeros(B1, np.int32)
            pat_cols[:B] = slots[pat_entry]
            txt_cols = np.zeros(B1, np.int32)
            txt_cols[:B] = slots[txt_entry]
            pat_u = text_pool[: nbmax * KC * WORD // cpb].index_select(
                1, h2d(pat_cols, dev).long())
            txt_col = txt_cols[txt_col]  # pool column per slot
            peq = peq_from_codes(pat_u, h2d(inputs["plen_pat"], dev),
                                 nbmax * KC, bits)
    else:
        with span("entry.peq", count=B):
            pat_u = h2d(inputs["pat_u"], dev)
            text_pool = h2d(inputs["text_u"], dev)
            peq = peq_from_codes(pat_u, h2d(inputs["plen_pat"], dev),
                                 nbmax * KC, bits)
    with span("entry.meta", count=B):
        slot_arrays = dict(inputs, txt_col=txt_col)
        meta = [
            h2d(np.ascontiguousarray(slot_arrays[k].reshape(R, LANE),
                                     np.int32), dev)
            for k in _META
        ]
        pair_slots = inputs["pair_slots"]
        last = pair_slots[:, 0] + pair_slots[:, 1] - 1
        pair_slots_dev = h2d(pair_slots, dev)

    def post(host):
        res = np.asarray(host).reshape(-1)[last]
        # empty-side pairs: the harvest fires with a zero score seed when
        # m == 0, so pin the exact answer (distance(empty, s) == len(s))
        empty = (a_len == 0) | (b_len == 0)
        return np.where(empty, np.maximum(a_len, b_len), res).astype(np.int32)

    return (text_pool, peq, KC, *meta, pair_slots_dev,
            int(pair_slots[:, 1].max()), bits), post


def batched_edit_distance_systolic(
    a_codes, b_codes, a_len, b_len,
    device="cuda",
    block_words: int = DEFAULT_KC,
    pool_cache: DevicePoolCache | None = None,
    lazy=False,
    plain: bool = False,
):
    """Exact batched global edit distance through the block-systolic
    layout (port of batched_edit_distance_systolic).  Same contract as
    myers_cuda.batched_edit_distance_short; best for few pairs with long
    patterns.  pool_cache: rows stay device-resident across calls."""
    dev = resolve_device(device)
    if len(a_len) == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        if lazy == "device":
            return empty, lambda host: np.zeros(0, np.int32)
        return np.zeros(0, np.int32)
    args, post = systolic_inputs(a_codes, b_codes, a_len, b_len, dev,
                                 block_words, pool_cache)
    with span("entry.launch", count=len(a_len)):
        out = myers_systolic_plain(*args) if plain else myers_systolic(*args)
    if lazy == "device":
        return out, post
    return post(out.cpu().numpy())

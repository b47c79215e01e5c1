"""Host-side numpy helpers of the Myers entries.

Copies of the jax-free helpers that live in jax-importing modules of
taxtk: `_pow2`, `_dedupe_pool`, `_pool_indices`, `_build_pool_wire` and
`_pack_text_pool` of taxtk/ops/pallas_myers.py, and `_pack_systolic` of
taxtk/ops/pallas_myers_systolic.py.  `_pack_systolic` drops the
TPU's text chunk and its quarter-octave chunk ladder (compile-shape
measures; the CUDA kernels take lengths at run time), so its text extent
is the steps the pairs need, rounded to whole trips.  `_pack_text_pool`
keeps taxtk's function and wraps the port's own C++ pass
(native/pack.cpp) in place of taxtk's numpy passes.
"""

from __future__ import annotations

import numpy as np

from .. import native

ALPHA = 5  # DNA5
WORD = 32
LANE = 128  # slots per systolic row (one CUDA block of 128 threads)
STAG = 4  # inter-block stagger of the systolic layout, in text steps


def _pow2(x: int) -> int:
    n = 1
    while n < x:
        n <<= 1
    return n


def _dedupe_pool(a_codes, b_codes, a_len, b_len, max_rows=None):
    """Row-dedupe both pair sides into one sequence pool.

    Returns (rows, lens, idx_a, idx_b, keys): `rows` is a list of 1-D uint8
    code arrays (trimmed to each sequence's own length), `idx_a[i]`/
    `idx_b[i]` index the pool entry backing pair i's a/b side, `keys` are
    the content keys (for the cross-round device pool cache, ops/seqpool.py).
    RPA re-aligns the same query/anchor/candidate segments across many pairs
    (pass 0 shares the query, pass 1/2 share anchors), so the pool is
    materially smaller than 2B rows — and, more importantly, the device
    wire arrays become pool-sized instead of padded-pair-group-sized.

    max_rows: short-circuit — return None as soon as the pool exceeds this
    many rows (the caller would discard a pool that wide anyway; hashing
    every byte of a dense unique-pair bucket is pure host overhead).

    Keys include the row length: both sides are uint8 (enforced by the
    public entry points), but byte-identical prefixes of different logical
    lengths must not collide."""
    B = a_codes.shape[0]
    seen: dict = {}
    rows = []
    lens = []
    keys = []
    idx = np.empty(2 * B, np.int32)
    for j, (codes, ls) in enumerate(((a_codes, a_len), (b_codes, b_len))):
        for i in range(B):
            L = int(ls[i])
            key = (L, codes[i, :L].tobytes())
            u = seen.get(key)
            if u is None:
                u = len(rows)
                if max_rows is not None and u >= max_rows:
                    return None
                seen[key] = u
                rows.append(codes[i, :L])
                lens.append(L)
                keys.append(key)
            idx[j * B + i] = u
    return rows, np.asarray(lens, np.int32), idx[:B], idx[B:], keys


def _pool_indices(plen, idx_a, idx_b, swap, B, Bp, K, Up):
    """Per-pair pool indices + per-entry pattern lengths shared by the
    host-packed and device-pool wire paths."""
    pat_idx = np.zeros(Bp, np.int32)
    txt_idx = np.zeros(Bp, np.int32)
    pat_idx[:B] = np.where(swap, idx_b, idx_a)
    txt_idx[:B] = np.where(swap, idx_a, idx_b)
    U = len(plen)
    pat_used = np.zeros(U, bool)
    txt_used = np.zeros(U, bool)
    pat_used[pat_idx[:B]] = True
    txt_used[txt_idx[:B]] = True
    # pattern codes read to the pattern extent (K*WORD), independent of
    # the (possibly much taller) text pool height
    plen_cap = np.minimum(plen, K * WORD).astype(np.int32)
    plen_pat = np.where(pat_used[:U], plen_cap[:U], 0)
    plen_pat = np.concatenate([plen_pat, np.zeros(Up - U, np.int32)])
    return pat_idx, txt_idx, plen_pat, plen_cap, pat_used, txt_used


def _build_pool_wire(rows, plen, idx_a, idx_b, swap, B, Bp, K, Np, Up,
                     bits=4):
    """Shared pool->wire construction for the single-launch and
    pattern-block-chunked entry points: per-pair pool indices, used-entry
    masks, the packed PATTERN CODES pool (peq planes are built on device —
    shipping [K, ALPHA, Up] u32 peq was the dominant wire term after the
    text packing, and packed codes are 2.5x/1.25x smaller at bits=2/4),
    and the packed text pool."""
    pat_idx, txt_idx, plen_pat, plen_cap, pat_used, txt_used = _pool_indices(
        plen, idx_a, idx_b, swap, B, Bp, K, Up
    )
    pat_u = _pack_text_pool(rows, plen_cap, pat_used, K * WORD, Up, bits)
    text_u = _pack_text_pool(rows, plen, txt_used, Np, Up, bits)
    return pat_u, plen_pat, text_u, pat_idx, txt_idx


def _pack_text_pool(rows, lens, txt_used, Np, Up, bits=4):
    """Pool rows -> [Np*bits//8, Up] packed codes (2 or 4 per byte, pad
    field = all-ones beyond each row's own length; see _pack_text for why
    bits=2 pad is inert).  Only entries used as a text (txt_used mask) are
    materialized; pattern-only entries stay all-pad.

    The packing is one pass of the port's host C++
    (`native/pack.cpp::taxtk_pack_text_pool`) straight into the wire
    layout; here only each used row's pointer and length are gathered.
    Raises ValueError where a used row needs more than Np codes or Up is
    below the row count."""
    lib = native.load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    U = len(rows)
    cpb = 8 // bits
    lens_c = np.zeros(U, np.int64)
    ptrs = np.zeros(U, np.uintp)
    keep = []  # rows copied to contiguous uint8, alive through the call
    for u in np.flatnonzero(np.asarray(txt_used, bool)[:U]):
        L = int(lens[u])
        if not L:
            continue
        r = rows[u]
        if r.dtype != np.uint8 or r.strides[0] != 1:
            r = np.ascontiguousarray(r[:L], np.uint8)
            keep.append(r)
        if len(r) < L:
            raise ValueError(f"row {u} holds {len(r)} codes, not {L}")
        lens_c[u] = L
        ptrs[u] = r.ctypes.data
    packed = np.empty((Np // cpb, Up), np.uint8)
    if lib.taxtk_pack_text_pool(ptrs.ctypes.data, lens_c.ctypes.data, U,
                                bits, Np // cpb, Up, packed.ctypes.data):
        raise ValueError(f"cannot pack {U} rows of up to "
                         f"{int(lens_c.max(initial=0))} codes at {bits} bits "
                         f"into [{Np // cpb}, {Up}]")
    return packed.view(np.int8)


def _pack_systolic(a_codes, b_codes, a_len, b_len, KC, build_pools=True,
                   bits=4):
    """Assign (pair, block) slots to lanes row by row and build the
    kernel's WIRE arrays: packed per-pair pattern/text code columns plus
    small per-slot metadata [n_rows, LANE] (one row per CUDA block; the
    TPU's sublane tiling and scalar-prefetched per-tile stop are gone —
    each block finds its own last live step).  inputs["pair_slots"] is the
    per-pair table [B, 2] int32 of (first flat slot row*LANE + lane, slot
    count) that the CUDA kernel's block-per-pair launch reads.
    Returns (inputs dict, (n_rows, Np, nbmax))."""
    B = len(a_len)
    swap = a_len > b_len
    m_len = np.where(swap, b_len, a_len).astype(np.int32)
    n_len = np.where(swap, a_len, b_len).astype(np.int32)
    patterns = [
        (a_codes[i, : a_len[i]] if not swap[i] else b_codes[i, : b_len[i]])
        for i in range(B)
    ]
    texts = [
        (b_codes[i, : b_len[i]] if not swap[i] else a_codes[i, : a_len[i]])
        for i in range(B)
    ]
    nb = np.maximum(1, -(-np.maximum(m_len, 1) // (KC * WORD)))

    # greedy row packing: pairs in descending nb order, first row with room
    order = sorted(range(B), key=lambda i: -int(nb[i]))
    rows_free: list[int] = []
    slot_of = {}
    for i in order:
        need = int(nb[i])
        if need > LANE:
            raise ValueError("pattern exceeds systolic row capacity")
        for r in range(len(rows_free)):
            if rows_free[r] >= need:
                break
        else:
            rows_free.append(LANE)
            r = len(rows_free) - 1
        slot_of[i] = (r, LANE - rows_free[r])
        rows_free[r] -= need

    n_rows = len(rows_free)
    R = n_rows

    # per-slot metadata, vectorized over a flat slot list
    pair_arr = np.concatenate([np.full(int(nb[i]), i) for i in range(B)])
    k_arr = np.concatenate([np.arange(int(nb[i])) for i in range(B)])
    r_arr = np.array([slot_of[i][0] for i in pair_arr])
    l_arr = np.array([slot_of[i][1] for i in pair_arr]) + k_arr

    head = np.zeros((R, LANE), np.int32)
    lanek = np.zeros((R, LANE), np.int32)
    nlen_l = np.zeros((R, LANE), np.int32)
    mlen_l = np.ones((R, LANE), np.int32)
    mword = np.full((R, LANE), -1, np.int32)  # outside [0,KC): no hmask
    mbit = np.zeros((R, LANE), np.int32)
    # device-gather columns: pattern peq col (k*(B+1)+pair) and text col
    peq_col = np.zeros((R, LANE), np.int32)  # default: zero column B
    txt_col = np.full((R, LANE), B, np.int32)

    B1 = _pow2(B + 1)  # pow2 pool-column count (bounded jit statics)
    kend = (np.maximum(m_len, 1) - 1) >> 5
    lanek[r_arr, l_arr] = STAG * k_arr  # pre-scaled block stagger
    nlen_l[r_arr, l_arr] = n_len[pair_arr]
    mlen_l[r_arr, l_arr] = m_len[pair_arr]
    rel = kend[pair_arr] - k_arr * KC
    endslot = (rel >= 0) & (rel < KC)
    mword[r_arr[endslot], l_arr[endslot]] = rel[endslot]
    mbit[r_arr[endslot], l_arr[endslot]] = (
        (m_len[pair_arr[endslot]] - 1) & 31
    )
    peq_col[r_arr, l_arr] = k_arr * B1 + pair_arr
    unused = nlen_l == 0
    peq_col[unused] = B  # an all-pad zero column (plen 0)
    is_head = k_arr == 0
    head[r_arr[is_head], l_arr[is_head]] = 1
    txt_col[r_arr[is_head], l_arr[is_head]] = pair_arr[is_head]
    first = np.array([slot_of[i][0] * LANE + slot_of[i][1] for i in range(B)],
                     np.int32)
    pair_slots = np.stack([first, nb.astype(np.int32)], 1)

    # steps must cover every lane's window: n_len + STAG * (nb - 1); the
    # text extent rounds them up to whole trips (and whole packed bytes)
    steps_needed = int((n_len + STAG * (nb - 1)).max(initial=0)) + 1
    Np = -(-steps_needed // STAG) * STAG

    # pow2 pool-column and block counts, as in taxtk (they fix the pool
    # height class and so the pool residency); pad columns are all-0xFF
    # with plen 0 (zero peq planes)
    nbmax = _pow2(int(nb.max(initial=1)))
    K_full = nbmax * KC
    plen_pat = np.zeros(B1, np.int32)
    plen_pat[:B] = np.minimum(m_len, K_full * WORD)
    pat_u = text_u = None
    if build_pools:  # the pool-cache front end gathers from the
        all_used = np.ones(B, bool)  # device-resident pool instead
        pat_u = _pack_text_pool(patterns, plen_pat[:B], all_used,
                                K_full * WORD, B1, bits=bits)
        text_u = _pack_text_pool(texts, n_len, all_used, Np, B1, bits=bits)

    inputs = dict(
        pat_u=pat_u, text_u=text_u, plen_pat=plen_pat,
        peq_col=peq_col.reshape(-1), txt_col=txt_col.reshape(-1),
        head=head, lanek=lanek, nlen=nlen_l, mword=mword, mbit=mbit,
        mlen=mlen_l, pair_slots=pair_slots,
    )
    return inputs, (n_rows, Np, nbmax)


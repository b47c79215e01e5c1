"""Plain PyTorch realignment for the benchmark's reference.

Nothing here imports the program.  Two functions of the RPA's pairwise
realignment, each over a ragged list of pairs of small-integer code arrays:

  * `edit_distances`: unit-cost global edit distance (Levenshtein), by the
    bit-vector recurrence of Myers (1999) in the block form of Hyyro (2003):
    32-row words, each word taking its horizontal carry from the word above
    at the same text column.  Words of one pair run as a wavefront (word w
    works on column s - w at step s), every word of every pair in one flat
    vector, longest pairs first, so that a step touches only the words of
    pairs still running.
  * `protein_stats`: global alignment with BLOSUM62 and a linear gap of -1,
    forward over anti-diagonals, carrying beside each cell's score the
    match count and diagonal-step count of its preferred predecessor
    (diagonal, then a step along b, then a step along a), which is what a
    traceback from the last cell with that preference counts.

Both run on whatever device their tensors are given.
"""

from __future__ import annotations

import numpy as np
import torch

WORD = 32
ALPHABET = 5  # DNA codes A, C, G, T, N
GRAPH_STEPS = 128

# NCBI BLOSUM62 over the 20 standard residues, in the order below
AA20 = "ACDEFGHIKLMNPQRSTVWY"
_B62 = """
 4  0 -2 -1 -2  0 -2 -1 -1 -1 -1 -2 -1 -1 -1  1  0  0 -3 -2
 0  9 -3 -4 -2 -3 -3 -1 -3 -1 -1 -3 -3 -3 -3 -1 -1 -1 -2 -2
-2 -3  6  2 -3 -1 -1 -3 -1 -4 -3  1 -1  0 -2  0 -1 -3 -4 -3
-1 -4  2  5 -3 -2  0 -3  1 -3 -2  0 -1  2  0  0 -1 -2 -3 -2
-2 -2 -3 -3  6 -3 -1  0 -3  0  0 -3 -4 -3 -3 -2 -2 -1  1  3
 0 -3 -1 -2 -3  6 -2 -4 -2 -4 -3  0 -2 -2 -2  0 -2 -3 -2 -3
-2 -3 -1  0 -1 -2  8 -3 -1 -3 -2  1 -2  0  0 -1 -2 -3 -2  2
-1 -1 -3 -3  0 -4 -3  4 -3  2  1 -3 -3 -3 -3 -2 -1  3 -3 -1
-1 -3 -1  1 -3 -2 -1 -3  5 -2 -1  0 -1  1  2  0 -1 -2 -3 -2
-1 -1 -4 -3  0 -4 -3  2 -2  4  2 -3 -3 -2 -2 -2 -1  1 -2 -1
-1 -1 -3 -2  0 -3 -2  1 -1  2  5 -2 -2  0 -1 -1 -1  1 -1 -1
-2 -3  1  0 -3  0  1 -3  0 -3 -2  6 -2  0  0  1  0 -3 -4 -2
-1 -3 -1 -1 -4 -2 -2 -3 -1 -3 -2 -2  7 -1 -2 -1 -1 -2 -4 -3
-1 -3  0  2 -3 -2  0 -3  1 -2  0  0 -1  5  1  0 -1 -2 -2 -1
-1 -3 -2  0 -3 -2  0 -3  2 -2 -1  0 -2  1  5 -1 -1 -3 -3 -2
 1 -1  0  0 -2  0 -1 -2  0 -2 -1  1 -1  0 -1  4  1 -2 -3 -2
 0 -1 -1 -1 -2 -2 -2 -1 -1 -1 -1  0 -1 -1 -1  1  5  0 -2 -2
 0 -1 -3 -2 -1 -3 -3  3 -2  1  1 -3 -2 -2 -3 -2  0  4 -3 -1
-3 -2 -4 -3  1 -2 -2 -3 -3 -2 -1 -4 -4 -2 -3 -3 -2 -3 11  2
-2 -2 -3 -2  3 -3  2 -1 -2 -1 -1 -2 -3 -1 -2 -2 -2 -1  2  7
"""
BLOSUM62 = np.array([[int(x) for x in row.split()]
                     for row in _B62.strip().splitlines()], np.int64)
GAP = -1


def edit_distances(pairs, device):
    """Global edit distance of each (a, b) pair of code arrays (codes below
    ALPHABET; equal codes match).  Returns int64 numpy [len(pairs)].

    The pattern (the shorter side) sits at the bottom of its W words: the
    rows above it match nothing and start with a vertical delta of 0, so
    they pass the top row's +1 down unchanged, and the pattern's last row
    is bit 31 of its last word, whose horizontal carry-out is the
    distance's step at each text column.  A word that has not reached the
    text yet reads a null symbol with no carry-in and keeps its state.  On
    a CUDA device the steps run as replayed CUDA graphs of GRAPH_STEPS
    steps each."""
    out = np.zeros(len(pairs), np.int64)
    jobs = []
    for k, (a, b) in enumerate(pairs):
        p, t = (a, b) if len(a) <= len(b) else (b, a)
        if len(p) == 0:
            out[k] = len(t)
        else:
            jobs.append((k, np.asarray(p, np.int64), np.asarray(t, np.int64)))
    if not jobs:
        return out
    null = ALPHABET  # a symbol no pattern row matches
    words = np.array([-(-len(p) // WORD) for _, p, _ in jobs])
    tlen = np.array([len(t) for _, _, t in jobs])
    # a pair runs for len(t) + W - 1 steps; the longest-running first, so
    # that the pairs still running at any step are a prefix
    order = np.argsort(-(tlen + words - 1), kind="stable")
    ends = (tlen + words - 1)[order]
    peq_rows, pv_rows, base, texts, last = [], [], [], [], []
    e = off = 0
    for j in order:
        _, p, t = jobs[j]
        W = int(words[j])
        rows = np.full(W * WORD, -1, np.int64)
        rows[W * WORD - len(p):] = p
        bits = rows.reshape(W, WORD)[:, None, :] == np.arange(
            ALPHABET + 1)[None, :, None]
        weights = np.int64(1) << np.arange(WORD, dtype=np.int64)
        peq_rows.append((bits.astype(np.int64) * weights).sum(-1))
        pv_rows.append(((rows.reshape(W, WORD) >= 0).astype(np.int64)
                        * weights).sum(-1))
        # text laid out as W nulls, then the text: word w reads column s - w
        base.append(off + W - np.arange(W))
        texts.append(np.full(W, null, np.int64))
        texts.append(t)
        off += W + len(t)
        e += W
        last.append(e - 1)
    steps = int(ends[0])
    texts.append(np.full(steps + GRAPH_STEPS + 1, null, np.int64))
    dev = torch.device(device)

    def i32(x):
        x = np.asarray(x, np.int64)
        x = np.where(x >= 1 << 31, x - (1 << 32), x)  # the same 32 bits
        return torch.as_tensor(x.astype(np.int32), device=dev)

    peq = i32(np.concatenate(peq_rows)).reshape(e, ALPHABET + 1)
    pv = i32(np.concatenate(pv_rows))
    mv = torch.zeros(e, dtype=torch.int32, device=dev)
    base = torch.as_tensor(np.concatenate(base), device=dev)
    text = torch.as_tensor(np.concatenate(texts), device=dev)
    first = torch.zeros(e, dtype=torch.bool, device=dev)
    first[torch.as_tensor(np.array(last) - words[order] + 1, device=dev)] = True
    hbuf = torch.zeros(e + 1, dtype=torch.int32, device=dev)
    last_t = torch.as_tensor(np.array(last), device=dev)
    ends_t = torch.as_tensor(ends, device=dev)
    acc = torch.zeros(len(order), dtype=torch.int32, device=dev)
    step = torch.zeros((), dtype=torch.int64, device=dev)
    cum_words = np.cumsum(words[order])

    def body(E, P):
        c = text[base[:E] + step]
        eq = peq[:E].gather(1, c[:, None])[:, 0]
        hin = torch.where(first[:E], 1, hbuf[:E])
        neg = (hin >> 1) & 1
        pos = (hin + 1) >> 1
        P_, M_ = pv[:E], mv[:E]
        xv = eq | M_
        eq = eq | neg
        xh = (((eq & P_) + P_) ^ P_) | eq
        ph = M_ | ~(xh | P_)
        mh = P_ & xh
        torch.sub(mh >> 31, ph >> 31, out=hbuf[1 : E + 1])
        ph = (ph << 1) | pos
        mh = (mh << 1) | neg
        torch.bitwise_or(mh, ~(xv | ph), out=pv[:E])
        torch.bitwise_and(ph, xv, out=mv[:E])
        acc[:P] += hbuf[last_t[:P] + 1] * (ends_t[:P] > step)
        step.add_(1)

    def live(s):  # pairs still running at step s, and their words
        P = int(np.searchsorted(-ends, -s, side="left"))
        return P, int(cum_words[P - 1])

    if dev.type == "cuda":
        graphs = {}
        s = 0
        while s < steps:
            P, _ = live(s)
            P = _ladder(P, len(order))
            E = int(cum_words[P - 1])
            if P not in graphs:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    for _ in range(GRAPH_STEPS):
                        body(E, P)
                graphs[P] = g
                # capture ran nothing: the graph replays from this step
            graphs[P].replay()
            s += GRAPH_STEPS
        torch.cuda.synchronize()
    else:
        for s in range(steps):
            P, E = live(s)
            body(E, P)
    lens = np.array([len(jobs[j][1]) for j in order], np.int64)
    res = lens + acc.cpu().numpy().astype(np.int64)
    for r, j in enumerate(order):
        out[jobs[j][0]] = res[r]
    return out


def _ladder(n, total):
    """The smallest of a geometric ladder of pair counts (1.25x apart, the
    total the top rung) at or above n: CUDA graphs are captured once per
    rung."""
    rung = total
    while rung > 1 and int(rung / 1.25) >= n:
        rung = int(rung / 1.25)
    return max(rung, n)


def protein_stats(pairs, device):
    """(score, matches, diagonal steps) of the global BLOSUM62 alignment of
    each (a, b) pair of residue codes (indices into AA20).  Returns int64
    numpy [3, len(pairs)]; an empty side gives the all-gap score and no
    stats."""
    out = np.zeros((3, len(pairs)), np.int64)
    buckets = {}
    for k, (a, b) in enumerate(pairs):
        if len(a) == 0 or len(b) == 0:
            out[0, k] = GAP * max(len(a), len(b))
            continue
        L = 16
        while L < max(len(a), len(b)):
            L <<= 1
        buckets.setdefault(L, []).append(k)
    dev = torch.device(device)
    subt = torch.as_tensor(BLOSUM62.reshape(-1), device=dev)
    for L, ks in buckets.items():
        for lo in range(0, len(ks), max(1, (1 << 24) // (L * L) * 64)):
            part = ks[lo : lo + max(1, (1 << 24) // (L * L) * 64)]
            res = _nw_bucket([pairs[k] for k in part], L, subt, dev)
            out[:, part] = res
    return out


def _nw_bucket(pairs, L, subt, dev):
    B = len(pairs)
    A = np.zeros((B, L), np.int64)
    Bc = np.zeros((B, L), np.int64)
    la = np.array([len(a) for a, _ in pairs], np.int64)
    lb = np.array([len(b) for _, b in pairs], np.int64)
    for r, (a, b) in enumerate(pairs):
        A[r, : len(a)] = a
        Bc[r, : len(b)] = b
    A, Bc = torch.as_tensor(A, device=dev), torch.as_tensor(Bc, device=dev)
    la_t, lb_t = torch.as_tensor(la, device=dev), torch.as_tensor(lb, device=dev)
    n_sym = len(AA20)
    # diagonal d holds cells (i, d - i) for i in 0..L
    i = torch.arange(L + 1, device=dev)
    neg = -(1 << 40)
    big = torch.full((B, L + 1), neg, dtype=torch.int64, device=dev)
    zero = torch.zeros((B, L + 1), dtype=torch.int64, device=dev)
    # diagonal 0: the cell (0, 0)
    s2, m2, g2 = big.clone(), zero.clone(), zero.clone()  # d - 2
    s1 = torch.where(i == 0, 0, neg).expand(B, -1).clone()  # d - 1 = 0
    m1, g1 = zero.clone(), zero.clone()
    res = torch.zeros((3, B), dtype=torch.int64, device=dev)
    target = la_t + lb_t

    def up(x, fill):  # value of cell (i - 1, .) at index i
        return torch.cat([torch.full((B, 1), fill, dtype=x.dtype,
                                     device=dev), x[:, :-1]], 1)

    for d in range(1, 2 * L + 1):
        j = d - i  # column of each cell
        inside = (j >= 0) & (j <= L)
        ai = A.gather(1, (i - 1).clamp(0, L - 1).expand(B, -1))
        bj = Bc.gather(1, (j - 1).clamp(0, L - 1).expand(B, -1))
        dscore = up(s2, neg) + subt[ai * n_sym + bj]
        hscore = s1 + GAP  # from (i, j - 1): a step along b
        vscore = up(s1, neg) + GAP  # from (i - 1, j): a step along a
        best = torch.maximum(torch.maximum(dscore, hscore), vscore)
        take_d = dscore == best
        take_h = ~take_d & (hscore == best)
        mat = (ai == bj).to(torch.int64)
        nm = torch.where(take_d, up(m2, 0) + mat,
                         torch.where(take_h, m1, up(m1, 0)))
        ng = torch.where(take_d, up(g2, 0) + 1,
                         torch.where(take_h, g1, up(g1, 0)))
        edge = (i == 0) | (j == 0)
        ns = torch.where(edge, GAP * d, best)
        ns = torch.where(inside, ns, neg)
        nm = torch.where(edge | ~inside, 0, nm)
        ng = torch.where(edge | ~inside, 0, ng)
        done = target == d
        pick = la_t[:, None]
        res[0] = torch.where(done, ns.gather(1, pick)[:, 0], res[0])
        res[1] = torch.where(done, nm.gather(1, pick)[:, 0], res[1])
        res[2] = torch.where(done, ng.gather(1, pick)[:, 0], res[2])
        s2, m2, g2, s1, m1, g1 = s1, m1, g1, ns, nm, ng
    return res.cpu().numpy()

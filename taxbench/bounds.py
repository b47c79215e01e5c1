"""Least device time of a kernel's work, from the shapes of its calls.

Copies of chip_smoke.py's counts (bench_torch.py holds the same numbers):
the essential INT32 instructions of each recurrence, counted once per
pair from its real lengths, over the card's integer issue rate (SMs x 128
lanes x the maximum SM clock), against the bytes each input and output
moves once over HBM's 3.35 TB/s (H100 SXM data sheet).  The larger of the
two is the bound: the same work, whatever implements it.
"""

from __future__ import annotations

import re

import numpy as np

MEM_RATE = 3.35e12  # H100 SXM HBM3, bytes/s
INT32_LANES_PER_SM = 128
# Myers: the word's match mask, its MH carry-in OR, Xv, Eq & Pv, the add,
# Xh and Ph, Mh, the PH and MH shift-ins, Pv, Mv and the MH carry-out
# shift, per 32-cell word per text char
OPS_PER_WORD_CHAR = 13
# protein DP: two adds, an add-max, a max, three compares, two selects and
# one add of both stat increments per cell; two cells a word (13
# instructions) where every score of the bucket fits a 16-bit half
OPS_PER_CELL = 9
SWAR_OPS_PER_CELL = 13 / 2


def real_pairs(a_len, b_len):
    """Rows of a call less the aligner's trailing 1 x 1 dummy rows."""
    a_len, b_len = np.asarray(a_len), np.asarray(b_len)
    keep = np.flatnonzero((a_len != 1) | (b_len != 1))
    n = int(keep[-1]) + 1 if len(keep) else 0
    return a_len[:n].astype(np.int64), b_len[:n].astype(np.int64)


def myers_bound_s(a_len, b_len, bits, int_rate):
    """Bound of the Myers edit distance of these pairs: 13 instructions a
    32-cell word a char; bytes: the packed text, the peq words of five
    symbols, five int32 of metadata and result a pair."""
    a, b = real_pairs(a_len, b_len)
    m, n = np.minimum(a, b), np.maximum(a, b)
    words = -(-m // 32)
    ops_s = OPS_PER_WORD_CHAR * float((n * words).sum()) / int_rate
    nbytes = float((-(-n // (8 // bits))).sum() + (words * 5 * 4).sum()
                   + len(m) * 5 * 4)
    return max(ops_s, nbytes / MEM_RATE)


def template_args(launch):
    """The integer template arguments of a launched kernel's name in the
    profiler's trace: (2, 3) of `void myers_systolic_kernel<2, 3>(...)`."""
    m = re.search(r"<([-\d,\s]+)>", launch)
    if m is None:
        raise ValueError(f"no template arguments in the launch {launch!r}")
    return tuple(int(x) for x in m.group(1).split(","))


def swar_fits(M, N):
    """The v6 domain of an (M, N) bucket: every score fits a 16-bit half
    (patterns padded to 128 lanes)."""
    Mp = -(-max(M, 1) // 128) * 128
    return (Mp + max(N, 1) + 8) + 11 * Mp < (1 << 14)


def protein_bound_s(a_len, b_len, M, N, int_rate):
    """Bound of the BLOSUM62 DP of these pairs in an (M, N) bucket; bytes:
    the codes of both sides, four int32 of input and the int32 [3] result
    a pair."""
    a, b = real_pairs(a_len, b_len)
    per_cell = SWAR_OPS_PER_CELL if swar_fits(M, N) else OPS_PER_CELL
    ops_s = per_cell * float((a * b).sum()) / int_rate
    return max(ops_s, float((a + b).sum() + 28 * len(a)) / MEM_RATE)

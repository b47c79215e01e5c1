"""Batched global protein alignment (BLOSUM62, linear gaps) in plain PyTorch.

Port of taxtk/ops/protein_align.py: the anti-diagonal wavefront of
`_protein_kernel` (:30-110) and its entry `batched_protein_align` (:112-178)
with the reference's float32 post.  Beside the score it carries two stat
wavefronts, the match count and the diagonal-step count of the preferred
optimal path, so the traceback statistics come out of the forward pass:
with D diagonal steps, gap columns = lenA + lenB - 2D and mismatches =
D - matches.  Tie-break as SeqAn: diagonal > consume-B > consume-A.

`nw_stats` takes its substitution and match rules as 32 x 32 tables over
the 5-bit code space (codes clamped to 31), so the same recurrence is the
`wavefront` backend (REF_SUB/REF_MATCH: an out-of-alphabet b code reads
column 0 and matches nothing, as `_protein_kernel` has it) and the plain
version of both protein kernels (ops/protein_cuda.py: the v5 table, where
sentinel codes score -4).  The two agree on every code below 27.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .blosum import BLOSUM62, GAP_SCORE
from .transfer import h2d

AA_N = BLOSUM62.shape[0]  # 27 residue codes
CODES = 32  # 5-bit clamped code space
_NEG = -(1 << 24)


def _ref_tables():
    cols = np.arange(CODES)
    sub = np.full((CODES, CODES), -4, np.int32)  # rows >= 27 are never compared
    sub[:AA_N] = BLOSUM62[:, np.where(cols < AA_N, cols, 0)]
    match = (cols[:, None] == cols[None, :]) & (cols[None, :] < AA_N)
    return sub, match


REF_SUB, REF_MATCH = _ref_tables()


def nw_stats(a, b, a_len, b_len, sub, match) -> torch.Tensor:
    """Score + traceback-stat wavefront over a padded batch.

    a [B, M], b [B, N]: integer codes (any value; clamped to 31); a_len,
    b_len [B]; sub [32, 32] int and match [32, 32] bool tables.  Returns
    int32 [3, B]: mutual score, matches, diagonal steps.  An empty side
    gives the all-gap score gap * max(a_len, b_len) and zero stats."""
    dev = a.device
    B, M = a.shape
    N = b.shape[1]
    gap = GAP_SCORE
    a_len = a_len.to(dev, torch.int64)
    b_len = b_len.to(dev, torch.int64)
    sub = torch.as_tensor(sub, dtype=torch.int32, device=dev).reshape(-1)
    match = torch.as_tensor(match, device=dev).reshape(-1).to(torch.int32)
    a_ext = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                       a.to(torch.int64).clamp(0, CODES - 1)], 1) * CODES
    pad = torch.full((B, M + 1), CODES - 1, dtype=torch.int64, device=dev)
    rbp = torch.cat([pad, b.to(torch.int64).clamp(0, CODES - 1).flip(1), pad],
                    1)
    i_idx = torch.arange(M + 1, device=dev)[None, :]
    neg = torch.full((B, 1), _NEG, dtype=torch.int32, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def shift(x, fill):
        return torch.cat([fill, x[:, :-1]], 1)

    zeros = torch.zeros((B, M + 1), dtype=torch.int32, device=dev)
    s_prev = torch.where(i_idx == 0, 0, _NEG).to(torch.int32).expand(B, -1)
    s_pp = ma_prev = ma_pp = dc_prev = dc_pp = zeros
    res_s = (gap * torch.maximum(a_len, b_len)).to(torch.int32)
    res_ma = torch.zeros(B, dtype=torch.int32, device=dev)
    res_dc = res_ma
    done_at = a_len + b_len
    lane = a_len.clamp(max=M)[:, None]
    for d in range(1, M + N + 1):
        start = M + 1 + N - d
        idx = a_ext + rbp[:, start:start + M + 1]
        sub_v = sub[idx]
        is_match = match[idx]
        s_pp_s = shift(s_pp, neg)
        s_prev_s = shift(s_prev, neg)
        ma_prev_s = shift(ma_prev, zero)
        dc_prev_s = shift(dc_prev, zero)
        d_val = s_pp_s + sub_v
        v_val = s_prev_s + gap  # consume an A char (gap column in B)
        h_val = s_prev + gap  # consume a B char (gap column in A)
        best = torch.maximum(torch.maximum(d_val, v_val), h_val)
        take_d = d_val == best
        take_h = (~take_d) & (h_val == best)
        new_ma = torch.where(take_d, shift(ma_pp, zero) + is_match,
                             torch.where(take_h, ma_prev, ma_prev_s))
        new_dc = torch.where(take_d, shift(dc_pp, zero) + 1,
                             torch.where(take_h, dc_prev, dc_prev_s))
        # boundary row and column: all-gap prefixes
        on_edge = (i_idx == 0) | (i_idx == d)
        new_s = torch.where(on_edge, gap * d, best).to(torch.int32)
        new_ma = torch.where(on_edge, 0, new_ma).to(torch.int32)
        new_dc = torch.where(on_edge, 0, new_dc).to(torch.int32)
        done = done_at == d
        res_s = torch.where(done, new_s.gather(1, lane)[:, 0], res_s)
        res_ma = torch.where(done, new_ma.gather(1, lane)[:, 0], res_ma)
        res_dc = torch.where(done, new_dc.gather(1, lane)[:, 0], res_dc)
        s_pp, s_prev = s_prev, new_s
        ma_pp, ma_prev = ma_prev, new_ma
        dc_pp, dc_prev = dc_prev, new_dc
    return torch.stack([res_s, res_ma, res_dc])


def batched_protein_align(a_codes, b_codes, a_len, b_len, device="cuda",
                          lazy=False):
    """Protein alignment for a padded batch (port of
    protein_align.batched_protein_align).

    Returns a dict of numpy arrays: mutual score, matches, mismatches,
    gaps, length, and the reference's float32 distance/similarity
    normalization (selfscore from the BLOSUM diagonal).  lazy="device"
    returns (int32 [3, B] tensor, post) where post maps the host copy to
    the dict."""
    dev = resolve_device(device)
    a_codes = np.asarray(a_codes)
    b_codes = np.asarray(b_codes)
    a_len = np.asarray(a_len, dtype=np.int32)
    b_len = np.asarray(b_len, dtype=np.int32)
    M = a_codes.shape[1]

    out = nw_stats(
        h2d(a_codes.astype(np.int64), dev),
        h2d(b_codes.astype(np.int64), dev),
        h2d(a_len, dev), h2d(b_len, dev),
        REF_SUB, REF_MATCH,
    )

    def post(st):
        stacked = np.asarray(st)
        mutual, matches, diag = stacked[0], stacked[1], stacked[2]

        mismatches = diag - matches
        gaps = a_len + b_len - 2 * diag
        length = matches + mismatches + gaps

        diag_scores = np.diag(BLOSUM62)
        # selfscore over true (unpadded) lengths
        mask_a = np.arange(M)[None, :] < a_len[:, None]
        mask_b = np.arange(b_codes.shape[1])[None, :] < b_len[:, None]
        self_a = np.where(
            mask_a, diag_scores[np.minimum(a_codes, AA_N - 1)], 0
        ).sum(axis=1)
        self_b = np.where(
            mask_b, diag_scores[np.minimum(b_codes, AA_N - 1)], 0
        ).sum(axis=1)
        selfscore = (self_a + self_b).astype(np.int64)

        normfactor = length.astype(np.float32) / selfscore.astype(np.float32)
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
        return out, post
    return post(out.cpu().numpy())

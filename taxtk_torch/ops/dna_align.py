"""Batched global edit distance as a min-plus anti-diagonal wavefront, in
plain PyTorch.

Port of taxtk/ops/dna_align.py: `_edit_distance_kernel` (:32-69) and its
entry `batched_edit_distance` (:72-90), and `dna_alignment_stats`
(:93-110), copied.  One loop step updates a whole [B, M+1] anti-diagonal
of D[i, j] = min(D[i-1, j] + 1, D[i, j-1] + 1, D[i-1, j-1] + (a != b)),
which touches only the two diagonals before it; each pair's distance is
harvested at d = a_len + b_len, i = a_len.  Codes compare by equality, so
N matches N.  The recurrence runs in int32 with taxtk's _BIG = 1 << 24.

`edit_distance_wavefront` is both the `wavefront` DNA backend (through
`batched_edit_distance`) and the plain version of the min-plus CUDA
kernel (ops/dna_wavefront.py, csrc/dna_wavefront.cu).  The aligner turns
every DNA backend's distances into AlignValues through
`dna_alignment_stats`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .transfer import h2d

_BIG = 1 << 24


def edit_distance_wavefront(a, b, a_len, b_len) -> torch.Tensor:
    """a [B, M], b [B, N] integer codes (padded), a_len/b_len [B]
    -> int32 [B] edit distances, on a's device."""
    dev = a.device
    i32 = torch.int32
    B, M = a.shape
    N = b.shape[1]
    Mp1 = M + 1
    a_len = a_len.to(dev, torch.int64)
    b_len = b_len.to(dev, torch.int64)
    a_ext = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                       a.to(i32)], 1)
    pad = torch.full((B, Mp1), 255, dtype=i32, device=dev)
    rbp = torch.cat([pad, torch.flip(b.to(i32), [1]), pad], 1)
    big = torch.full((B, 1), _BIG, dtype=i32, device=dev)
    i_idx = torch.arange(Mp1, device=dev)[None, :]
    target_d = (a_len + b_len)[:, None]

    def shift_right(x):
        return torch.cat([big, x[:, :-1]], 1)

    prev = torch.where(i_idx == 0, 0, _BIG).to(i32).expand(B, Mp1)
    prevprev = torch.zeros((B, Mp1), dtype=i32, device=dev)
    # covers the a_len + b_len == 0 edge
    result = torch.maximum(a_len, b_len).to(i32)[:, None].expand(B, Mp1)
    for d in range(1, M + N + 1):
        start = Mp1 + N - d
        cost = (a_ext != rbp[:, start : start + Mp1]).to(i32)
        new = torch.minimum(torch.minimum(prev, shift_right(prev)) + 1,
                            shift_right(prevprev) + cost)
        new[:, 0] = d
        if d < Mp1:
            new[:, d] = d
        result = torch.where(target_d == d, new, result)
        prev, prevprev = new, prev
    return result.gather(1, a_len[:, None])[:, 0]


def wavefront_inputs(a_codes, b_codes, a_len, b_len, device):
    """A padded numpy batch as tensors on `device`: uint8 codes, int32
    lengths."""
    return (
        h2d(np.ascontiguousarray(a_codes, np.uint8), device),
        h2d(np.ascontiguousarray(b_codes, np.uint8), device),
        h2d(np.ascontiguousarray(a_len, np.int32), device),
        h2d(np.ascontiguousarray(b_len, np.int32), device),
    )


def batched_edit_distance(a_codes, b_codes, a_len, b_len, device="cuda",
                          lazy=False):
    """Edit distances for a padded batch (port of
    dna_align.batched_edit_distance): a_codes [B, M], b_codes [B, N]
    uint8, lens [B] -> int32 [B] as numpy.  lazy="device" returns (device
    int32 [B] tensor, post) where post maps the host copy to distances."""
    out = edit_distance_wavefront(*wavefront_inputs(
        a_codes, b_codes, a_len, b_len, resolve_device(device)))
    if lazy == "device":
        return out, np.asarray
    return out.cpu().numpy()


def dna_alignment_stats(dist: np.ndarray, a_len: np.ndarray, b_len: np.ndarray):
    """Derive the reference's approximate statistics from the distance
    (reference: taxonpredictionmodelsequence.hh:153-159).  Copy of
    taxtk/ops/dna_align.py::dna_alignment_stats."""
    dist = np.asarray(dist)
    a_len = np.asarray(a_len)
    b_len = np.asarray(b_len)
    lendiff = np.abs(a_len - b_len)
    gaps = lendiff
    mismatches = dist - lendiff
    matches = np.minimum(a_len, b_len) - mismatches
    return {
        "matches": matches,
        "mismatches": mismatches,
        "gaps": gaps,
        "length": matches + mismatches + gaps,
        "distance": dist.astype(np.float32),
        "similarity": matches.astype(np.float32),
    }

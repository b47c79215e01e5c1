"""Min-plus DNA wavefront entry: csrc/dna_wavefront.cu and its plain
version.

Port of taxtk/ops/pallas_dna.py::batched_edit_distance_pallas (:93-128),
taxtk's TPU drop-in for dna_align.batched_edit_distance: exact Levenshtein
distances of a padded batch.  The kernel reads a and b as they are; the
TPU kernel's pad layout (a_ext, the reversed sentinel-padded b, a row
tile) is not built.  No pool: taxtk never gave this backend one.

`dna_wavefront` is the wrapper: on CUDA tensors it launches the kernel and
counts the launch in `dna_wavefront.launches`; on CPU tensors it runs the
plain version, ops/dna_align.py::edit_distance_wavefront.
`kernel_geometry` sets out the launch (rows per lane, warps per band and
band tickets) from the batch's shape.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from . import cuda_build
from .dna_align import edit_distance_wavefront, wavefront_inputs

MAX_LEN = 1 << 23  # the kernel packs D values below 2^24 beside a code
# the kernel's geometry (csrc/dna_wavefront.cu): rows per lane (a template
# argument), warps per band
ROWS_PER_LANE = (4, 8, 16)
# 8 rows a lane for a launch of at least FILL_STRIPS strips of 256 rows
# (warps enough to keep the card's issue busy, where fewer instructions a
# cell win), 4 below (half the serial chain a step, where latency wins);
# chip_smoke.py times both at the engine's largest launch and at one to
# 4,096 pairs
FILL_STRIPS = 1024
MAX_WARPS = 16
# warps per band (chip_smoke.py times 1 to 16 on one long pair, ms_by_nw)
BAND_WARPS = 4


def _lib():
    lib = cuda_build.load("dna_wavefront")
    fn = lib.taxtk_dna_wavefront
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, L, P, L, P, P, P, L, P, P, P, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def kernel_geometry(B, M, N, R=None, nw=None):
    """(R, nw, tickets) of a launch on a [B, M] x [B, N] batch, from its
    shape alone.  R and nw may be forced (chip_smoke.py times each).

    Each pair runs with its longer side as the rows, cut into strips of
    32 * R rows: R = 8 from FILL_STRIPS strips of 256 rows on (B times the
    strips of the widest pair the widths allow), else 4.  A band is nw
    consecutive strips, one block of nw warps: BAND_WARPS, or the most
    strips a pair can have if fewer.  Tickets are band-major: ticket t is
    band t // B of pair t % B, and tickets = B times the most bands a pair
    can have (max(M, N) rows)."""
    side = max(M, N, 1)
    if R is None:
        R = 8 if B * -(-side // 256) >= FILL_STRIPS else 4
    if R not in ROWS_PER_LANE:
        raise ValueError(f"dna_wavefront: R={R} not in {ROWS_PER_LANE}")
    strips_max = -(-side // (32 * R))
    if nw is None:
        nw = min(BAND_WARPS, strips_max)
    elif not 1 <= nw <= MAX_WARPS:
        raise ValueError(f"dna_wavefront: nw={nw} outside [1, {MAX_WARPS}]")
    return R, nw, B * -(-strips_max // nw)


def _check_lengths(a_len, b_len, M, N):
    """Refuse lengths outside [0, M] and [0, N]: the kernel would read and
    write past each pair's rows.  numpy or torch lengths; on CUDA tensors
    this waits for the card."""
    if len(a_len) and bool(((a_len < 0) | (a_len > M) | (b_len < 0)
                            | (b_len > N)).any()):
        raise ValueError(f"dna_wavefront: lengths outside the padded widths "
                         f"{M} and {N}")


def dna_wavefront(a, b, a_len, b_len):
    """Kernel wrapper.  a [B, M], b [B, N] uint8 codes; a_len, b_len int32
    [B] -> int32 [B] distances.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise.  Lengths past the padded widths
    raise."""
    _check_lengths(a_len, b_len, a.shape[1], b.shape[1])
    return _launch(a, b, a_len, b_len)


def _launch(a, b, a_len, b_len):
    """dna_wavefront on lengths already checked (the entry checks them on
    the host); counts its launches in dna_wavefront.launches."""
    if a.device.type == "cpu":
        return edit_distance_wavefront(a, b, a_len, b_len)
    if a.device.type != "cuda":
        raise ValueError(f"dna_wavefront: unsupported device {a.device}")
    B, M = a.shape
    N = b.shape[1]
    for name, t, dt, shape in (("a", a, torch.uint8, (B, M)),
                               ("b", b, torch.uint8, (B, N)),
                               ("a_len", a_len, torch.int32, (B,)),
                               ("b_len", b_len, torch.int32, (B,))):
        if (t.device != a.device or t.dtype != dt or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"dna_wavefront: bad {name}")
    if max(M, N) >= MAX_LEN:
        raise ValueError(f"dna_wavefront: sides of {max(M, N)} codes exceed "
                         f"{MAX_LEN - 1}")
    dev = a.device
    R, nw, tickets = kernel_geometry(B, M, N)
    counters = torch.zeros(tickets + 1, dtype=torch.int32, device=dev)
    width = max(1, min(M, N))  # no pair has more columns (its shorter side)
    rows = torch.empty((B, width), dtype=torch.int32, device=dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch's card
        stream = torch.cuda.current_stream(dev).cuda_stream
        # counters: the ticket, then one progress count per ticket
        rc = _lib()(
            a.data_ptr(), M, b.data_ptr(), N, a_len.data_ptr(),
            b_len.data_ptr(), rows.data_ptr(), width,
            counters.data_ptr() + 4, counters.data_ptr(), out.data_ptr(), B,
            tickets, R, nw, stream,
        )
    cuda_build.check(rc, "dna_wavefront launch")
    dna_wavefront.launches += 1
    return out


dna_wavefront.launches = 0


def batched_edit_distance_wavefront(a_codes, b_codes, a_len, b_len,
                                    device="cuda", lazy=False):
    """Exact batched global edit distance through the min-plus kernel
    (port of batched_edit_distance_pallas).  a_codes [B, M], b_codes
    [B, N] uint8 (padded), lens [B].  lazy="device" returns (device int32
    [B] tensor, post) where post maps the host copy to distances;
    otherwise the distances as numpy."""
    dev = resolve_device(device)
    # checked on the host copy, so the launch needs no wait on the card
    _check_lengths(np.asarray(a_len), np.asarray(b_len),
                   np.shape(a_codes)[1], np.shape(b_codes)[1])
    out = _launch(*wavefront_inputs(a_codes, b_codes, a_len, b_len, dev))
    if lazy == "device":
        return out, np.asarray
    return out.cpu().numpy()

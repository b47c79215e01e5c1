"""Copy of taxtk/native/__init__.py: the port keeps its own copy and imports nothing of taxtk.

Native (C++) host runtime components, loaded via ctypes.

Built on demand with g++ (no pip deps) into one library from `_SRCS`:
`myers.cpp` and `protein.cpp` are copies of taxtk/native's; `pack.cpp` is
the port's own, with no taxtk original.  Provides:
  * Myers bit-vector edit distance (single pair + batch) — the CPU baseline
    the TPU kernels are benchmarked against, and a host aligner fallback.
  * `taxtk_pack_text_pool`, the sequence pool's wire layout packed in one
    pass (pack.cpp; wrapped by ops/host.py::_pack_text_pool).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_HERE, "libtaxtk_native.so")
_SRCS = [os.path.join(_HERE, n) for n in ("myers.cpp", "protein.cpp", "pack.cpp")]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_atomic(cmd, lib_path: str) -> bool:
    """Run g++ command `cmd` (without its -o) into a temporary file beside
    `lib_path` and move it into place, so that processes building at the
    same time never load a half-written library.  False if g++ fails."""
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        subprocess.run([*cmd, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, lib_path)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build() -> bool:
    return build_atomic(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
         *_SRCS],
        _LIB_PATH,
    )


def load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < max(
            os.path.getmtime(s) for s in _SRCS
        ):
            if not _build():
                return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.taxtk_myers_edit_distance.restype = ctypes.c_int
        lib.taxtk_myers_edit_distance.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        lib.taxtk_myers_batch.restype = None
        lib.taxtk_myers_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        try:
            lib.taxtk_myers_batch_mt.restype = None
            lib.taxtk_myers_batch_mt.argtypes = (
                lib.taxtk_myers_batch.argtypes + [ctypes.c_int]
            )
            lib.taxtk_build_peq.restype = None
            lib.taxtk_build_peq.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int,
            ]
        except AttributeError:  # pragma: no cover - stale .so
            pass
        lib.taxtk_pack_text_pool.restype = ctypes.c_int
        lib.taxtk_pack_text_pool.argtypes = [
            ctypes.c_void_p,  # const uint8_t* const* rows
            ctypes.c_void_p,  # const int64_t* lens
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,  # uint8_t* out
        ]
        try:
            lib.taxtk_protein_nw_traceback.restype = ctypes.c_int
            lib.taxtk_protein_nw_traceback.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_char_p,
            ]
        except AttributeError:  # pragma: no cover - stale .so
            pass
        try:
            lib.taxtk_protein_nw_batch.restype = None
            lib.taxtk_protein_nw_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int,
            ]
        except AttributeError:  # pragma: no cover - stale .so
            pass
        _lib = lib
        return _lib


def build_peq_native(patterns: np.ndarray, m_len: np.ndarray, K: int,
                     alpha: int) -> Optional[np.ndarray]:
    """peq[k, c, b] bit masks via the C++ single-pass builder; None if the
    native library is unavailable."""
    lib = load()
    if lib is None or not hasattr(lib, "taxtk_build_peq"):
        return None
    patterns = np.ascontiguousarray(patterns, np.uint8)
    m_len = np.ascontiguousarray(m_len, np.int32)
    B, Mpad = patterns.shape
    peq = np.zeros((K, alpha, B), np.uint32)
    lib.taxtk_build_peq(
        patterns.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        B,
        Mpad,
        m_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        K,
        alpha,
        peq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        os.cpu_count() or 1,
    )
    return peq


def myers_edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    lib = load()
    assert lib is not None, "native library unavailable"
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    return lib.taxtk_myers_edit_distance(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(a),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(b),
    )


def myers_batch(pairs, n_threads: int = 0) -> np.ndarray:
    """pairs: list of (a_codes, b_codes) uint8 arrays -> int32 distances.

    n_threads: 0 = all cores (dynamic work-stealing in C++), 1 = the
    single-core baseline path (used by bench.py as the CPU reference)."""
    lib = load()
    assert lib is not None, "native library unavailable"
    if n_threads == 0:
        n_threads = os.cpu_count() or 1
    n = len(pairs)
    a_flat = np.concatenate([np.ascontiguousarray(a, np.uint8) for a, _ in pairs]) if n else np.zeros(0, np.uint8)
    b_flat = np.concatenate([np.ascontiguousarray(b, np.uint8) for _, b in pairs]) if n else np.zeros(0, np.uint8)
    a_len = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    b_len = np.array([len(b) for _, b in pairs], dtype=np.int32)
    a_off = np.zeros(n, dtype=np.int64)
    b_off = np.zeros(n, dtype=np.int64)
    if n > 1:
        a_off[1:] = np.cumsum(a_len[:-1])
        b_off[1:] = np.cumsum(b_len[:-1])
    out = np.zeros(n, dtype=np.int32)
    if n == 0:
        return out
    if len(a_flat) == 0:
        a_flat = np.zeros(1, np.uint8)
    if len(b_flat) == 0:
        b_flat = np.zeros(1, np.uint8)
    args = (
        a_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        a_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n_threads > 1 and hasattr(lib, "taxtk_myers_batch_mt"):
        lib.taxtk_myers_batch_mt(*args, n_threads)
    else:
        lib.taxtk_myers_batch(*args)
    return out


def protein_nw_traceback(a: np.ndarray, b: np.ndarray) -> Optional[str]:
    """SeqAn-exact global-NW traceback column codes (M/X/A/B) for one
    protein pair (codes over ops.blosum.AA_ORDER); None if the native
    library is unavailable (callers fall back to the Python DP)."""
    from ..ops.blosum import BLOSUM62, GAP_SCORE

    lib = load()
    if lib is None or not hasattr(lib, "taxtk_protein_nw_traceback"):
        return None
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    sub = np.ascontiguousarray(BLOSUM62, np.int8)
    out = ctypes.create_string_buffer(len(a) + len(b) + 1)
    k = lib.taxtk_protein_nw_traceback(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(a),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(b),
        sub.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        sub.shape[0], GAP_SCORE, out,
    )
    return out.raw[:k].decode("ascii")


def protein_nw_batch(pairs, n_threads: int = 1) -> np.ndarray:
    """Batched global NW scores (BLOSUM62 + linear gap -1, the reference
    protein kernel's scoring scheme) -> int32 mutual scores.

    pairs: list of (a_codes, b_codes) uint8 arrays indexing the SeqAn
    AminoAcid alphabet (ops.blosum.AA_ORDER).  n_threads=1 is the
    single-core baseline path bench.py uses for protein_vs_baseline;
    0 = all cores."""
    from ..ops.blosum import BLOSUM62, GAP_SCORE

    lib = load()
    assert lib is not None and hasattr(lib, "taxtk_protein_nw_batch"), \
        "native protein library unavailable"
    if n_threads == 0:
        n_threads = os.cpu_count() or 1
    n = len(pairs)
    out = np.zeros(n, dtype=np.int32)
    if n == 0:
        return out
    sub = np.ascontiguousarray(BLOSUM62, np.int8)
    alpha = sub.shape[0]
    a_flat = np.concatenate(
        [np.ascontiguousarray(a, np.uint8) for a, _ in pairs])
    b_flat = np.concatenate(
        [np.ascontiguousarray(b, np.uint8) for _, b in pairs])
    a_len = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    b_len = np.array([len(b) for _, b in pairs], dtype=np.int32)
    a_off = np.zeros(n, dtype=np.int64)
    b_off = np.zeros(n, dtype=np.int64)
    if n > 1:
        a_off[1:] = np.cumsum(a_len[:-1])
        b_off[1:] = np.cumsum(b_len[:-1])
    if len(a_flat) == 0:
        a_flat = np.zeros(1, np.uint8)
    if len(b_flat) == 0:
        b_flat = np.zeros(1, np.uint8)
    lib.taxtk_protein_nw_batch(
        a_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        a_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        sub.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        alpha,
        GAP_SCORE,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    return out

"""Copy of taxtk/native/faidx.py: the port keeps its own copy and imports nothing of taxtk.

ctypes wrapper for the native batched FASTA region fetcher (io.cpp)."""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import build_atomic

_HERE = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_HERE, "libtaxtk_io.so")
_SRC = os.path.join(_HERE, "io.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
            if not build_atomic(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC],
                _LIB_PATH,
            ):
                return None
        lib = ctypes.CDLL(_LIB_PATH)
        I64P = ctypes.POINTER(ctypes.c_int64)
        U8P = ctypes.POINTER(ctypes.c_uint8)
        lib.taxtk_faidx_open.restype = ctypes.c_void_p
        lib.taxtk_faidx_open.argtypes = [ctypes.c_char_p, I64P, I64P, I64P, I64P, ctypes.c_int64]
        lib.taxtk_faidx_close.restype = None
        lib.taxtk_faidx_close.argtypes = [ctypes.c_void_p]
        lib.taxtk_faidx_fetch_encode.restype = ctypes.c_int
        lib.taxtk_faidx_fetch_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, I64P, I64P, I64P, U8P,
            ctypes.c_int, U8P, ctypes.c_int64, I64P,
        ]
        _lib = lib
        return _lib


class NativeFaidx:
    """Batched region fetch + encode over a .fai-indexed FASTA."""

    def __init__(self, fasta_path: str, lengths, offsets, line_bases, line_widths):
        lib = load()
        if lib is None:
            raise RuntimeError("native io library unavailable")
        self._lib = lib
        n = len(lengths)
        self._arrs = [
            np.asarray(lengths, np.int64),
            np.asarray(offsets, np.int64),
            np.asarray(line_bases, np.int64),
            np.asarray(line_widths, np.int64),
        ]
        I64P = ctypes.POINTER(ctypes.c_int64)
        self._h = lib.taxtk_faidx_open(
            fasta_path.encode(),
            *(a.ctypes.data_as(I64P) for a in self._arrs),
            n,
        )
        if not self._h:
            raise RuntimeError(f"could not open {fasta_path}")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.taxtk_faidx_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def fetch_encode(
        self,
        seq_idx: Sequence[int],
        start: Sequence[int],
        stop: Sequence[int],
        revcomp: Sequence[bool],
        protein: bool,
    ) -> List[np.ndarray]:
        n = len(seq_idx)
        if n == 0:
            return []
        si = np.asarray(seq_idx, np.int64)
        st = np.asarray(start, np.int64)
        sp = np.asarray(stop, np.int64)
        rc = np.asarray(revcomp, np.uint8)
        lens = self._arrs[0]
        stride = int(
            max(
                1,
                (np.minimum(sp, lens[si]) - np.maximum(st, 1) + 1).max(initial=1),
            )
        )
        out = np.zeros((n, stride), np.uint8)
        out_len = np.zeros(n, np.int64)
        I64P = ctypes.POINTER(ctypes.c_int64)
        U8P = ctypes.POINTER(ctypes.c_uint8)
        rcode = self._lib.taxtk_faidx_fetch_encode(
            self._h,
            n,
            si.ctypes.data_as(I64P),
            st.ctypes.data_as(I64P),
            sp.ctypes.data_as(I64P),
            rc.ctypes.data_as(U8P),
            1 if protein else 0,
            out.ctypes.data_as(U8P),
            stride,
            out_len.ctypes.data_as(I64P),
        )
        if rcode != 0:
            raise RuntimeError(f"native fetch failed: {rcode}")
        return [out[i, : out_len[i]] for i in range(n)]

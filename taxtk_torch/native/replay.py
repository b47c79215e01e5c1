"""Copy of taxtk/native/replay.py: the port keeps its own copy and imports nothing of taxtk.

ctypes wrapper for the native RPA decision replay (replay.cpp).

The replay passes are the engine's dominant HOST cost (round-4 driver
capture: protein e2e host_s 0.63 of engine_s 1.0, mostly models/rpa.py
replay loops).  replay.cpp runs the same decision logic in C++ with the
same float32/double semantics; models/rpa.py dispatches here per task
when the library is available, the task is not logging, and no mesh
merge is in play (tests/test_replay_native.py pins native == Python on
randomized corpora; the reference-code oracle suite pins the resulting
GFF3 against the reference's own compiled predict()).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from . import build_atomic

_HERE = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_HERE, "libtaxtk_replay.so")
_SRC = os.path.join(_HERE, "replay.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _build() -> bool:
    return build_atomic(
        [
            "g++",
            "-O3",
            "-march=native",
            # float ops must not fuse into FMAs: results would diverge
            # from the Python/numpy float32 semantics bit-for-bit
            "-ffp-contract=off",
            "-fno-fast-math",
            "-shared",
            "-fPIC",
            _SRC,
        ],
        _LIB_PATH,
    )


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TAXTK_NATIVE_REPLAY", "1") == "0":
            return None
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(
            _LIB_PATH
        ) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.taxtk_rpa_pass0.restype = None
            lib.taxtk_rpa_pass0.argtypes = [
                ctypes.c_int32, _f64p, _i32p, _i32p, _u8p, _u8p,
                _f32p, _f32p, _i32p, _i32p, _i32p, _i32p, ctypes.c_int32,
                _f32p, _f32p, _i32p, _i32p, _i32p,
            ]
            lib.taxtk_rpa_pass1.restype = None
            lib.taxtk_rpa_pass1.argtypes = [
                ctypes.c_int32, _f64p, _i32p, _i32p, ctypes.c_int32,
                ctypes.c_float, _f32p, _f32p, _i32p, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _f32p,
                _i32p, _i32p, _i32p, _i32p, ctypes.c_int32,
                _i32p, _f32p, _i32p, _i32p,
            ]
            lib.taxtk_rpa_pass2.restype = None
            lib.taxtk_rpa_pass2.argtypes = [
                ctypes.c_int32, _f64p, _i32p, _i32p, ctypes.c_int32,
                ctypes.c_float, ctypes.c_float, _f32p, _f32p, _i32p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_float, _f32p, _f32p, _f32p,
                _i32p, _i32p, _i32p, _i32p, ctypes.c_int32,
                _f32p, _i32p, _i32p,
            ]
            _vp = ctypes.c_void_p
            _i = ctypes.c_int32
            lib.taxtk_rpa_pass0_batch.restype = None
            lib.taxtk_rpa_pass0_batch.argtypes = (
                [_i] + [_vp] * 13 + [_i] + [_vp] * 5
            )
            lib.taxtk_rpa_pass1_batch.restype = None
            lib.taxtk_rpa_pass1_batch.argtypes = (
                [_i] + [_vp] * 21 + [_i] + [_vp] * 4
            )
            lib.taxtk_rpa_pass2_batch.restype = None
            lib.taxtk_rpa_pass2_batch.argtypes = (
                [_i] + [_vp] * 25 + [_i] + [_vp] * 3
            )
        except (OSError, AttributeError):  # pragma: no cover - stale .so
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def tax_arrays(tax):
    """(left, right, parent, depth) as contiguous int32 + root, cached on
    the FlatTaxonomy instance (invalidated if its arrays are replaced —
    e.g. set_rank_depths assigns a new depth array)."""
    cached = getattr(tax, "_native_tax", None)
    srcs = (id(tax.left), id(tax.right), id(tax.parent), id(tax.depth))
    if cached is not None and cached[0] == srcs:
        return cached[1]
    arrs = (
        np.ascontiguousarray(tax.left, np.int32),
        np.ascontiguousarray(tax.right, np.int32),
        np.ascontiguousarray(tax.parent, np.int32),
        np.ascontiguousarray(tax.depth, np.int32),
        int(tax.ROOT),
    )
    tax._native_tax = (srcs, arrs)
    return arrs


def _p(a, typ):
    return a.ctypes.data_as(typ)


def rpa_pass0(scores, idents, nodes, p0_exact, p0_aligned, qdist_c, qsim_c,
              tleft, tright, tparent, tdepth, root):
    """Returns (querydistance, querysimilarity, qgroup, rtax, lca_allnodes,
    anchors_support, (p0, p0n))."""
    lib = load()
    n = len(scores)
    qd = np.empty(n, np.float32)
    qs = np.empty(n, np.float32)
    qgroup = np.empty(n, np.int32)
    out = np.zeros(5, np.int32)
    counters = np.zeros(2, np.int32)
    lib.taxtk_rpa_pass0(
        n, _p(scores, _f64p), _p(idents, _i32p), _p(nodes, _i32p),
        _p(p0_exact, _u8p), _p(p0_aligned, _u8p),
        _p(qdist_c, _f32p), _p(qsim_c, _f32p),
        _p(tleft, _i32p), _p(tright, _i32p), _p(tparent, _i32p),
        _p(tdepth, _i32p), root,
        _p(qd, _f32p), _p(qs, _f32p), _p(qgroup, _i32p),
        _p(out, _i32p), _p(counters, _i32p),
    )
    return (qd, qs, qgroup[: out[0]].tolist(), int(out[1]), int(out[2]),
            int(out[3]), (int(counters[0]), int(counters[1])))


def rpa_pass1(scores, idents, nodes, qrlength, exclude, qd, qs, qgroup,
              rtax, lnode_global, unode_global, sdist,
              tleft, tright, tparent, tdepth, root):
    """Returns (outgroup, ival_global, bandfactor_max, lnode_global,
    unode_global, anchor_count, (p1, p1n))."""
    lib = load()
    n = len(scores)
    qg = np.asarray(qgroup, np.int32)
    outgroup = np.empty(n, np.int32)
    f32o = np.zeros(2, np.float32)
    i32o = np.zeros(4, np.int32)
    counters = np.zeros(2, np.int32)
    lib.taxtk_rpa_pass1(
        n, _p(scores, _f64p), _p(idents, _i32p), _p(nodes, _i32p),
        qrlength, exclude,
        _p(qd, _f32p), _p(qs, _f32p), _p(qg, _i32p), len(qg),
        rtax, lnode_global, unode_global, _p(sdist, _f32p),
        _p(tleft, _i32p), _p(tright, _i32p), _p(tparent, _i32p),
        _p(tdepth, _i32p), root,
        _p(outgroup, _i32p), _p(f32o, _f32p), _p(i32o, _i32p),
        _p(counters, _i32p),
    )
    return (outgroup[: i32o[0]].tolist(), f32o[0], f32o[1], int(i32o[1]),
            int(i32o[2]), int(i32o[3]), (int(counters[0]), int(counters[1])))


def rpa_pass2(scores, idents, nodes, qrlength, exclude, bandfactor_max,
              qd, qs, outgroup, lca_allnodes, lnode_global, unode_global,
              ival_global, sdist, qdist2, qsim2,
              tleft, tright, tparent, tdepth, root):
    """Returns (ival_global, unode_global, (p2, p2n)).  qd/qs are updated
    in place."""
    lib = load()
    n = len(scores)
    og = np.asarray(outgroup, np.int32)
    f32o = np.zeros(1, np.float32)
    i32o = np.zeros(1, np.int32)
    counters = np.zeros(2, np.int32)
    lib.taxtk_rpa_pass2(
        n, _p(scores, _f64p), _p(idents, _i32p), _p(nodes, _i32p),
        qrlength, exclude, bandfactor_max,
        _p(qd, _f32p), _p(qs, _f32p), _p(og, _i32p), len(og),
        lca_allnodes, lnode_global, unode_global, ival_global,
        _p(sdist, _f32p), _p(qdist2, _f32p), _p(qsim2, _f32p),
        _p(tleft, _i32p), _p(tright, _i32p), _p(tparent, _i32p),
        _p(tdepth, _i32p), root,
        _p(f32o, _f32p), _p(i32o, _i32p), _p(counters, _i32p),
    )
    return f32o[0], int(i32o[0]), (int(counters[0]), int(counters[1]))

"""The pool's wire pack (native/pack.cpp behind host._pack_text_pool)
against taxtk's numpy `_pack_text_pool`, bit for bit, at 2, 4 and 8 bits,
and the native library that carries it.  The device pool at Kernel 2's
append shape is in test_torch_seqpool.py.
"""

import os

import numpy as np
import pytest

from taxtk.ops.pallas_myers import _pack_text_pool as taxtk_pack
from taxtk_torch import native
from taxtk_torch.ops.host import _pack_text_pool

CASES = ("ragged", "long_row", "sentinel_codes", "masked", "tall_np",
         "wide_up", "single_row", "capped_views", "none_used")


def _codes(rng, n, bits):
    return rng.integers(0, 1 << bits, n).astype(np.uint8)


def _case(name, bits, seed):
    """(rows, lens, txt_used, Np, Up) of one case."""
    rng = np.random.default_rng(seed)
    cpb = 8 // bits
    # ragged lengths: 0, ones below and above a whole byte, and the rest
    # drawn, so most are not a multiple of cpb
    lens = [0, 1, 2, 3, 5, 7, 0, cpb + 1, 4 * cpb - 1]
    lens += [int(x) for x in rng.integers(0, 3000, 31)]
    rows = [_codes(rng, L, bits) for L in lens]
    used = np.ones(len(rows), bool)
    Np, Up = 4096, len(rows)
    if name == "long_row":  # one row of 98,304 codes, filling Np exactly
        rows.insert(5, _codes(rng, 98_304, bits))
        used = np.ones(len(rows), bool)
        Np, Up = 98_304, len(rows)
    elif name == "sentinel_codes":  # every byte value, at and above it
        rows = [rng.integers(0, 256, len(r)).astype(np.uint8) for r in rows]
        rows[3][:] = (1 << bits) - 1
    elif name == "masked":  # a false entry holds the longest row, too
        used = rng.random(len(rows)) < 0.6
        used[0] = used[4] = False
        rows.insert(0, _codes(rng, 3 * Np, bits))
        used = np.concatenate([[False], used])
        Up = len(rows)
    elif name == "tall_np":
        Np = 65_536
    elif name == "wide_up":  # pad columns past the rows, not a whole tile
        Up = len(rows) + 77
    elif name == "single_row":
        rows, used, Up = [_codes(rng, 2_999, bits)], np.ones(1, bool), 1
    elif name == "capped_views":
        # lens below the rows' own (the pattern pool's cap) and rows that
        # are strided or offset views of a wider array
        wide = _codes(rng, 2 * 6000, bits).reshape(2, 6000)
        rows = [wide[0, ::2], wide[1, 7:], wide[0, 1:4000:3]] + rows
        used = np.ones(len(rows), bool)
        Up = len(rows)
    elif name == "none_used":
        used[:] = False
    lens = np.array([min(len(r), 2000) if name == "capped_views" else len(r)
                     for r in rows], np.int32)
    return rows, lens, used, Np, Up


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("name", CASES)
def test_pack_matches_taxtk(name, bits):
    rows, lens, used, Np, Up = _case(name, bits, 100 + CASES.index(name))
    want = taxtk_pack(rows, lens, used, Np, Up, bits)
    got = _pack_text_pool(rows, lens, used, Np, Up, bits)
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_pack_refuses_a_row_past_np(bits):
    """A used row longer than Np raises, as taxtk's does; the same row
    unused is not read."""
    rng = np.random.default_rng(5)
    rows = [_codes(rng, 300, bits), _codes(rng, 9000, bits)]
    lens = np.array([300, 9000], np.int32)
    for pack in (taxtk_pack, _pack_text_pool):
        with pytest.raises(ValueError):
            pack(rows, lens, np.ones(2, bool), 4096, 2, bits)
    np.testing.assert_array_equal(
        _pack_text_pool(rows, lens, np.array([True, False]), 4096, 2, bits),
        taxtk_pack(rows, lens, np.array([True, False]), 4096, 2, bits))


def test_native_library_carries_the_pack():
    """The port's library is built from its own pack.cpp beside the copies
    of taxtk's sources, and exposes the pack's symbol."""
    lib = native.load()
    assert lib is not None and hasattr(lib, "taxtk_pack_text_pool")
    src = os.path.join(os.path.dirname(native.__file__), "pack.cpp")
    assert src in native._SRCS
    assert os.path.getmtime(native._LIB_PATH) >= os.path.getmtime(src)
    taxtk_native = os.path.join(os.path.dirname(native.__file__), "..", "..",
                                "taxtk", "native")
    assert not os.path.exists(os.path.join(taxtk_native, "pack.cpp"))
    assert ("`pack.cpp` is the port's own, with no taxtk original"
            in " ".join(native.__doc__.split()))

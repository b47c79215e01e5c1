"""Device-resident packed-sequence pools shared across align rounds.

Port of taxtk/ops/seqpool.py (DevicePoolCache).  RPA's three alignment
rounds re-align the segments the earlier rounds shipped, so the deduped
sequence rows stay on the device:

  * one append-only pool per (bits, height class): a [Hc//cpb, cap] int8
    tensor of packed columns (the wire format of host._pack_text_pool —
    codes packed 2 or 4 per byte from position 0, 0xFF beyond each row's
    own length);
  * a host dict mapping (length, bytes) content keys -> column slot;
  * each round ships only the rows not yet resident, in one append, and
    the kernels read text and pattern columns straight from the pool.

Kept from taxtk: the content keys, one pool per (bits, Hc), the append
padding (pow2 column count n_pad, pack height Hs) that fixes
`bytes_shipped`, the wholesale reset when the byte budget would be
exceeded, and committing slots only after the append succeeded.  Changed:
the capacity starts small and doubles.  taxtk pre-sizes it from the
budget only because every pool width was a TPU recompile.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..engine.metrics import span
from .host import _pack_text_pool, _pow2
from .transfer import h2d


class _Pool:
    __slots__ = ("Hc", "bits", "dev", "cap", "n_used", "slots")

    def __init__(self, Hc: int, bits: int, device, cap: int = 512):
        self.Hc = Hc
        self.bits = bits
        self.cap = cap
        self.n_used = 0
        self.slots: Dict[Tuple[int, bytes], int] = {}
        self.dev = torch.full((Hc // (8 // bits), cap), -1, dtype=torch.int8,
                              device=device)

    @property
    def nbytes(self) -> int:
        return self.dev.shape[0] * self.cap


class DevicePoolCache:
    """Content-keyed device pools on `device`; `ensure` returns per-row
    column slots, shipping only the missing rows."""

    def __init__(self, device, budget_bytes: int = 1 << 30):
        self.device = torch.device(device)
        self.pools: Dict[Tuple[int, int], _Pool] = {}
        self.budget = budget_bytes
        self.hits = 0
        self.misses = 0
        self.bytes_shipped = 0
        self.resets = 0
        # the systolic entry's height ratchet: the largest (bits, Hc) class
        # height it has used, so later smaller rounds hit the same pool
        self.systolic_hc = 0

    @staticmethod
    def height_class(N: int) -> int:
        return max(_pow2(N), 128)

    def _total_bytes(self) -> int:
        return sum(p.nbytes for p in self.pools.values())

    def pool(self, bits: int, Hc: int) -> _Pool:
        p = self.pools.get((bits, Hc))
        if p is None:
            p = self.pools[(bits, Hc)] = _Pool(Hc, bits, self.device)
        return p

    def ensure(
        self,
        bits: int,
        Hc: int,
        keys: List[Tuple[int, bytes]],
        rows: List[np.ndarray],
        lens: np.ndarray,
    ):
        """Returns (pool tensor, slots[int32 array over rows]).  Ships the
        rows whose content key is not yet resident, appended as one packed
        block of n_pad columns (only n_new are committed; the pad tail is
        unreferenced and the next append overwrites it).  Spans: pool.ensure
        (count: rows), with pool.pack (count: rows shipped) and the append's
        h2d under it."""
        with span("pool.ensure", count=len(rows)):
            return self._ensure(bits, Hc, keys, rows, lens)

    def _ensure(self, bits, Hc, keys, rows, lens):
        p = self.pool(bits, Hc)
        slots = np.empty(len(rows), np.int32)
        missing: List[int] = []
        new_slots: Dict[Tuple[int, bytes], int] = {}
        n_hits = 0  # committed only if this call goes through
        for i, k in enumerate(keys):
            s = p.slots.get(k)
            if s is None:
                s = new_slots.get(k)
            if s is None:
                s = p.n_used + len(missing)
                new_slots[k] = s
                missing.append(i)
            else:
                n_hits += 1
            slots[i] = s
        if missing:
            n_new = len(missing)
            n_pad = max(64, _pow2(n_new))  # pow2 pack width, as in taxtk
            cpb = 8 // bits
            need_cap = p.cap
            while p.n_used + n_pad > need_cap:
                need_cap *= 2
            post_bytes = (
                self._total_bytes() - p.nbytes + (Hc // cpb) * need_cap
            )
            if post_bytes > self.budget and (p.n_used or len(self.pools) > 1):
                # reset before growing past the budget, then redo the
                # assignment against a fresh pool (which cannot reset
                # again: n_used == 0 and it is the only pool)
                self.pools.clear()
                self.resets += 1
                return self._ensure(bits, Hc, keys, rows, lens)
            with span("pool.pack", count=n_new):
                mrows = [rows[i] for i in missing]
                mlens = lens[missing]
                # pack and ship at the new rows' own pow2 height: bytes
                # past a row's length are never read, so a short append
                # into a tall column is sound and ships content-sized bytes
                Hs = min(Hc, max(128, _pow2(int(mlens.max(initial=1)))))
                packed = _pack_text_pool(
                    mrows, mlens, np.ones(n_new, bool), Hs, n_pad, bits
                )
            dev = p.dev
            if need_cap > p.cap:
                dev = torch.full((dev.shape[0], need_cap), -1,
                                 dtype=torch.int8, device=self.device)
                dev[:, : p.cap].copy_(p.dev)
            new = h2d(packed, self.device)
            dev[: new.shape[0], p.n_used : p.n_used + n_pad].copy_(new)
            # commit point: everything above may raise without corrupting
            self.misses += n_new
            self.bytes_shipped += packed.nbytes
            p.dev = dev
            p.cap = need_cap
            p.slots.update(new_slots)
            p.n_used += n_new
        self.hits += n_hits
        return p.dev, slots


def from_jax_state(np_pool_columns: np.ndarray, slots, *, bits: int,
                   device="cuda") -> DevicePoolCache:
    """A taxtk DevicePoolCache pool, given as numpy, as the port's pool.

    np_pool_columns: the [Hc//cpb, cap] int8 array of one taxtk pool
    (np.asarray(pool.dev)); slots: its {(len, bytes): column} dict.
    Returns a cache holding that one (bits, Hc) pool with the same
    columns and slots, so both sides start from the identical state."""
    cols = np.array(np_pool_columns, np.int8)  # a writable copy
    Hc = cols.shape[0] * (8 // bits)
    cache = DevicePoolCache(device)
    p = _Pool(Hc, bits, cache.device, cap=cols.shape[1])
    p.dev = torch.from_numpy(cols).to(cache.device)
    p.slots = dict(slots)
    p.n_used = max(p.slots.values(), default=-1) + 1
    cache.pools[(bits, Hc)] = p
    return cache


_SHARED: Dict[Tuple[torch.device, object], DevicePoolCache] = {}


def _indexed(device) -> torch.device:
    """`device` with its index: an unindexed CUDA device is the current
    card, so "cuda" and "cuda:0" name one pool on card 0."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def shared_pool_cache(device, key=None) -> DevicePoolCache:
    """The process-wide pool cache for `device`.  Pools are content-keyed,
    so every aligner in the process may share one: repeated runs against
    the same refpack ship each unique row once (as in taxtk).  key: a
    further name, so that several caches can live on one device (the
    cells of a mesh grid that names one device more than once)."""
    device = _indexed(device)
    c = _SHARED.get((device, key))
    if c is None:
        c = _SHARED[(device, key)] = DevicePoolCache(device)
    return c


def reset_shared_pools() -> None:
    """Drop every shared pool (tests; or to free device memory)."""
    _SHARED.clear()

"""taxtk_torch's device sequence pool against taxtk's DevicePoolCache.

The same sequence of ensure() calls goes to both caches (with a budget
that is never reached): hits, misses, bytes shipped, column slots and
the packed column bytes must be equal.  The over-budget reset, the
systolic height ratchet and the state carry-across helper are tested on
their own.
"""

import numpy as np
import torch

from taxtk.ops.pallas_myers import batched_edit_distance_pallas_myers
from taxtk.ops.seqpool import DevicePoolCache as JaxPoolCache
from taxtk_torch.ops import myers_cuda, myers_systolic
from taxtk_torch.ops.host import _pack_text_pool
from taxtk_torch.ops.seqpool import DevicePoolCache, from_jax_state


def _rounds(seed, n_rounds=5):
    """Rounds of (bits, Hc, keys, rows, lens) with re-used rows, both
    wires and two height classes."""
    rng = np.random.default_rng(seed)
    library = [rng.integers(0, 4, int(rng.integers(1, 700))).astype(np.uint8)
               for _ in range(120)]
    library += [rng.integers(0, 5, int(rng.integers(1, 300))).astype(np.uint8)
                for _ in range(40)]
    out = []
    for r in range(n_rounds):
        pick = rng.choice(len(library), int(rng.integers(20, 90)))
        rows = [library[i] for i in pick]
        keys = [(len(x), x.tobytes()) for x in rows]
        bits = 2 if all(int(x.max(initial=0)) < 4 for x in rows) else 4
        Hc = 1024 if r % 2 else 2048
        out.append((bits, Hc, keys, rows, np.array([len(x) for x in rows],
                                                   np.int32)))
    return out


def test_ensure_sequence_matches_taxtk():
    ref = JaxPoolCache(budget_bytes=1 << 40)
    port = DevicePoolCache("cpu", budget_bytes=1 << 40)
    for bits, Hc, keys, rows, lens in _rounds(1, 8):
        pool_r, slots_r = ref.ensure(bits, Hc, keys, rows, lens)
        pool_p, slots_p = port.ensure(bits, Hc, keys, rows, lens)
        np.testing.assert_array_equal(slots_p, slots_r)
        assert (port.hits, port.misses, port.bytes_shipped) == (
            ref.hits, ref.misses, ref.bytes_shipped)
        n = ref.pools[(bits, Hc)].n_used
        np.testing.assert_array_equal(pool_p[:, :n].numpy(),
                                      np.asarray(pool_r)[:, :n])
    assert port.resets == ref.resets == 0
    assert sorted(port.pools) == sorted(ref.pools)
    assert port.misses > 0 and port.hits > 0


def test_pool_at_kernel2_shape_matches_taxtk():
    """Rounds of 2-20 kbp rows at 2 bits into a tall (Hc 65,536) class, as
    Kernel 2's appends: slots, hits, misses, bytes shipped and the pool's
    columns equal taxtk's."""
    rng = np.random.default_rng(19)
    library = [rng.integers(0, 4, int(rng.integers(2_000, 20_001)))
               .astype(np.uint8) for _ in range(400)]
    ref = JaxPoolCache(budget_bytes=64 << 20)
    port = DevicePoolCache("cpu", budget_bytes=64 << 20)
    Hc = 65_536
    for n in (150, 180, 300):
        pick = rng.choice(len(library), n)
        rows = [library[i] for i in pick]
        keys = [(len(x), x.tobytes()) for x in rows]
        lens = np.array([len(x) for x in rows], np.int32)
        pool_r, slots_r = ref.ensure(2, Hc, keys, rows, lens)
        pool_p, slots_p = port.ensure(2, Hc, keys, rows, lens)
        np.testing.assert_array_equal(slots_p, slots_r)
        assert (port.hits, port.misses, port.bytes_shipped) == (
            ref.hits, ref.misses, ref.bytes_shipped)
        used = ref.pools[(2, Hc)].n_used
        assert port.pools[(2, Hc)].n_used == used
        np.testing.assert_array_equal(pool_p[:, :used].numpy(),
                                      np.asarray(pool_r)[:, :used])
    assert port.resets == ref.resets == 0
    assert port.hits > 0 and port.misses > 0


def test_budget_reset_and_growth():
    """Growth doubles the capacity and keeps every committed column;
    exceeding the budget resets wholesale and re-ships into a fresh pool."""
    rng = np.random.default_rng(2)
    rows = [rng.integers(0, 4, 100).astype(np.uint8) for _ in range(700)]
    keys = [(len(x), x.tobytes()) for x in rows]
    lens = np.full(len(rows), 100, np.int32)
    cache = DevicePoolCache("cpu", budget_bytes=1 << 30)
    pool, slots = cache.ensure(2, 128, keys[:600], rows[:600], lens[:600])
    assert cache.pools[(2, 128)].cap == 1024  # 512 -> 1024
    want = _pack_text_pool(rows[:600], lens[:600], np.ones(600, bool), 128,
                           600, 2)
    np.testing.assert_array_equal(pool[:, slots].numpy(), want)

    small = DevicePoolCache("cpu", budget_bytes=32 * 512 + 1)
    small.ensure(2, 128, keys[:500], rows[:500], lens[:500])
    assert small.resets == 0
    _, slots = small.ensure(2, 128, keys[500:], rows[500:], lens[500:])
    assert small.resets == 1  # the growth to 1024 columns would overflow
    assert list(slots) == list(range(200))
    assert small.pools[(2, 128)].n_used == 200
    # a hit after the reset would read a dropped column: rows re-ship
    _, slots = small.ensure(2, 128, keys[:10], rows[:10], lens[:10])
    assert list(slots) == list(range(200, 210))


def test_systolic_height_ratchet():
    """A smaller later round hits the class the first round populated:
    no new (bits, Hc) class, no re-ship."""
    rng = np.random.default_rng(9)
    la = np.array([2400, 2300, 80, 60], np.int32)
    lb = np.array([2500, 2200, 90, 70], np.int32)
    ac = np.zeros((4, 2400), np.uint8)
    bc = np.zeros((4, 2500), np.uint8)
    for i in range(4):
        ac[i, : la[i]] = rng.integers(0, 4, la[i])
        bc[i, : lb[i]] = rng.integers(0, 4, lb[i])
    cache = DevicePoolCache("cpu")
    kw = dict(device="cpu", block_words=2, pool_cache=cache)
    first = myers_systolic.batched_edit_distance_systolic(ac, bc, la, lb, **kw)
    n_classes, misses = len(cache.pools), cache.misses
    again = myers_systolic.batched_edit_distance_systolic(
        ac[2:], bc[2:], la[2:], lb[2:], **kw)
    assert again.tolist() == first[2:].tolist()
    assert len(cache.pools) == n_classes
    assert cache.misses == misses and cache.hits == 4
    assert cache.systolic_hc >= 4096


def test_from_jax_state_carries_the_pool():
    """taxtk's resident pool, carried across, serves the port's short entry
    with the same slots: every row hits and the distances agree."""
    rng = np.random.default_rng(4)
    B = 30
    al = rng.integers(1, 200, B).astype(np.int32)
    bl = rng.integers(1, 200, B).astype(np.int32)
    ac = np.zeros((B, 200), np.uint8)
    bc = np.zeros((B, 200), np.uint8)
    for i in range(B):
        ac[i, : al[i]] = rng.integers(0, 4, al[i])
        bc[i, : bl[i]] = rng.integers(0, 4, bl[i])
    ref = JaxPoolCache()
    want = np.asarray(batched_edit_distance_pallas_myers(
        ac, bc, al, bl, interpret=True, pool_gather=True, pool_cache=ref))
    (bits, Hc), pool = next(iter(ref.pools.items()))
    port = from_jax_state(np.asarray(pool.dev), pool.slots, bits=bits,
                          device="cpu")
    assert port.pools[(bits, Hc)].n_used == pool.n_used
    assert torch.equal(port.pools[(bits, Hc)].dev,
                       torch.from_numpy(np.array(pool.dev)))
    got = myers_cuda.batched_edit_distance_short(ac, bc, al, bl,
                                                 device="cpu",
                                                 pool_cache=port)
    np.testing.assert_array_equal(got, want)
    assert port.misses == 0 and port.hits == 2 * B

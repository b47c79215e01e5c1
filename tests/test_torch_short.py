"""Kernel 1 (taxtk_torch/csrc/myers_short.cu), the short-pair Myers kernel:
its launch geometry, its entry against taxtk on the CPU, and the kernel
against its plain version on the card.

On the CPU the wrapper runs the plain version, so the entry cases hold the
port's short entry against taxtk at every K of the kernel's template set,
at patterns ending on word and lane edges, with pairs far below their
launch's K, and on the 4-bit wire with N codes and empty sides: against
the single-launch Pallas kernel in interpret mode
(batched_edit_distance_pallas_myers) up to K = 16, and against taxtk's
XLA Myers (batched_edit_distance_myers, the same recurrence) at K = 32
and 64, where the interpreted kernel takes minutes on the CPU.  Inputs
come from seeded numpy generators; distances are integers and must be
exactly equal.
"""

import numpy as np
import pytest
import torch
from unittest import mock

from taxtk.ops import oracle
from taxtk.ops.myers_batch import batched_edit_distance_myers
from taxtk.ops.pallas_myers import batched_edit_distance_pallas_myers
from taxtk_torch.native import myers_batch
from taxtk_torch.ops import myers_cuda
from taxtk_torch.ops.seqpool import DevicePoolCache

GEOMETRIES = [(K, w) for K in myers_cuda.K_SET
              for w in (None, *myers_cuda.W_SET[K])]


def _related(rng, m, n, alphabet, mutate=0.05):
    """(a, b): b random of length n, a a copy of b resized to m with a
    share `mutate` of its codes redrawn (random where b is empty)."""
    b = rng.integers(0, alphabet, n).astype(np.uint8)
    a = (np.resize(b, m) if n else
         rng.integers(0, alphabet, m).astype(np.uint8))
    mut = rng.random(m) < mutate
    a[mut] = rng.integers(0, alphabet, int(mut.sum()))
    return a, b


def _lengths_batch(rng, lengths, alphabet):
    """(ac, bc, al, bl) of related pairs with these (m, n) lengths, the
    pattern on either side."""
    pairs = []
    for i, (m, n) in enumerate(lengths):
        a, b = _related(rng, m, n, alphabet)
        pairs.append((a, b) if i % 2 else (b, a))
    B = len(pairs)
    ac = np.zeros((B, max(1, max(len(a) for a, _ in pairs))), np.uint8)
    bc = np.zeros((B, max(1, max(len(b) for _, b in pairs))), np.uint8)
    for i, (a, b) in enumerate(pairs):
        ac[i, : len(a)] = a
        bc[i, : len(b)] = b
    return (ac, bc, np.array([len(a) for a, _ in pairs], np.int32),
            np.array([len(b) for _, b in pairs], np.int32))


def _near(rng, ms, spread=8):
    """(m, n) with n within `spread` of each m."""
    return [(m, max(0, m + int(rng.integers(-spread, spread + 1))))
            for m in ms]


@pytest.mark.parametrize("K,w", GEOMETRIES)
def test_short_kernel_geometry(K, w):
    """The group of G lanes holds the pattern's K words (G * W * 32 bits
    cover K * 32), a warp holds whole groups, a block whole warps; a W the
    kernel is not built for is refused."""
    G, W, per_warp, threads = myers_cuda.kernel_geometry(K, w)
    assert W == (myers_cuda.DEFAULT_W[K] if w is None else w)
    assert W in myers_cuda.W_SET[K]
    assert G * W * 32 >= K * 32 and G * W == K
    assert per_warp * G == 32
    assert threads % 32 == 0 and threads > 0
    with pytest.raises(ValueError):
        myers_cuda.kernel_geometry(K, 4)
    with pytest.raises(ValueError):
        myers_cuda.kernel_geometry(K * 3)


def _case(name, rng):
    """The (m, n) lengths and alphabet of one entry case."""
    if name.startswith("K="):
        K = int(name[2:])
        hi = 32 * K  # one pattern at the launch's full K words
        ms = [hi, max(1, hi // 2 + 1)] + list(rng.integers(1, hi + 1, 4))
        return _near(rng, ms), 4
    if name == "edges":
        return _near(rng, [1, 31, 32, 33, 63, 64, 65, 2047, 2048], 3), 4
    if name == "below-K":
        # one 2048 bp pattern sets K = 64; the rest hold 1-3 words, some
        # against texts much longer than their pattern
        ms = [2048] + list(rng.integers(1, 97, 7))
        return [(2048, 2050)] + [(int(m), int(m) + int(rng.integers(0, 300)))
                                 for m in ms[1:]], 4
    if name == "4bit-N-empty":
        ms = [0, 0, 5, 31, 32, 33, 200, 97]
        ns = [0, 17, 0, 40, 30, 33, 190, 0]
        return list(zip(ms, ns)), 5
    raise ValueError(name)


ENTRY_CASES = [f"K={K}" for K in myers_cuda.K_SET] + [
    "edges", "below-K", "4bit-N-empty"]


@pytest.mark.parametrize("name", ENTRY_CASES)
def test_short_entry_matches_pallas_cases(name):
    """The short entry (Kernel 1's plain version on the CPU) against
    taxtk (the Pallas kernel in interpret mode up to K = 16, its XLA
    Myers above) and the oracle, with and without the pool cache."""
    rng = np.random.default_rng(sum(map(ord, name)))
    lengths, alphabet = _case(name, rng)
    ac, bc, al, bl = _lengths_batch(rng, lengths, alphabet)
    if max(min(m, n) for m, n in lengths) <= 16 * 32:
        want = np.asarray(batched_edit_distance_pallas_myers(
            ac, bc, al, bl, interpret=True, pool_gather=True, text_chunk=64))
    else:
        want = np.asarray(batched_edit_distance_myers(ac, bc, al, bl))
    np.testing.assert_array_equal(
        want, [oracle.edit_distance(ac[i, : al[i]], bc[i, : bl[i]])
               for i in range(len(al))])
    for cache in (None, DevicePoolCache("cpu")):
        got = myers_cuda.batched_edit_distance_short(
            ac, bc, al, bl, device="cpu", pool_cache=cache)
        np.testing.assert_array_equal(got, want)


CARD_CASES = [(K, w, bits) for K in myers_cuda.K_SET
              for w in myers_cuda.W_SET[K] for bits in (2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,w,bits", CARD_CASES)
def test_short_kernel_matches_plain_on_card(K, w, bits):
    """Kernel 1 at (K, W) forced, on the 2-bit or 4-bit wire, against its
    plain version (every output element) on both input layouts, and
    against the host C++ Myers after post: 150 related pairs (a partial
    last block), one pattern of the full K words, patterns far below K,
    word-edge lengths and empty sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(1000 * K + 10 * w + bits)
    hi = 32 * K
    edges = [m for m in (hi, 1, 31, 32, 33) if m <= hi]
    lengths = [(0, 17), (5, 0), (0, 0)] + _near(
        rng, edges + list(rng.integers(1, hi + 1, 147 - len(edges))), 40)
    ac, bc, al, bl = _lengths_batch(rng, lengths, 4 if bits == 2 else 5)
    pairs = [(ac[i, : al[i]], bc[i, : bl[i]]) for i in range(len(al))]
    real = myers_cuda.kernel_geometry
    with mock.patch.object(myers_cuda, "kernel_geometry",
                           lambda K_, w_=None: real(K_, w)):
        for cache in (DevicePoolCache("cuda"), None):
            args, post = myers_cuda.short_inputs(
                ac, bc, al, bl, torch.device("cuda"), pool_cache=cache)
            assert args[6:] == (K, bits)
            n = myers_cuda.myers_short.launches
            got = myers_cuda.myers_short(*args)
            assert myers_cuda.myers_short.launches == n + 1
            assert torch.equal(got, myers_cuda.myers_short_plain(*args))
            np.testing.assert_array_equal(post(got.cpu().numpy()),
                                          myers_batch(pairs))

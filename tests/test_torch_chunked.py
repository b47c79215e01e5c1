"""taxtk_torch's pattern-block-chunked Myers against taxtk, on the CPU.

Inputs come from seeded numpy generators and go to both sides; integers
must be exactly equal.  On the CPU the kernel wrapper runs its plain
version (myers_ref.myers_block_step):
  * one launch: myers_block_step against one interpret-mode launch of
    taxtk's _make_kernel_chunked (score, res and the carry stream hout);
  * the plain version on the port's packed carry stream against
    myers_block_step on taxtk's, launch by launch, and the packing;
  * the entry: batched_edit_distance_long against
    batched_edit_distance_pallas_myers_long at taxtk's small test geometry,
    with and without a pool cache (hits, misses and bytes equal too);
  * the short entry hands patterns over 2048 bp to the chunked entry;
  * the aligner's oversized-round route (systolic_max_pairs = 0) against
    taxtk's aligner and the oracle.
"""

import functools

import numpy as np
import pytest
import torch

import taxtk.ops.pallas_myers as pm
import taxtk.ops.pallas_myers_systolic as pms
from taxtk.engine.aligner import BatchAligner as JaxAligner
from taxtk.ops import oracle
from taxtk.ops.seqpool import DevicePoolCache as JaxPoolCache
from taxtk_torch.engine import aligner as torch_aligner_mod
from taxtk_torch.ops import myers_chunked, myers_cuda
from taxtk_torch.ops.myers_ref import myers_block_step, unpack_columns
from taxtk_torch.ops.seqpool import DevicePoolCache, reset_shared_pools


def _oracle(ac, bc, al, bl):
    return np.array([oracle.edit_distance(ac[i, : al[i]], bc[i, : bl[i]])
                     for i in range(len(al))])


def _batch(rng, ms, ns, alphabet):
    B = len(ms)
    ac = np.zeros((B, max(1, max(ms))), np.uint8)
    bc = np.zeros((B, max(1, max(ns))), np.uint8)
    for i, (m, n) in enumerate(zip(ms, ns)):
        ac[i, :m] = rng.integers(0, alphabet, m)
        bc[i, :n] = rng.integers(0, alphabet, n)
    return ac, bc, np.array(ms, np.int32), np.array(ns, np.int32)


@pytest.mark.parametrize("bits", [2, 4])
def test_block_step_matches_one_chunked_launch(bits):
    """Random carries, scores, pattern-end words inside and outside the
    block and texts that end before the launch's extent."""
    rng = np.random.default_rng(40 + bits)
    B, K, N = 40, 4, 70
    SUB, Tc, n_chunks = 2, 32, 3
    S, Np = SUB, Tc * n_chunks
    Bp = S * pm.LANE
    peq = rng.integers(0, 2**32, (K, 5, B), dtype=np.uint64).astype(np.uint32)
    nlen = rng.integers(0, N + 1, B).astype(np.int32)
    text = rng.integers(0, 4 if bits == 2 else 5, (N, B)).astype(np.uint8)
    text[np.arange(N)[:, None] >= nlen[None, :]] = 31  # past each text
    mword = rng.integers(-2, K + 2, B).astype(np.int32)
    mbit = rng.integers(0, 32, B).astype(np.int32)
    score = rng.integers(0, 500, B).astype(np.int32)
    res = rng.integers(0, 500, B).astype(np.int32)
    hin = rng.integers(0, 3, (Np, B)).astype(np.int8)  # ph | mh << 1

    def tile(x, fill=0):
        out = np.full(x.shape[:-1] + (Bp,), fill, x.dtype)
        out[..., :B] = x
        return out.reshape(x.shape[:-1] + (S, pm.LANE))

    sout, rout, hout = pm._call_chunked(
        tile(peq), pm._pack_text(text, N, B, Np, Bp, 1, SUB, bits),
        tile(mword, -1), tile(mbit), tile(nlen, 1), tile(score), tile(res),
        tile(hin, 1), K=K, Tc=Tc, n_chunks=n_chunks, n_tiles=1, SUB=SUB,
        interpret=True, bits=bits)
    # the codes the TPU kernel reads: clamped to the field, pad past N
    sent = (1 << bits) - 1
    codes = np.full((Np, B), sent, np.uint8)
    codes[:N] = np.minimum(text, sent)
    got = myers_block_step(
        torch.from_numpy(peq.view(np.int32)), torch.from_numpy(codes),
        *(torch.from_numpy(x) for x in (mword, mbit, nlen, score, res, hin)))
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(sout).reshape(-1)[:B])
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(rout).reshape(-1)[:B])
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(hout).reshape(Np, -1)[:, :B])


@pytest.mark.parametrize("alphabet", [4, 5])
def test_entry_matches_pallas_long(alphabet):
    """Block-edge pattern lengths (block_words=2: 64 bp blocks), shared
    rows, an empty side; one-off pool and pool cache, two rounds through
    the cache with equal hits, misses and bytes shipped."""
    rng = np.random.default_rng(50 + alphabet)
    ms = [63, 64, 65, 128, 129, 1, 0, 90, 200, 150]
    ns = [int(x) for x in rng.integers(1, 250, len(ms))]
    ac, bc, al, bl = _batch(rng, ms, ns, alphabet)
    bc[7], bl[7] = bc[2], bl[2]  # shared rows exercise the dedupe
    ac[9], al[9] = ac[3], al[3]
    kw = dict(block_words=2, text_chunk=64, interpret=True, pool_gather=True)
    want = np.asarray(pm.batched_edit_distance_pallas_myers_long(
        ac, bc, al, bl, **kw))
    np.testing.assert_array_equal(want, _oracle(ac, bc, al, bl))
    got = myers_chunked.batched_edit_distance_long(
        ac, bc, al, bl, device="cpu", block_words=2)
    np.testing.assert_array_equal(got, want)
    ref, port = JaxPoolCache(), DevicePoolCache("cpu")
    for rnd, sel in enumerate((slice(0, 6), slice(None))):
        args = (ac[sel], bc[sel], al[sel], bl[sel])
        want = np.asarray(pm.batched_edit_distance_pallas_myers_long(
            *args, pool_cache=ref, **kw))
        got = myers_chunked.batched_edit_distance_long(
            *args, device="cpu", block_words=2, pool_cache=port)
        np.testing.assert_array_equal(got, want, err_msg=f"round {rnd}")
        assert (port.hits, port.misses, port.bytes_shipped) == (
            ref.hits, ref.misses, ref.bytes_shipped)
    assert port.hits > 0 and sorted(port.pools) == sorted(ref.pools)


def test_short_entry_hands_long_patterns_to_chunked():
    """Patterns over 2048 bp: the short entry answers through the chunked
    entry (it used to raise), with and without the pool cache."""
    rng = np.random.default_rng(60)
    ac, bc, al, bl = _batch(rng, [2100, 2990, 2500], [2300, 2700, 3000], 5)
    n = myers_chunked.myers_chunked.launches
    want = _oracle(ac, bc, al, bl)
    for cache in (None, DevicePoolCache("cpu")):
        got = myers_cuda.batched_edit_distance_short(
            ac, bc, al, bl, device="cpu", pool_cache=cache)
        np.testing.assert_array_equal(got, want)
    assert myers_chunked.myers_chunked.launches == n  # plain on the CPU


def test_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(61)
    ac, bc, al, bl = _batch(rng, [70, 130, 5], [90, 100, 140], 4)
    args, post = myers_chunked.chunked_inputs(ac, bc, al, bl, "cpu",
                                              block_words=2)
    n = myers_chunked.myers_chunked.launches
    a = myers_chunked.run_chunked(*args)
    b = myers_chunked.run_chunked(*args, plain=True)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(post(a.numpy()), _oracle(ac, bc, al, bl))
    assert myers_chunked.myers_chunked.launches == n


def test_systolic_max_pairs_default():
    al = torch_aligner_mod.BatchAligner("dna", dna_backend="myers",
                                        device="cpu")
    assert al.systolic_max_pairs == 1 << 30


def _jax_long_routes(monkeypatch):
    """taxtk's two long entries at small interpret-mode geometry."""
    real_long = pm.batched_edit_distance_pallas_myers_long
    real_systolic = pms.batched_edit_distance_systolic

    def small_long(a, b, al, bl, **kw):
        kw.pop("interpret", None)
        kw.pop("pool_gather", None)
        return real_long(a, b, al, bl, block_words=8, text_chunk=256,
                         interpret=True, pool_gather=True, **kw)

    def small_systolic(a, b, al, bl, **kw):
        kw.pop("interpret", None)
        return real_systolic(a, b, al, bl, block_words=2, sub_tile=2,
                             text_chunk=64, interpret=True, **kw)

    monkeypatch.setattr(pm, "batched_edit_distance_pallas_myers_long",
                        small_long)
    monkeypatch.setattr(pms, "batched_edit_distance_systolic", small_systolic)


@pytest.mark.parametrize("systolic_max", [512, 0])
def test_oversized_round_route_matches_taxtk(monkeypatch, systolic_max):
    """tests/test_long_segments.py's long routing on both aligners: long
    chunks below systolic_max_pairs take the systolic entry, the others
    (all, at 0) the chunked entry."""
    _jax_long_routes(monkeypatch)
    calls = {"systolic": 0, "long": 0}
    for route, name, extra in (
            ("systolic", "batched_edit_distance_systolic", {}),
            ("long", "batched_edit_distance_long", {"block_words": 8})):
        real = functools.partial(getattr(torch_aligner_mod, name), **extra)

        def counted(*a, _real=real, _route=route, **kw):
            calls[_route] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(torch_aligner_mod, name, counted)
    rng = np.random.default_rng(3)
    pairs = [(rng.integers(0, 4, m).astype(np.uint8),
              rng.integers(0, 4, n).astype(np.uint8))
             for m, n in [(600, 700), (900, 650), (1200, 1300), (80, 90),
                          (2500, 900)]]
    reset_shared_pools()
    aligners = []
    for make in (
            lambda: JaxAligner("dna", dna_backend="myers-pallas",
                               pallas_interpret=True),
            lambda: torch_aligner_mod.BatchAligner("dna", dna_backend="myers",
                                                   device="cpu")):
        al = make()
        al.long_pattern_threshold = 500  # long routing at test sizes
        al.tpu_long_pattern_cap = 2000
        al.tpu_long_text_cap = 4000
        al.systolic_max_pairs = systolic_max
        aligners.append((al, al.align_pairs(pairs)))
    (ref, want), (port, got) = aligners
    assert [(v.distance, v.similarity) for v in got] == [
        (v.distance, v.similarity) for v in want]
    assert [int(v.distance) for v in got] == [
        oracle.edit_distance(a, b) for a, b in pairs]
    assert (port.pairs_aligned, port.cells_computed) == (
        ref.pairs_aligned, ref.cells_computed)
    routed = "long" if systolic_max == 0 else "systolic"
    assert calls[routed] == 1 and sum(calls.values()) == 1, calls


def _old_layout_chain(args):
    """The entry's launches as taxtk chains them, on its int8 [N, B] carry
    stream: myers_block_step block by block.  Yields each block's (score,
    res, hout)."""
    pool, txt_col, peq, pat_idx, mword, mbit, nlen, mlen, N, Kb, bits = args
    text = unpack_columns(pool, txt_col, N, bits)
    score, res = mlen, torch.maximum(mlen, nlen)
    h = torch.ones((N, txt_col.shape[0]), dtype=torch.int8)
    for p in range(peq.shape[0] // Kb):
        score, res, h = myers_block_step(
            peq[p * Kb : (p + 1) * Kb].index_select(2, pat_idx.long()), text,
            mword - p * Kb, mbit, nlen, score, res, h)
        yield score, res, h


@pytest.mark.parametrize("bits", [2, 4])
def test_plain_on_packed_stream_matches_block_step(bits):
    """myers_chunked_plain on the port's packed pair-major carry stream
    equals myers_block_step on taxtk's int8 [N, B] stream, launch by
    launch (score, res and every carry), for 2- and 4-bit pools; sides of
    0, 1, 15, 16 and 17 chars, and texts (the longer sides) at and across
    stream words' edges (31, 33, 63-65, 128, 129 chars)."""
    rng = np.random.default_rng(70 + bits)
    ms = [63, 64, 65, 128, 129, 1, 0, 90, 200, 150, 100, 33]
    ns = [0, 1, 15, 16, 17, 31, 33, 120, 250, 48, 160, 249]
    ac, bc, al, bl = _batch(rng, ms, ns, 4 if bits == 2 else 5)
    args, post = myers_chunked.chunked_inputs(ac, bc, al, bl, "cpu",
                                              block_words=2)
    assert args[-1] == bits
    pool, txt_col, peq, pat_idx, mword, mbit, nlen, mlen, N, Kb, _ = args
    score, res = mlen, torch.maximum(mlen, nlen)
    hin = myers_chunked.initial_carries(N, len(ms), "cpu")
    assert hin.shape == (len(ms), myers_chunked.carry_words(N))
    blocks = 0
    for p, want in enumerate(_old_layout_chain(args)):
        score, res, hin = myers_chunked.myers_chunked_plain(
            pool, txt_col, peq[p * Kb : (p + 1) * Kb], pat_idx,
            mword - p * Kb, mbit, nlen, score, res, hin, bits)
        assert torch.equal(score, want[0]) and torch.equal(res, want[1])
        assert torch.equal(myers_chunked.unpack_carries(hin, N), want[2])
        blocks += 1
    assert blocks == 4  # 200 bp: 7 words in blocks of 2
    np.testing.assert_array_equal(post(res.numpy()), _oracle(ac, bc, al, bl))


@pytest.mark.parametrize("N", [1, 15, 16, 17, 100])
def test_carry_stream_packing_round_trips(N):
    """pack_carries / unpack_carries: the PH carry of char 16w + r at bit r
    of word w, its MH carry at bit 16 + r; the initial stream is ph = 1,
    mh = 0 at every char."""
    rng = np.random.default_rng(N)
    h = torch.from_numpy(rng.integers(0, 4, (N, 3)).astype(np.int8))
    packed = myers_chunked.pack_carries(h)
    assert packed.dtype == torch.int32 and packed.shape == (3, -(-N // 16))
    assert torch.equal(myers_chunked.unpack_carries(packed, N), h)
    words = packed.numpy().view(np.uint32)
    for i in range(3):
        for j in range(N):
            w, r = divmod(j, 16)
            assert (words[i, w] >> r) & 1 == h[j, i] & 1
            assert (words[i, w] >> (16 + r)) & 1 == (h[j, i] >> 1) & 1
    ones = myers_chunked.unpack_carries(
        myers_chunked.initial_carries(N, 3, "cpu"), N)
    assert torch.equal(ones, torch.ones((N, 3), dtype=torch.int8))


def _card_launches(args):
    """Every launch of the entry on the card, each held against the plain
    version on the same inputs (score, res and the carries at every char j
    < nlen, all a later launch reads); the next launch takes the kernel's
    outputs.  Returns the last res."""
    pool, txt_col, peq, pat_idx, mword, mbit, nlen, mlen, N, Kb, bits = args
    score, res = mlen, torch.maximum(mlen, nlen)
    hin = myers_chunked.initial_carries(N, txt_col.shape[0], pool.device)
    live = torch.arange(N, device=pool.device)[:, None] < nlen[None, :]
    for p in range(peq.shape[0] // Kb):
        step = (pool, txt_col, peq[p * Kb : (p + 1) * Kb], pat_idx,
                mword - p * Kb, mbit, nlen, score, res, hin, bits)
        k = myers_chunked.myers_chunked(*step)
        p_out = myers_chunked.myers_chunked_plain(*step)
        assert torch.equal(k[0], p_out[0]), f"score, block {p}"
        assert torch.equal(k[1], p_out[1]), f"res, block {p}"
        assert torch.equal(myers_chunked.unpack_carries(k[2], N)[live],
                           myers_chunked.unpack_carries(p_out[2], N)[live]), (
            f"carries, block {p}")
        score, res, hin = k
    return res


@pytest.mark.cuda
def test_chunked_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    ms = [int(x) for x in rng.integers(2049, 4500, 40)] + [0, 1, 2048, 2049]
    ns = [int(x) for x in rng.integers(1, 5000, len(ms))]
    ac, bc, al, bl = _batch(rng, ms, ns, 5)
    # one launch per 64-word block of the longest pattern (the shorter
    # side): 4025 bp here, two blocks
    blocks = -(-int(np.minimum(al, bl).max()) // (32 * 64))
    assert blocks == 2
    for cache in (None, DevicePoolCache("cuda")):
        args, post = myers_chunked.chunked_inputs(
            ac, bc, al, bl, torch.device("cuda"), pool_cache=cache)
        n = myers_chunked.myers_chunked.launches
        got = myers_chunked.run_chunked(*args)
        assert myers_chunked.myers_chunked.launches == n + blocks
        np.testing.assert_array_equal(post(got.cpu().numpy()),
                                      _oracle(ac, bc, al, bl))
        # the first launch against the plain version, hout where read
        pool, txt_col, peq, pat_idx, mword, mbit, nlen, mlen, N, Kb, bits = (
            args)
        step = (pool, txt_col, peq[:Kb], pat_idx, mword, mbit, nlen, mlen,
                torch.maximum(mlen, nlen),
                myers_chunked.initial_carries(N, len(ms), "cuda"), bits)
        k = myers_chunked.myers_chunked(*step)
        p = myers_chunked.myers_chunked_plain(*step)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        live = torch.arange(N, device="cuda")[:, None] < nlen[None, :]
        assert torch.equal(myers_chunked.unpack_carries(k[2], N)[live],
                           myers_chunked.unpack_carries(p[2], N)[live])


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", [4, 5])
def test_chunked_kernel_edges_on_card(alphabet):
    """Every launch against the plain version, on both pool layouts: texts
    shorter than a warp's 31-step ramp and the 64-step lag between a
    pair's warps (2 to 64 chars, 15, 16 and 17 at a stream word's edge),
    an empty side, pattern ends in word 0, in words 31 and 32 (the edge
    between the pair's warps), in word 63 (2017 and 2048 bp) and in the
    next block (2049 to 4096 bp), 4-bit N codes (alphabet 5), B = 19 (no
    multiple of a block's two pairs) and the aligner's trailing 1 x 1
    dummy rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(80 + alphabet)
    # (pattern, text) lengths; the entry takes the shorter side as the
    # pattern.  Short texts, then pattern ends in words 0, 31, 32 and 63,
    # in the next block, a related pair, and two dummy rows last
    ms = [10, 16, 17, 40, 64, 0, 1, 20, 1000, 1050, 2017, 2048, 2049, 2080,
          4096, 3000, 2200, 1, 1]
    ns = [15, 16, 5, 63, 64, 30, 2, 3000, 1100, 1300, 2500, 2300, 2049,
          4000, 4100, 3100, 5000, 1, 1]
    ac, bc, al, bl = _batch(rng, ms, ns, alphabet)
    bc[16, :2200] = ac[16, :2200]  # a related pair: carries that vary
    for cache in (None, DevicePoolCache("cuda")):
        args, post = myers_chunked.chunked_inputs(
            ac, bc, al, bl, torch.device("cuda"), pool_cache=cache)
        assert args[-1] == (2 if alphabet == 4 else 4)
        res = _card_launches(args)
        np.testing.assert_array_equal(post(res.cpu().numpy()),
                                      _oracle(ac, bc, al, bl))

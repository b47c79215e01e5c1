"""taxtk_torch Myers ops against taxtk, on the CPU.

Inputs come from seeded numpy generators and go to both sides; distances
are integers and must be exactly equal.  On the CPU the kernel wrappers
run their plain PyTorch versions:
  * myers_ref against taxtk's XLA Myers (batched_edit_distance_myers);
  * the short entry (Kernel 1's plain version) against the single-launch
    Pallas kernel in interpret mode on its pool path;
  * the systolic entry (Kernel 2's plain version) against the systolic
    Pallas kernel in interpret mode at the small test geometry of
    tests/test_ops_myers.py.
"""

import pathlib

import numpy as np
import pytest
import torch

from taxtk.ops import oracle
from taxtk.ops.myers_batch import batched_edit_distance_myers, build_peq
from taxtk.ops.pallas_myers import batched_edit_distance_pallas_myers
from taxtk.ops.pallas_myers_systolic import batched_edit_distance_systolic
from taxtk.refpack.store import encode_dna
from taxtk_torch.ops import myers_cuda, myers_ref, myers_systolic
from taxtk_torch.ops.seqpool import DevicePoolCache

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _batch(rng, B, m_range, n_range, alphabet=5):
    al = rng.integers(m_range[0], m_range[1] + 1, B).astype(np.int32)
    bl = rng.integers(n_range[0], n_range[1] + 1, B).astype(np.int32)
    ac = np.zeros((B, max(1, al.max())), np.uint8)
    bc = np.zeros((B, max(1, bl.max())), np.uint8)
    for i in range(B):
        ac[i, : al[i]] = rng.integers(0, alphabet, al[i])
        bc[i, : bl[i]] = rng.integers(0, alphabet, bl[i])
    return ac, bc, al, bl


def _boundary_batch(rng, alphabet):
    """Pattern lengths on and around the 32-bit word edges, with texts of
    nearby lengths, plus empty sides."""
    ms = [1, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128, 129, 0, 5]
    ns = [m + int(d) for m, d in zip(ms, rng.integers(-3, 4, len(ms)))]
    ns = [max(0, n) for n in ns]
    ns[-1] = 0
    B = len(ms)
    ac = np.zeros((B, max(ms)), np.uint8)
    bc = np.zeros((B, max(ns)), np.uint8)
    for i, (m, n) in enumerate(zip(ms, ns)):
        ac[i, :m] = rng.integers(0, alphabet, m)
        bc[i, :n] = rng.integers(0, alphabet, n)
    return ac, bc, np.array(ms, np.int32), np.array(ns, np.int32)


def _oracle(ac, bc, al, bl):
    return np.array([oracle.edit_distance(ac[i, : al[i]], bc[i, : bl[i]])
                     for i in range(len(al))])


@pytest.mark.parametrize("alphabet", [4, 5])
def test_myers_ref_matches_xla(alphabet):
    rng = np.random.default_rng(10 + alphabet)
    for ac, bc, al, bl in (_batch(rng, 60, (0, 200), (0, 220), alphabet),
                           _boundary_batch(rng, alphabet)):
        want = np.asarray(batched_edit_distance_myers(ac, bc, al, bl))
        got = myers_ref.batched_edit_distance_myers(ac, bc, al, bl,
                                                    device="cpu")
        np.testing.assert_array_equal(got, want)


def test_top_bit_carry():
    """Words whose top bit is set must carry 1, not -1: all-match and
    all-mismatch patterns of one and two full words drive PH/MH bit 31."""
    cases = [(b"A" * 32, b"C" * 40), (b"A" * 64, b"A" * 64),
             (b"A" * 64, b"C" * 70), (b"ACGT" * 16, b"TGCA" * 17),
             (b"G" * 33, b"G" * 96)]
    for a, b in cases:
        ea, eb = encode_dna(a), encode_dna(b)
        want = oracle.edit_distance(ea, eb)
        got = myers_ref.batched_edit_distance_myers(
            ea[None], eb[None], np.array([len(ea)], np.int32),
            np.array([len(eb)], np.int32), device="cpu")
        assert int(got[0]) == want, (a, b)
    # a u32 word with bit 31 set survives the int32 carrier unchanged
    peq = np.array([[[0x80000000, 0xFFFFFFFF, 1, 0, 0x7FFFFFFF]]],
                   np.uint32).transpose(0, 2, 1)
    t = myers_ref.peq_to_torch(peq, "cpu")
    assert t.dtype == torch.int32
    back = (t.to(torch.int64) & myers_ref.M32).numpy().astype(np.uint32)
    np.testing.assert_array_equal(back, peq)
    assert torch.equal(myers_ref.to_i32(t.to(torch.int64) & myers_ref.M32), t)


def test_peq_carry_across_matches_taxtk():
    """taxtk's numpy peq, carried across with peq_to_torch, drives the
    port's recurrence to taxtk's distances."""
    rng = np.random.default_rng(7)
    ac, bc, al, bl = _batch(rng, 24, (1, 150), (1, 160))
    K = -(-int(al.max()) // 32)
    peq = build_peq(ac, al, K)
    text = np.where(np.arange(bc.shape[1])[None, :] < bl[:, None], bc, 31).T
    got = myers_ref.myers_wavefront(
        myers_ref.peq_to_torch(peq, "cpu"), torch.from_numpy(text),
        torch.from_numpy(al), torch.from_numpy(bl))
    # pattern = a on both sides here: compare with a's own distances
    want = _oracle(ac, bc, al, bl)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alphabet", [4, 5])
def test_short_entry_matches_pallas(alphabet):
    """2-bit (ACGT) and 4-bit (N codes) wires, with and without the pool
    cache, shared rows, word-edge lengths and empty sides."""
    rng = np.random.default_rng(20 + alphabet)
    ac, bc, al, bl = _batch(rng, 24, (0, 200), (0, 200), alphabet)
    ac[3], al[3] = ac[0], al[0]  # shared rows exercise the dedupe
    bc[5], bl[5] = bc[1], bl[1]
    ec, ed, el, fl = _boundary_batch(rng, alphabet)
    W = max(ac.shape[1], ec.shape[1]), max(bc.shape[1], ed.shape[1])
    ac = np.concatenate([np.pad(ac, ((0, 0), (0, W[0] - ac.shape[1]))),
                         np.pad(ec, ((0, 0), (0, W[0] - ec.shape[1])))])
    bc = np.concatenate([np.pad(bc, ((0, 0), (0, W[1] - bc.shape[1]))),
                         np.pad(ed, ((0, 0), (0, W[1] - ed.shape[1])))])
    al, bl = np.concatenate([al, el]), np.concatenate([bl, fl])
    want = np.asarray(batched_edit_distance_pallas_myers(
        ac, bc, al, bl, interpret=True, pool_gather=True, text_chunk=64))
    np.testing.assert_array_equal(want, _oracle(ac, bc, al, bl))
    for cache in (None, DevicePoolCache("cpu")):
        got = myers_cuda.batched_edit_distance_short(
            ac, bc, al, bl, device="cpu", pool_cache=cache)
        np.testing.assert_array_equal(got, want)


def test_short_entry_k64_and_cap():
    """K = 64 (patterns up to 2048 bp) in the plain version; past Kernel
    1's cap the entry hands the batch to the chunked entry, as taxtk's
    does, and Kernel 1's input prep refuses it."""
    rng = np.random.default_rng(3)
    ac, bc, al, bl = _batch(rng, 3, (1025, 1100), (1000, 1200), 4)
    got = myers_cuda.batched_edit_distance_short(ac, bc, al, bl,
                                                 device="cpu")
    np.testing.assert_array_equal(
        got, np.asarray(batched_edit_distance_myers(ac, bc, al, bl)))
    long_pair = (np.zeros((1, 2049), np.uint8), np.ones((1, 2049), np.uint8),
                 np.array([2049], np.int32), np.array([2049], np.int32))
    assert myers_cuda.batched_edit_distance_short(
        *long_pair, device="cpu").tolist() == [2049]
    with pytest.raises(ValueError, match="chunked entry"):
        myers_cuda.short_inputs(*long_pair, "cpu")


def test_wrappers_use_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    rng = np.random.default_rng(5)
    ac, bc, al, bl = _batch(rng, 12, (1, 200), (1, 200))
    n1, n2 = myers_cuda.myers_short.launches, myers_systolic.myers_systolic.launches
    args, post = myers_cuda.short_inputs(ac, bc, al, bl, "cpu")
    assert torch.equal(myers_cuda.myers_short(*args),
                       myers_cuda.myers_short_plain(*args))
    args, post = myers_systolic.systolic_inputs(ac, bc, al, bl, "cpu",
                                                block_words=2)
    assert torch.equal(myers_systolic.myers_systolic(*args),
                       myers_systolic.myers_systolic_plain(*args))
    assert myers_cuda.myers_short.launches == n1
    assert myers_systolic.myers_systolic.launches == n2


@pytest.mark.parametrize("KC", [1, 2, 4])
def test_systolic_entry_matches_pallas(KC):
    rng = np.random.default_rng(11)
    ac, bc, al, bl = _batch(rng, 11, (20, 300), (20, 300), 5)
    want = batched_edit_distance_systolic(
        ac, bc, al, bl, block_words=KC, sub_tile=2, text_chunk=64,
        interpret=True)
    got = myers_systolic.batched_edit_distance_systolic(
        ac, bc, al, bl, device="cpu", block_words=KC)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alphabet", [4, 5])
def test_systolic_entry_pool_and_edges(alphabet):
    """Pool front end, 2-bit and 4-bit wires, block-edge pattern lengths,
    texts shorter than the block ramp and empty sides."""
    rng = np.random.default_rng(30 + alphabet)
    ac, bc, al, bl = _boundary_batch(rng, alphabet)
    want = batched_edit_distance_systolic(
        ac, bc, al, bl, block_words=2, sub_tile=2, text_chunk=64,
        interpret=True, pool_cache=None)
    for cache in (None, DevicePoolCache("cpu")):
        got = myers_systolic.batched_edit_distance_systolic(
            ac, bc, al, bl, device="cpu", block_words=2, pool_cache=cache)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, _oracle(ac, bc, al, bl))
    # texts shorter than the stagger ramp, at the default 32-word blocks
    ac, bc, al, bl = _batch(rng, 4, (2100, 3300), (3, 9), alphabet)
    got = myers_systolic.batched_edit_distance_systolic(
        ac, bc, al, bl, device="cpu")
    np.testing.assert_array_equal(got, _oracle(ac, bc, al, bl))


def _golden_dna():
    rows = []
    for name in ("seqan_golden.tsv", "seqan_golden_r2.tsv"):
        for line in (FIXTURES / name).read_text().splitlines():
            if line.startswith("dna\t"):
                _, a, b, d = line.split("\t")
                rows.append((encode_dna(a), encode_dna(b), int(d)))
    return rows


def test_seqan_golden_dna_rows():
    """Every DNA row of the SeqAn golden corpora through the port's aligner
    (plain versions: short buckets and the systolic stream), and the short
    rows through myers_ref."""
    from taxtk_torch.engine.aligner import BatchAligner

    rows = _golden_dna()
    assert len(rows) >= 1700
    aligner = BatchAligner("dna", dna_backend="myers", device="cpu")
    values = aligner.align_pairs([(a, b) for a, b, _ in rows])
    assert [int(v.distance) for v in values] == [d for _, _, d in rows]
    short = [r for r in rows if max(len(r[0]), len(r[1])) <= 256]
    B = len(short)
    ac = np.zeros((B, 256), np.uint8)
    bc = np.zeros((B, 256), np.uint8)
    al = np.array([len(a) for a, _, _ in short], np.int32)
    bl = np.array([len(b) for _, b, _ in short], np.int32)
    for i, (a, b, _) in enumerate(short):
        ac[i, : len(a)] = a
        bc[i, : len(b)] = b
    np.testing.assert_array_equal(
        myers_ref.batched_edit_distance_myers(ac, bc, al, bl, device="cpu"),
        [d for _, _, d in short])

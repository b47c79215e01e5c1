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
import subprocess
import sys

import numpy as np
import pytest
import torch

from taxtk.ops import oracle
from taxtk.ops.myers_batch import batched_edit_distance_myers, build_peq
from taxtk.ops.pallas_myers import batched_edit_distance_pallas_myers
from taxtk.ops.pallas_myers_systolic import batched_edit_distance_systolic
from taxtk.refpack.store import encode_dna
from taxtk_torch.engine.aligner import LONG_PATTERN_CAP
from taxtk_torch.native import myers_batch
from taxtk_torch.ops import myers_cuda, myers_ref, myers_systolic
from taxtk_torch.ops.host import LANE, STAG, _pack_systolic
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


def _related(rng, m, n, alphabet, mutate=0.05):
    """(a, b): b random of length n, a a copy of b resized to m with a
    share `mutate` of its codes redrawn, as RPA realigns related pairs."""
    b = rng.integers(0, alphabet, n).astype(np.uint8)
    a = np.resize(b, m)
    mut = rng.random(m) < mutate
    a[mut] = rng.integers(0, alphabet, int(mut.sum()))
    return a, b


def _pairs_batch(pairs):
    B = len(pairs)
    ac = np.zeros((B, max(1, max(len(a) for a, _ in pairs))), np.uint8)
    bc = np.zeros((B, max(1, max(len(b) for _, b in pairs))), np.uint8)
    for i, (a, b) in enumerate(pairs):
        ac[i, : len(a)] = a
        bc[i, : len(b)] = b
    return (ac, bc, np.array([len(a) for a, _ in pairs], np.int32),
            np.array([len(b) for _, b in pairs], np.int32))


@pytest.mark.parametrize("alphabet", [4, 5])
def test_systolic_entry_slot_edges_default_blocks(alphabet):
    """The default 32-word (1024 bp) slots with patterns on the slot edges:
    2049 bp (a third slot of one bp), 3072 (three full slots) and 3073 (a
    fourth slot of one bp), related and unrelated, either side the
    pattern, on the 2-bit and 4-bit wires, with and without the pool
    cache.  The pattern is the shorter side, so each text is at most 40
    chars longer than its pattern, which keeps the plain version's steps
    near 3,100."""
    rng = np.random.default_rng(40 + alphabet)
    pairs = []
    for m in (2049, 3072, 3073):
        a, b = _related(rng, m, m + int(rng.integers(0, 41)), alphabet)
        pairs += [(a, b), (b, a)]
    pairs.append((rng.integers(0, alphabet, 3073).astype(np.uint8),
                  rng.integers(0, alphabet, 3080).astype(np.uint8)))
    ac, bc, al, bl = _pairs_batch(pairs)
    want = _oracle(ac, bc, al, bl)
    for cache in (None, DevicePoolCache("cpu")):
        got = myers_systolic.batched_edit_distance_systolic(
            ac, bc, al, bl, device="cpu", pool_cache=cache)
        np.testing.assert_array_equal(got, want)


def test_systolic_pair_table_and_kernel_geometry():
    """The per-pair table of the kernel's block-per-pair launch maps each
    pair to its own contiguous slots, inside one 128-slot row, in the slot
    order the plain version reads; the KW the wrapper picks covers every
    pattern up to the aligner's LONG_PATTERN_CAP, and one block more is
    refused."""
    rng = np.random.default_rng(8)
    ms = [0, 1, 1024, 1025, 2049, 3072, 3073, 40_000, 65_537, 98_304]
    ms += [int(x) for x in rng.integers(2049, 20_000, 30)]
    ns = [m + int(rng.integers(0, 100)) for m in ms]
    ns[0] = 0
    B = len(ms)
    ac = np.zeros((B, max(ms)), np.uint8)
    bc = np.zeros((B, max(ns)), np.uint8)
    inputs, (R, _, _) = _pack_systolic(
        ac, bc, np.array(ms, np.int32), np.array(ns, np.int32), 32,
        build_pools=False)
    table = inputs["pair_slots"]
    assert table.shape == (B, 2) and table.dtype == np.int32
    assert R > 1  # the pairs fill more than one row
    head = inputs["head"].reshape(-1)
    lanek = inputs["lanek"].reshape(-1)
    nlen = inputs["nlen"].reshape(-1)
    mlen = inputs["mlen"].reshape(-1)
    mword = inputs["mword"].reshape(-1)
    owner = np.full(R * LANE, -1)
    for i, (first, nb) in enumerate(table):
        assert nb == max(1, -(-ms[i] // 1024))
        slots = np.arange(first, first + nb)
        assert first // LANE == (first + nb - 1) // LANE  # one row
        assert (owner[slots] == -1).all()
        owner[slots] = i
        assert head[first] == 1 and (head[slots[1:]] == 0).all()
        np.testing.assert_array_equal(lanek[slots], STAG * np.arange(nb))
        assert (nlen[slots] == ns[i]).all() and (mlen[slots] == ms[i]).all()
        # the pattern end lies in the pair's last slot, at word (m-1) >> 5
        assert (mword[slots[:-1]] == -1).all()
        assert (nb - 1) * 32 + mword[slots[-1]] == (max(ms[i], 1) - 1) >> 5
    free = owner == -1
    assert (nlen[free] == 0).all() and (head[free] == 0).all()
    assert (mword[free] == -1).all()

    cap_blocks = -(-LONG_PATTERN_CAP // 1024)
    for nb in range(1, cap_blocks + 1):
        kw, warps = myers_systolic.kernel_geometry(nb)
        assert kw in (2, 3) and 1 <= warps <= 32
        assert kw * warps >= nb  # every pattern word has a lane
        assert kw * (warps - 1) < nb  # and the pair's last warp has work
        assert kw == (2 if nb < myers_systolic.KW3_BLOCKS else 3)
    with pytest.raises(ValueError, match="pattern blocks"):
        myers_systolic.kernel_geometry(cap_blocks + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [2, 3])
def test_systolic_kernel_matches_plain_on_card(kw):
    """Kernel 2 against its plain version, every output element (on the
    pool-cache layout; the one-off layout against that output), and the
    host C++ Myers after post: a ragged 4-bit batch of 2-6 kbp patterns
    at KW = 2 and one 66 kbp pair beside a short one at KW = 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(50 + kw)
    if kw == 2:
        pairs = [_related(rng, int(m), int(m) + int(rng.integers(0, 500)), 5)
                 for m in rng.integers(2049, 6000, 20)]
    else:
        pairs = [_related(rng, 65_600, 65_650, 4), _related(rng, 2100, 2200, 4)]
    ac, bc, al, bl = _pairs_batch(pairs)
    want = None
    for cache in (DevicePoolCache("cuda"), None):
        args, post = myers_systolic.systolic_inputs(
            ac, bc, al, bl, torch.device("cuda"), pool_cache=cache)
        assert myers_systolic.kernel_geometry(args[-2])[0] == kw
        n = myers_systolic.myers_systolic.launches
        got = myers_systolic.myers_systolic(*args)
        assert myers_systolic.myers_systolic.launches == n + 1
        if want is None:  # the plain version takes ~1 min at 66 kbp
            want = myers_systolic.myers_systolic_plain(*args)
        assert torch.equal(got, want)
        np.testing.assert_array_equal(post(got.cpu().numpy()),
                                      myers_batch(pairs))


_UNDERSIZED_LAUNCH = """
import numpy as np, torch
from taxtk_torch.ops import myers_systolic as ms
a = np.random.default_rng(0).integers(0, 4, (1, 5000)).astype(np.uint8)
n = np.array([5000], np.int32)
args, _ = ms.systolic_inputs(a, a.copy(), n, n, torch.device("cuda"))
assert args[-2] == 5
try:  # nb_max 1 sizes the launch at one warp (2 slots) for 5 slots
    ms.myers_systolic(*args[:-2], 1, args[-1])
    torch.cuda.synchronize()
except RuntimeError as e:
    print("refused:", e)
"""


@pytest.mark.cuda
def test_systolic_kernel_refuses_undersized_launch():
    """A launch sized (nb_max) below one of its pairs' slot counts stops
    with a CUDA error instead of computing a wrong distance or syncing
    threads the block lacks; in a child process, since the error ends the
    process's CUDA context."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _UNDERSIZED_LAUNCH],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert "refused:" in run.stdout, run.stdout + run.stderr


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

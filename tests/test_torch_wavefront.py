"""taxtk_torch's min-plus DNA wavefront against taxtk, on the CPU.

Inputs come from seeded numpy generators and go to both sides; integers
must be exactly equal.  On the CPU the kernel wrapper runs its plain
version (ops/dna_align.py::edit_distance_wavefront):
  * the plain version against taxtk's dna_align.batched_edit_distance (XLA)
    and pallas_dna.batched_edit_distance_pallas in interpret mode;
  * the `wavefront` and `wavefront-cuda` DNA backends of the port's
    aligner against taxtk's `wavefront` backend: values, pairs and cells,
    and wavefront-cuda's one launch per pow2 class up to its scratch cap;
  * the kernel's launch geometry (bands, tickets, the row/column swap);
  * dna_alignment_stats against taxtk's, and the wrapper's refusal of
    lengths past the padded widths.
"""

import numpy as np
import pytest
import torch

from taxtk.engine.aligner import BatchAligner as JaxAligner
from taxtk.ops import dna_align as jax_dna_align
from taxtk.ops import oracle
from taxtk.ops.pallas_dna import batched_edit_distance_pallas
from taxtk_torch.engine.aligner import BatchAligner
from taxtk_torch.ops import dna_align, dna_wavefront


def _batch(rng, B, m_range, n_range, alphabet=5, edges=True):
    """Ragged pairs padded to [B, M] and [B, N] with M != N; pad codes are
    random, so any read past a pair's lengths would show.  edges: the
    first four pairs get length-1 and empty sides."""
    al = rng.integers(m_range[0], m_range[1] + 1, B).astype(np.int32)
    bl = rng.integers(n_range[0], n_range[1] + 1, B).astype(np.int32)
    if edges:
        al[:4] = [1, 1, 0, 1]
        bl[:4] = [1, 7, 5, 0]
    ac = rng.integers(0, alphabet, (B, m_range[1] + 3)).astype(np.uint8)
    bc = rng.integers(0, alphabet, (B, n_range[1] + 11)).astype(np.uint8)
    return ac, bc, al, bl


def _oracle(ac, bc, al, bl):
    return np.array([oracle.edit_distance(ac[i, : al[i]], bc[i, : bl[i]])
                     for i in range(len(al))])


@pytest.mark.parametrize("alphabet", [4, 5])
def test_plain_matches_taxtk(alphabet):
    rng = np.random.default_rng(70 + alphabet)
    ac, bc, al, bl = _batch(rng, 37, (0, 60), (0, 90), alphabet)
    got = dna_align.batched_edit_distance(ac, bc, al, bl, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jax_dna_align.batched_edit_distance(ac, bc, al, bl)))
    np.testing.assert_array_equal(
        got, batched_edit_distance_pallas(ac, bc, al, bl, interpret=True))
    np.testing.assert_array_equal(got, _oracle(ac, bc, al, bl))


def test_n_codes_match_each_other():
    """N (code 4) matches N by equality, as in taxtk."""
    a = np.array([[4, 4, 0, 1]], np.uint8)
    b = np.array([[4, 4, 0, 2]], np.uint8)
    lens = np.array([4], np.int32)
    assert dna_align.batched_edit_distance(a, b, lens, lens,
                                           device="cpu").tolist() == [1]


def test_wrapper_and_entry_use_plain_version_on_cpu():
    rng = np.random.default_rng(72)
    ac, bc, al, bl = _batch(rng, 21, (0, 40), (0, 50))
    n = dna_wavefront.dna_wavefront.launches
    args = dna_align.wavefront_inputs(ac, bc, al, bl, "cpu")
    assert torch.equal(dna_wavefront.dna_wavefront(*args),
                       dna_align.edit_distance_wavefront(*args))
    dev, post = dna_wavefront.batched_edit_distance_wavefront(
        ac, bc, al, bl, device="cpu", lazy="device")
    np.testing.assert_array_equal(post(dev.numpy()), _oracle(ac, bc, al, bl))
    assert dna_wavefront.dna_wavefront.launches == n


@pytest.mark.parametrize("side,row,past", [("a", 0, 1), ("a", 1, None),
                                           ("b", 2, None), ("b", 3, 1)])
def test_wrapper_refuses_lengths_past_padded_widths(side, row, past):
    """a_len past M or b_len past N (past = 1), or a negative length
    (past = None), raises before any launch, on every device: in the
    wrapper and, on the host copy, in the entry."""
    rng = np.random.default_rng(74)
    ac, bc, al, bl = _batch(rng, 6, (0, 40), (0, 50))
    lens, width = (al, ac.shape[1]) if side == "a" else (bl, bc.shape[1])
    lens[row] = -1 if past is None else width + past
    args = dna_align.wavefront_inputs(ac, bc, al, bl, "cpu")
    n = dna_wavefront.dna_wavefront.launches
    with pytest.raises(ValueError, match="padded widths"):
        dna_wavefront.dna_wavefront(*args)
    with pytest.raises(ValueError, match="padded widths"):
        dna_wavefront.batched_edit_distance_wavefront(ac, bc, al, bl,
                                                      device="cpu")
    assert dna_wavefront.dna_wavefront.launches == n


def test_alignment_stats_match_taxtk():
    rng = np.random.default_rng(75)
    ac, bc, al, bl = _batch(rng, 29, (0, 60), (0, 90))
    dist = dna_align.batched_edit_distance(ac, bc, al, bl, device="cpu")
    got = dna_align.dna_alignment_stats(dist, al, bl)
    want = jax_dna_align.dna_alignment_stats(dist, al, bl)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("backend", ["wavefront", "wavefront-cuda"])
def test_aligner_matches_taxtk_wavefront(backend):
    """Square pow2 buckets of the longer side, capped at
    max_batch_cells // L^2 pairs; no long route (pairs past the lowered
    long-pattern threshold stay in buckets); empty sides on the host; no
    pool cache."""
    rng = np.random.default_rng(73)
    lens = [(0, 30), (40, 0), (1, 1), (50, 70), (300, 280), (130, 40),
            (120, 125), (17, 16), (16, 17), (600, 640), (700, 520)]
    pairs = [(rng.integers(0, 5, m).astype(np.uint8),
              rng.integers(0, 5, n).astype(np.uint8)) for m, n in lens]
    ref = JaxAligner("dna", dna_backend="wavefront", max_batch_cells=1 << 17)
    port = BatchAligner("dna", dna_backend=backend, device="cpu",
                        max_batch_cells=1 << 17)
    for al in (ref, port):
        al.long_pattern_threshold = 200
    assert port.pool_cache is None
    want = ref.align_pairs(pairs)
    got = port.align_pairs(pairs)
    assert [(v.distance, v.similarity) for v in got] == [
        (v.distance, v.similarity) for v in want]
    assert [int(v.distance) for v in got] == [
        oracle.edit_distance(a, b) for a, b in pairs]
    assert (port.pairs_aligned, port.cells_computed) == (
        ref.pairs_aligned, ref.cells_computed)
    assert "host_long" not in port.stage_seconds


@pytest.mark.parametrize("max_batch_cells,launches", [
    # taxtk's L^2 cap splits every class into sub-buckets of 1-8 pairs;
    # the port's B x (L + 1) scratch cap keeps each class in one launch
    (1 << 16, {64: 1, 128: 1, 256: 1, 1024: 1}),
    # a scratch cap of 6 pairs at L = 1024 and of 24 at L = 256
    (6200, {64: 1, 128: 1, 256: 2, 1024: 2})])
def test_aligner_sends_each_class_in_one_launch(monkeypatch, max_batch_cells,
                                                launches):
    """wavefront-cuda packs the pairs of a pow2 class into one launch (no
    dummy rows) up to B x (L + 1) <= max_batch_cells, where taxtk cuts
    the class into max_batch_cells // L^2 pair sub-buckets; distances,
    pairs_aligned and cells_computed (taxtk's dummy rows included) equal
    taxtk's wavefront backend."""
    rng = np.random.default_rng(76)
    lens = ([(rng.integers(33, 65), rng.integers(1, 65)) for _ in range(9)]
            + [(rng.integers(1, 129), 128) for _ in range(5)]
            + [(rng.integers(129, 257), rng.integers(0, 257))
               for _ in range(30)]
            + [(rng.integers(100, 600), rng.integers(513, 1025))
               for _ in range(7)])
    pairs = [(rng.integers(0, 5, m).astype(np.uint8),
              rng.integers(0, 5, n).astype(np.uint8)) for m, n in lens]
    calls = []
    real = dna_wavefront._launch

    def spy(a, b, a_len, b_len):
        calls.append((a.shape[1], len(a_len), int((a_len == 1).sum())))
        return real(a, b, a_len, b_len)

    monkeypatch.setattr(dna_wavefront, "_launch", spy)
    ref = JaxAligner("dna", dna_backend="wavefront",
                     max_batch_cells=max_batch_cells)
    port = BatchAligner("dna", dna_backend="wavefront-cuda", device="cpu",
                        max_batch_cells=max_batch_cells)
    want = ref.align_pairs(pairs)
    got = port.align_pairs(pairs)
    assert [(v.distance, v.similarity) for v in got] == [
        (v.distance, v.similarity) for v in want]
    assert (port.pairs_aligned, port.cells_computed) == (
        ref.pairs_aligned, ref.cells_computed)
    per_class = {}
    for L, B, _ in calls:
        per_class[L] = per_class.get(L, 0) + 1
        assert B * (L + 1) <= max_batch_cells
    assert per_class == launches
    # no dummy rows: every row is a pair of the class (none is 1 x 1 here)
    assert sum(B for _, B, _ in calls) == sum(1 for m, n in lens if m and n)
    assert all(ones == 0 for *_, ones in calls)


@pytest.mark.parametrize("M,N,B", [(1024, 1024, 1), (1024, 1024, 300),
                                   (300, 700, 37), (64, 64, 50)])
@pytest.mark.parametrize("R", dna_wavefront.ROWS_PER_LANE)
def test_kernel_geometry_covers_each_strip_once(M, N, B, R):
    """The launch geometry the kernel reads, as its source sets it out:
    band-major tickets (ticket t is band t // B of pair t % B, so band
    b - 1 of a pair holds ticket t - B), rows on each pair's longer side,
    bands of nw warps of 32 * R rows; every row of every pair lies in
    exactly one warp's strip, tickets past a pair's bands are passed over,
    and no pair's shorter side is wider than the boundary scratch
    (min(M, N)).  nw is BAND_WARPS, or the most strips a pair can have if
    fewer; R defaults to 8 from FILL_STRIPS strips of 256 rows on, else
    4."""
    rng = np.random.default_rng(M + N + B + R)
    al = rng.integers(0, M + 1, B)
    bl = rng.integers(0, N + 1, B)
    al[0] = 0 if B > 1 else M  # an empty side, or the widest pair
    R_, nw, tickets = dna_wavefront.kernel_geometry(B, M, N, R=R)
    H = 32 * R
    strips_max = -(-max(M, N) // H)
    assert R_ == R and nw == min(dna_wavefront.BAND_WARPS, strips_max)
    big = B * -(-max(M, N) // 256) >= dna_wavefront.FILL_STRIPS
    assert dna_wavefront.kernel_geometry(B, M, N)[0] == (8 if big else 4)
    owner = {}  # (pair, row) -> ticket
    for t in range(tickets):
        band, p = divmod(t, B)
        m, n = int(al[p]), int(bl[p])
        rows, cols = max(m, n), min(m, n)  # b's codes are rows when n > m
        strips = -(-rows // H) if cols else 0
        if band * nw >= strips:
            continue
        assert cols <= min(M, N)
        if band:
            assert (t - B) % B == p and (t - B) // B == band - 1
        for w in range(min(nw, strips - band * nw)):
            s0 = (band * nw + w) * H
            for i in range(s0, min(s0 + H, rows)):
                assert (p, i) not in owner
                owner[(p, i)] = t
    assert len(owner) == sum(max(int(a), int(b)) for a, b in zip(al, bl)
                             if min(int(a), int(b)) > 0)


@pytest.mark.cuda
def test_wavefront_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    for B, m_range, n_range in ((300, (0, 300), (0, 400)),
                                (3, (900, 1500), (1000, 1400))):
        ac, bc, al, bl = _batch(rng, B, m_range, n_range, edges=B > 4)
        args = dna_align.wavefront_inputs(ac, bc, al, bl, "cuda")
        n = dna_wavefront.dna_wavefront.launches
        got = dna_wavefront.dna_wavefront(*args)
        assert dna_wavefront.dna_wavefront.launches == n + 1
        assert torch.equal(got, dna_align.edit_distance_wavefront(*args))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _oracle(ac, bc, al, bl))


@pytest.mark.cuda
@pytest.mark.parametrize("R", dna_wavefront.ROWS_PER_LANE)
def test_wavefront_kernel_band_edges_on_card(monkeypatch, R):
    """The kernel at each R against the plain version and the oracle: a
    mixed launch (bands of nw = 4 warps) with pairs at band and strip
    edges (nw * 32 * R rows +- 1, 32 * R +- 1), rows on either side (the
    swap), m << n and m >> n, length-1 and empty sides; then a single
    pair of many bands at the geometry's own nw."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    real = dna_wavefront.kernel_geometry
    force = {"R": R, "nw": 4}
    monkeypatch.setattr(dna_wavefront, "kernel_geometry",
                        lambda *a, **k: real(*a, **{**k, **force}))
    band = 4 * 32 * R
    strip = 32 * R
    lens = [(band - 1, 700), (band, 700), (band + 1, 700), (2 * band + 1, 300),
            (700, band + 1), (300, 2 * band - 1), (strip - 1, strip + 1),
            (strip + 1, strip), (3, 2000), (2000, 3), (1, 1), (1, 900),
            (900, 1), (0, 5), (5, 0), (0, 0), (40, 50)]
    rng = np.random.default_rng(77 + R)
    for one in (False, True):
        if one:
            force.pop("nw")
            lens = [(6 * band + 17, 3000)]
        al = np.array([m for m, _ in lens], np.int32)
        bl = np.array([n for _, n in lens], np.int32)
        ac = rng.integers(0, 5, (len(lens), al.max() + 5)).astype(np.uint8)
        bc = rng.integers(0, 5, (len(lens), bl.max() + 3)).astype(np.uint8)
        args = dna_align.wavefront_inputs(ac, bc, al, bl, "cuda")
        n = dna_wavefront.dna_wavefront.launches
        got = dna_wavefront.dna_wavefront(*args)
        assert dna_wavefront.dna_wavefront.launches == n + 1
        assert torch.equal(got, dna_align.edit_distance_wavefront(*args))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _oracle(ac, bc, al, bl))

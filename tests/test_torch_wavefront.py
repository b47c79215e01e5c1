"""taxtk_torch's min-plus DNA wavefront against taxtk, on the CPU.

Inputs come from seeded numpy generators and go to both sides; integers
must be exactly equal.  On the CPU the kernel wrapper runs its plain
version (ops/dna_align.py::edit_distance_wavefront):
  * the plain version against taxtk's dna_align.batched_edit_distance (XLA)
    and pallas_dna.batched_edit_distance_pallas in interpret mode;
  * the `wavefront` and `wavefront-cuda` DNA backends of the port's
    aligner against taxtk's `wavefront` backend: values, pairs and cells;
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


def _batch(rng, B, m_range, n_range, alphabet=5):
    """Ragged pairs padded to [B, M] and [B, N] with M != N; pad codes are
    random, so any read past a pair's lengths would show."""
    al = rng.integers(m_range[0], m_range[1] + 1, B).astype(np.int32)
    bl = rng.integers(n_range[0], n_range[1] + 1, B).astype(np.int32)
    al[:4] = [1, 1, 0, 1]  # length-1 and empty sides
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


@pytest.mark.cuda
def test_wavefront_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    for B, m_range, n_range in ((300, (0, 300), (0, 400)),
                                (3, (900, 1500), (1000, 1400))):
        ac, bc, al, bl = _batch(rng, B, m_range, n_range)
        args = dna_align.wavefront_inputs(ac, bc, al, bl, "cuda")
        n = dna_wavefront.dna_wavefront.launches
        got = dna_wavefront.dna_wavefront(*args)
        assert dna_wavefront.dna_wavefront.launches == n + 1
        assert torch.equal(got, dna_align.edit_distance_wavefront(*args))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _oracle(ac, bc, al, bl))

"""taxtk_torch protein path against taxtk, on the CPU.

Inputs come from seeded numpy generators and go to both sides; every
comparison is exact (integer stats equal, float32 distance/similarity
bit-equal).  On the CPU the kernel wrappers run their plain version:
  * protein_ref against taxtk's XLA wavefront (protein_align);
  * the port's entry against the v5/v6 Pallas kernels in interpret mode,
    on both layouts, with the same pool traffic;
  * both SeqAn golden corpora through the entry;
  * the protein aligner, engine (GFF3 and -l log) and the taxator ->
    binner CLI chain against taxtk's.
The `cuda` tests hold each kernel against the plain version on a card
and skip without one.
"""

import io
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))

from bench_e2e import make_workload_protein  # noqa: E402
from test_protein_cli import protein_refpack  # noqa: E402,F401
from test_torch_engine import _run_engine  # noqa: E402

from taxtk.cli import binner as jax_binner  # noqa: E402
from taxtk.cli import taxator as jax_taxator  # noqa: E402
from taxtk.engine.aligner import BatchAligner as JaxAligner  # noqa: E402
from taxtk.ops import pallas_protein as pp  # noqa: E402
from taxtk.ops.protein_align import batched_protein_align  # noqa: E402
from taxtk.ops.seqpool import DevicePoolCache as JaxPoolCache  # noqa: E402
from taxtk.refpack.store import encode_protein  # noqa: E402
from taxtk_torch.cli import binner as torch_binner  # noqa: E402
from taxtk_torch.cli import taxator as torch_taxator  # noqa: E402
from taxtk_torch.engine.aligner import BatchAligner  # noqa: E402
from taxtk_torch.ops import host, protein_cuda, protein_ref  # noqa: E402
from taxtk_torch.ops.blosum import BLOSUM62  # noqa: E402
from taxtk_torch.ops.seqpool import (  # noqa: E402
    DevicePoolCache, from_jax_state, reset_shared_pools,
)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
X, STOP = 25, 26  # codes of 'X' and '*' in the SeqAn AminoAcid alphabet


def _batch(rng, B, a_range, b_range, related=True):
    """Padded batch of protein codes: b a copy of a with about a quarter
    of its residues redrawn (RPA realigns related segments), X and * codes
    sprinkled in, pad bytes past the lengths random."""
    al = rng.integers(a_range[0], a_range[1] + 1, B).astype(np.int32)
    bl = rng.integers(b_range[0], b_range[1] + 1, B).astype(np.int32)
    ac = rng.integers(0, 27, (B, max(1, al.max()))).astype(np.uint8)
    bc = rng.integers(0, 27, (B, max(1, bl.max()))).astype(np.uint8)
    if related:
        n = min(ac.shape[1], bc.shape[1])
        keep = rng.random((B, n)) < 0.75
        bc[:, :n] = np.where(keep, ac[:, :n], bc[:, :n])
    ac[rng.random(ac.shape) < 0.03] = X
    bc[rng.random(bc.shape) < 0.03] = STOP
    return ac, bc, al, bl


def _assert_same(got, want):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype == np.float32:  # bit-equal, signed zeros included
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _ragged(seed):
    rng = np.random.default_rng(seed)
    ac, bc, al, bl = _batch(rng, 21, (0, 90), (0, 110))
    al[0], bl[1], al[2], bl[2] = 0, 0, 0, 0  # empty sides
    al[3], bl[3] = 1, 1
    ac[5], al[5] = ac[4], al[4]  # a shared row exercises the dedupe
    return ac, bc, al, bl


def test_protein_ref_matches_xla():
    ac, bc, al, bl = _ragged(1)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = batched_protein_align(ac, bc, al, bl)
        got = protein_ref.batched_protein_align(ac, bc, al, bl, device="cpu")
    _assert_same(got, want)


@pytest.mark.parametrize("swar", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_entry_matches_pallas(swar, cached):
    """v5 (and, with swar, v6) in interpret mode against the port's entry,
    on the one-off pool and on a pool cache, with the same pool traffic."""
    ac, bc, al, bl = _ragged(2 + swar)
    ref_cache = JaxPoolCache() if cached else None
    want = pp.batched_protein_align_pallas(
        ac, bc, al, bl, sub_tile=8, interpret=True, swar=swar,
        pool_cache=ref_cache)
    cache = DevicePoolCache("cpu") if cached else None
    got = protein_cuda.batched_protein_align_cuda(
        ac, bc, al, bl, device="cpu", swar=swar, pool_cache=cache)
    _assert_same(got, want)
    if cached:
        assert (cache.hits, cache.misses, cache.bytes_shipped) == (
            ref_cache.hits, ref_cache.misses, ref_cache.bytes_shipped)
        assert list(cache.pools) == list(ref_cache.pools)


def test_entry_routes_swar_as_taxtk(monkeypatch):
    """swar=None reads TAXTK_PROTEIN_SWAR at call time; a bucket outside
    _swar_fits takes v5 even then.  lazy="device" returns [3, B]."""
    calls = []
    for name in ("protein_wavefront", "protein_swar"):
        real = getattr(protein_cuda, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(protein_cuda, name, spy)
    rng = np.random.default_rng(9)
    ac, bc, al, bl = _batch(rng, 5, (1, 60), (1, 60))
    monkeypatch.delenv("TAXTK_PROTEIN_SWAR", raising=False)
    protein_cuda.batched_protein_align_cuda(ac, bc, al, bl, device="cpu")
    monkeypatch.setenv("TAXTK_PROTEIN_SWAR", "1")
    dev, post = protein_cuda.batched_protein_align_cuda(
        ac, bc, al, bl, device="cpu", lazy="device")
    assert dev.shape == (3, 5) and dev.dtype == torch.int32
    _assert_same(post(dev.numpy()), pp.batched_protein_align_pallas(
        ac, bc, al, bl, sub_tile=8, interpret=True))
    wide = np.zeros((1, 1200), np.uint8)
    one = np.array([3], np.int32)
    protein_cuda.batched_protein_align_cuda(wide, wide, one, one,
                                            device="cpu")
    assert calls == ["protein_wavefront", "protein_swar", "protein_wavefront"]
    for M, N in ((16, 16), (512, 512), (1024, 1024), (1100, 1100), (64, 900)):
        assert protein_cuda._swar_fits(*protein_cuda._shapes(M, N)[:2]) == \
            pp._swar_fits(*pp._shapes(1, M, N, 8)[:2])


def test_tables_and_shapes_match_taxtk():
    np.testing.assert_array_equal(protein_cuda._PACKED, pp._PACKED)
    np.testing.assert_array_equal(protein_cuda._DIAG, pp._DIAG)
    assert protein_cuda._POOL_HC_FLOOR == pp._POOL_HC_FLOOR
    # the kernels' 32 x 32 table is v5's nibble extraction
    np.testing.assert_array_equal(protein_cuda.SUB[:27, :27], BLOSUM62)
    assert (protein_cuda.SUB[27:] == -4).all()
    assert (protein_cuda.SUB[:, 27:] == -4).all()
    for M, N in ((1, 1), (16, 16), (128, 128), (129, 300), (2048, 2048)):
        assert protein_cuda._shapes(M, N) == pp._shapes(7, M, N, 8)[:3]


def test_bits8_pool_and_jax_state_carry():
    """bits=8 packs one raw code per byte with 0xFF pad, and taxtk's
    resident protein pool, carried across, serves the port's entry with
    the same slots: every row hits and the results agree."""
    rows = [np.array([1, 2, 3], np.uint8), np.array([26, 25], np.uint8)]
    packed = host._pack_text_pool(rows, np.array([3, 2], np.int32),
                                  np.array([True, True]), 4, 2, bits=8)
    np.testing.assert_array_equal(
        packed.view(np.uint8), [[1, 26], [2, 25], [3, 255], [255, 255]])
    rng = np.random.default_rng(4)
    ac, bc, al, bl = _batch(rng, 12, (1, 120), (1, 120))
    ref = JaxPoolCache()
    want = pp.batched_protein_align_pallas(ac, bc, al, bl, sub_tile=8,
                                           interpret=True, pool_cache=ref)
    (bits, Hc), pool = next(iter(ref.pools.items()))
    assert bits == 8
    port = from_jax_state(np.asarray(pool.dev), pool.slots, bits=8,
                          device="cpu")
    assert port.pools[(8, Hc)].n_used == pool.n_used
    got = protein_cuda.batched_protein_align_cuda(ac, bc, al, bl,
                                                  device="cpu",
                                                  pool_cache=port)
    _assert_same(got, want)
    assert port.misses == 0 and port.hits == 2 * len(al)


def _golden_protein():
    rows = []
    for name in ("seqan_golden.tsv", "seqan_golden_r2.tsv"):
        for line in (FIXTURES / name).read_text().splitlines():
            if line.startswith("prot\t"):
                _, a, b, vals = line.split("\t")
                rows.append((encode_protein(a), encode_protein(b),
                             tuple(map(int, vals.split(",")))))
    return rows


def test_seqan_golden_protein_rows():
    """Every protein pair of both SeqAn corpora through the port's entry,
    bucketed by pow2 of the longer side (tests/test_seqan_golden.py),
    including the reference's float32 normalization."""
    rows = _golden_protein()
    assert len(rows) >= 2000
    buckets = {}
    for i, (a, b, _) in enumerate(rows):
        buckets.setdefault(host._pow2(max(len(a), len(b), 1)), []).append(i)
    checked = 0
    for L, idxs in buckets.items():
        B = len(idxs)
        ac = np.zeros((B, L), np.uint8)
        bc = np.zeros((B, L), np.uint8)
        al = np.zeros(B, np.int32)
        bl = np.zeros(B, np.int32)
        for r, i in enumerate(idxs):
            a, b, _ = rows[i]
            ac[r, : len(a)], bc[r, : len(b)] = a, b
            al[r], bl[r] = len(a), len(b)
        got = protein_cuda.batched_protein_align_cuda(ac, bc, al, bl,
                                                      device="cpu")
        for r, i in enumerate(idxs):
            self_, mutual, ma, mi, ga = rows[i][2]
            assert (int(got["selfscore"][r]), int(got["mutual"][r]),
                    int(got["matches"][r]), int(got["mismatches"][r]),
                    int(got["gaps"][r])) == (self_, mutual, ma, mi, ga)
            if self_ > 0:
                nf = np.float32(ma + mi + ga) / np.float32(self_)
                assert got["distance"][r] == np.float32(self_ - 2 * mutual) * nf
                assert got["similarity"][r] == np.float32(2 * mutual) * nf
            checked += 1
    assert checked == len(rows)


def test_bucket_above_2048_matches_xla():
    """Protein mode has no long route: a 4096 bucket runs the entry too."""
    rng = np.random.default_rng(6)
    ac, bc, al, bl = _batch(rng, 2, (2049, 2300), (1900, 2300))
    want = batched_protein_align(ac, bc, al, bl)
    got = protein_cuda.batched_protein_align_cuda(ac, bc, al, bl,
                                                  device="cpu")
    _assert_same(got, want)


@pytest.mark.parametrize("backend", ["wavefront-cuda", "wavefront"])
def test_protein_aligner_matches_taxtk(backend):
    rng = np.random.default_rng(11)
    pairs = []
    for m, n in [(0, 30), (40, 0), (0, 0), (1, 1), (15, 17), (70, 60),
                 (120, 100), (33, 200), (250, 240)] + [(40, 44)] * 9:
        a = rng.integers(0, 27, m).astype(np.uint8)
        b = a[:n].copy() if n <= m else np.concatenate(
            [a, rng.integers(0, 27, n - m).astype(np.uint8)])
        b[rng.random(n) < 0.3] = rng.integers(0, 27, 1)[0]
        pairs.append((a, b))
    ref = JaxAligner("protein", protein_backend="wavefront-pallas",
                     pallas_interpret=True)
    want = ref.align_pairs(pairs)
    reset_shared_pools()
    port = BatchAligner("protein", protein_backend=backend, device="cpu")
    got = port.align_pairs(pairs)
    for w, g in zip(want, got):
        assert np.float32(g.distance).view(np.int32) == \
            np.float32(w.distance).view(np.int32)
        assert np.float32(g.similarity).view(np.int32) == \
            np.float32(w.similarity).view(np.int32)
    assert (port.pool_cache is not None) == (backend == "wavefront-cuda")
    assert port.cells_computed == ref.cells_computed


def test_protein_engine_gff3_and_log_match_taxtk(tmp_path):
    paths = make_workload_protein(str(tmp_path), 24, seed=3)
    ref = JaxAligner("protein", protein_backend="wavefront-pallas",
                     pallas_interpret=True)
    want = _run_engine("taxtk", paths, ref, protein=True)
    assert BatchAligner("protein", device="cpu").protein_backend == "wavefront"
    reset_shared_pools()
    port = BatchAligner("protein", protein_backend="wavefront-cuda",
                        device="cpu")
    got = _run_engine("taxtk_torch", paths, port, protein=True)
    assert got[0] == want[0]  # GFF3
    assert got[1] == want[1]  # decision log, alignment art included
    assert got[0].count("\n") > 20 and "+ALN" in got[1]


def _chain(taxator, binner, pr, extra, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(pr["alignments"]))
    rc = taxator.main(["-a", "rpa", "-b", "protein", "-g", pr["mapping"],
                       "-q", pr["qf"], "-f", pr["faa"],
                       "-i", pr["faa"] + ".fai"] + extra)
    gff = capsys.readouterr().out
    assert rc == 0
    body = sorted((ln for ln in gff.splitlines() if not ln.startswith("#")),
                  key=lambda ln: ln.split("\t")[0])
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(body) + "\n"))
    rc = binner.main(["-n", "s", "-g", "([^_]+)_.*", "-l", os.devnull])
    assert rc == 0
    return gff, capsys.readouterr().out


@pytest.mark.parametrize("backend", ["wavefront-cuda", "wavefront",
                                     "wavefront-pallas"])
def test_protein_cli_chain_matches_taxtk(protein_refpack, monkeypatch,  # noqa: F811
                                         capsys, backend):
    """taxtk gets the same --protein-backend where it has the name."""
    monkeypatch.setenv("TAXATORTK_TAXONOMY_NCBI", str(protein_refpack["dir"]))
    flag = [] if backend == "wavefront-cuda" else ["--protein-backend",
                                                   backend]
    want = _chain(jax_taxator, jax_binner, protein_refpack, flag, monkeypatch,
                  capsys)
    reset_shared_pools()
    got = _chain(torch_taxator, torch_binner, protein_refpack,
                 ["--device", "cpu", "--protein-backend", backend],
                 monkeypatch, capsys)
    assert got == want
    assert got[1].count("contig1\t") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["protein_wavefront", "protein_swar"])
def test_protein_kernel_matches_plain_on_card(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    ac, bc, al, bl = _batch(rng, 301, (0, 500), (0, 500))
    args = protein_cuda.protein_inputs(ac, bc, al, bl, torch.device("cuda"),
                                       DevicePoolCache("cuda"))
    fn = getattr(protein_cuda, kernel)
    n = fn.launches
    assert torch.equal(fn(*args), protein_cuda.protein_plain(*args))
    assert fn.launches == n + 1


@pytest.mark.parametrize("B,M,N,nw", [
    (3, 1, 1, None), (5, 1, 40, 4), (4, 128, 50, 4), (4, 129, 50, 4),
    (6, 512, 512, 16), (6, 513, 300, 16), (7, 300, 700, 8),
    (9, 2048, 64, None), (2, 96, 33, 1)])
def test_protein_kernel_geometry_covers_each_row_once(B, M, N, nw):
    """Row 4's launch as csrc/protein_wavefront.cu reads its geometry: one
    block per pair; bands of nw strips of 32 rows run in turn, band k's
    warps being the first min(nw, strips - k * nw), warp w taking rows
    32 * (k * nw + w) + 1 .. + 32.  Every row of every pair lies in
    exactly one warp's strip, in order, within `bands` bands; a is never
    transposed (rows are a's own length).  nw defaults to BAND_WARPS
    (TALL_BAND_WARPS above TALL_ROWS rows), or the most strips a pair can
    have if fewer."""
    rng = np.random.default_rng(B + M + N)
    al = rng.integers(0, M + 1, B)
    al[0] = M  # the tallest pair the bucket holds
    got_nw, bands = protein_cuda.kernel_geometry(B, M, N, nw)
    strips_max = -(-M // 32)
    default = (protein_cuda.TALL_BAND_WARPS if M > protein_cuda.TALL_ROWS
               else protein_cuda.BAND_WARPS)
    assert got_nw == (nw or min(default, strips_max))
    assert 1 <= got_nw <= protein_cuda.MAX_WARPS
    assert bands == -(-strips_max // got_nw)
    for m in map(int, al):
        strips = -(-m // 32)
        rows, band = [], 0
        for top in range(0, m, 32 * got_nw):  # the kernel's band loop
            assert band < bands
            for w in range(min(got_nw, strips - top // 32)):
                rows += [i for i in range(top + 32 * w + 1,
                                          top + 32 * w + 33) if i <= m]
            band += 1
        assert rows == list(range(1, m + 1))
    with pytest.raises(ValueError):
        protein_cuda.kernel_geometry(B, M, N, protein_cuda.MAX_WARPS + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [4, 16])
def test_protein_wavefront_band_edges_on_card(monkeypatch, nw):
    """Row 4 at band and strip edges against the plain version: every
    (m, n) in {1, 31, 32, 33, 32 nw, 32 nw + 1, 2048}^2 with nw forced
    (bands of nw warps; 2048 rows run several bands in turn), empty sides,
    X and * codes, and pairs whose stats change when a and b are swapped
    (the kernel must not transpose)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    real = protein_cuda.kernel_geometry
    monkeypatch.setattr(protein_cuda, "kernel_geometry",
                        lambda B, M, N, nw_=None: real(B, M, N, nw))
    edges = (1, 31, 32, 33, 32 * nw, 32 * nw + 1, 2048)
    lens = [(m, n) for m in edges for n in edges] + [(0, 5), (5, 0), (0, 0)]
    rng = np.random.default_rng(nw)
    B = len(lens)
    ac, bc, al, bl = _batch(rng, B, (2048, 2048), (2048, 2048))
    al[:] = [m for m, _ in lens]
    bl[:] = [n for _, n in lens]
    args = protein_cuda.protein_inputs(ac, bc, al, bl, torch.device("cuda"),
                                       DevicePoolCache("cuda"))
    plain = protein_cuda.protein_plain(*args)
    swapped = protein_cuda.protein_plain(args[0], args[2], args[1], args[4],
                                         args[3], args[6], args[5])
    assert bool((swapped[0] == plain[0]).all())  # the score is symmetric
    assert bool((swapped[1] != plain[1]).any())  # the stats are not
    n = protein_cuda.protein_wavefront.launches
    assert torch.equal(protein_cuda.protein_wavefront(*args), plain)
    assert protein_cuda.protein_wavefront.launches == n + 1


@pytest.mark.parametrize("B,M,N,nw", [
    (1, 1, 1, None), (1, 300, 200, 4), (2, 32, 33, None), (5, 128, 50, 4),
    (6, 129, 50, 4), (7, 512, 512, 16), (8, 513, 300, 16),
    (9, 1024, 1024, None), (3, 96, 33, 1)])
def test_protein_swar_geometry_covers_each_row_once(B, M, N, nw):
    """Row 5's launch as csrc/protein_swar.cu reads its geometry: one block
    per pair of pairs, pair p in the low halves and p + ceil(B/2) in the
    high halves, so every pair lies in exactly one half of one block (odd
    B leaves the last block without a high pair).  A block's m is the
    larger of its pairs' a lengths (0 for a pair with an empty side);
    bands of nw strips of 32 rows run in turn, band k's warps being the
    first min(nw, strips - k * nw), warp w taking rows
    32 * (k * nw + w) + 1 .. + 32 of both pairs.  Every row of both
    pairs lies in exactly one warp's strip, in order, within `bands`
    bands, and the row holding each pair's final cell in exactly one
    lane.  nw defaults to one warp per SWAR_ROWS rows of the bucket, at
    least 1, and TALL_BAND_WARPS above SWAR_TALL_ROWS rows."""
    rng = np.random.default_rng(B + M + N)
    al = rng.integers(0, M + 1, B)
    bl = rng.integers(0, N + 1, B)
    al[0], bl[0] = M, max(N, 1)  # the tallest pair the bucket holds
    got_nw, bands = protein_cuda.kernel_geometry(B, M, N, nw, swar=True)
    strips_max = -(-M // 32)
    default = min(protein_cuda.TALL_BAND_WARPS
                  if M > protein_cuda.SWAR_TALL_ROWS
                  else max(M // protein_cuda.SWAR_ROWS, 1), strips_max)
    assert got_nw == (nw or default)
    assert 1 <= got_nw <= protein_cuda.MAX_WARPS
    assert bands == -(-strips_max // got_nw)
    half = (B + 1) // 2
    seen = []
    for blk in range(half):  # the kernel's blocks
        pair = [blk] + ([blk + half] if blk + half < B else [])
        seen += pair
        own = [int(al[p]) if al[p] and bl[p] else 0 for p in pair]
        m = max(own)
        strips = -(-m // 32)
        rows, band, holders = [], 0, [0] * len(own)
        for top in range(0, m, 32 * got_nw):  # the kernel's band loop
            assert band < bands
            for w in range(min(got_nw, strips - top // 32)):
                row0 = top + 32 * w
                rows += list(range(row0 + 1, row0 + 33))
                for h, mh in enumerate(own):  # the harvest lane's test
                    holders[h] += 0 <= mh - row0 - 1 < 32
            band += 1
        for mh, held in zip(own, holders):
            assert [i for i in rows if i <= mh] == list(range(1, mh + 1))
            assert held == (mh > 0)
    assert sorted(seen) == list(range(B))
    for bad in (0, protein_cuda.MAX_WARPS + 1):
        with pytest.raises(ValueError):
            protein_cuda.kernel_geometry(B, M, N, bad, swar=True)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [4, 16])
def test_protein_swar_band_edges_on_card(monkeypatch, nw):
    """Row 5 at band and strip edges against the plain version, with nw
    forced: in a 1024 bucket (inside v6's domain), the low halves take
    every (m, n) in {1, 31, 32, 33, 32 nw, 32 nw + 1, 1024}^2 and the high
    halves the same list turned by 9, so the two pairs of a block differ
    and the shorter is harvested mid-sweep; an empty side in one half
    only; X and * codes; an odd B, whose last block has no high pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    real = protein_cuda.kernel_geometry
    monkeypatch.setattr(protein_cuda, "kernel_geometry",
                        lambda B, M, N, nw_=None, swar=False:
                        real(B, M, N, nw, swar))
    edges = (1, 31, 32, 33, 32 * nw, 32 * nw + 1, 1024)
    lens = [(m, n) for m in edges for n in edges]
    low = lens + [(0, 5), (40, 0), (1024, 1024)]
    high = lens[9:] + lens[:9] + [(33, 40), (5, 0)]
    assert len(low) == len(high) + 1
    rng = np.random.default_rng(nw)
    B = len(low) + len(high)
    ac, bc, al, bl = _batch(rng, B, (1024, 1024), (1024, 1024))
    al[:] = [m for m, _ in low + high]
    bl[:] = [n for _, n in low + high]
    M, N = ac.shape[1], bc.shape[1]
    assert protein_cuda._swar_fits(*protein_cuda._shapes(M, N)[:2])
    args = protein_cuda.protein_inputs(ac, bc, al, bl, torch.device("cuda"),
                                       DevicePoolCache("cuda"))
    n = protein_cuda.protein_swar.launches
    assert torch.equal(protein_cuda.protein_swar(*args),
                       protein_cuda.protein_plain(*args))
    assert protein_cuda.protein_swar.launches == n + 1


def test_engine_default_aligner_takes_the_engine_device():
    from taxtk_torch.engine.executor import RpaEngine

    engine = RpaEngine(None, None, None, protein=True, device="cpu")
    assert engine.aligner.mode == "protein"
    assert engine.aligner.device.type == "cpu"
    assert engine.aligner.protein_backend == "wavefront"

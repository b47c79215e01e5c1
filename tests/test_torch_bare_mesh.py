"""taxtk_torch's bare dp mesh against taxtk's, on the CPU.

A bare mesh is `BatchAligner("dna", dna_backend="myers", mesh=...)` with
no engine backend attached: the pairs spread over the mesh's dp rows
(`_dispatch_mesh`, as with an engine backend), where taxtk splits each
bucket into one slice a row (`_myers_sharded`).  The port's grid names the
CPU once per row ([cpu] * dp), taxtk's takes dp of its 8 virtual CPU
devices (conftest.py).  Every comparison is exact: distances and
similarities array-equal, GFF3 byte-identical.  Which rows ran is read
from the per-cell pools in `stats()`.  The `cuda` test runs the path on
one card named twice and skips without a card.
"""

import dataclasses
import io
import random

import numpy as np
import pytest
import torch

from fixture_tax import make_taxonomy, write_dump
from test_rpa import DictStore, _synthesize_case

from taxtk.engine.aligner import BatchAligner as JaxAligner
from taxtk.engine.executor import RpaEngine as JaxEngine
from taxtk.parallel.mesh import make_mesh as jax_make_mesh
from taxtk_torch.constants import DEFAULT_RANKS
from taxtk_torch.engine import aligner as torch_aligner_mod
from taxtk_torch.engine.aligner import BatchAligner
from taxtk_torch.engine.executor import RpaEngine
from taxtk_torch.formats.alignments import AlignmentRecord
from taxtk_torch.native import myers_batch
from taxtk_torch.parallel.mesh import Mesh
from taxtk_torch.taxonomy import parse_ncbi_flat_files
from taxtk_torch.utils.errors import TaxtkError

CPU = torch.device("cpu")
DPS = [1, 2, 8]


def _cpu_mesh(dp):
    return Mesh([[CPU]] * dp)


def _dna_pairs():
    """Pairs from a numpy seed: an empty pattern, an empty text, 23 pairs
    with shorter sides of 1 to 2,048 bp in two text-length buckets (B = 21
    and 2, padded to 32 and 8 rows), and two pairs over 2,048 bp, which
    take the port's long route (taxtk's XLA myers keeps them in the second
    bucket)."""
    rng = np.random.default_rng(15)

    def pair(la, lb):
        a = rng.integers(0, 4, la).astype(np.uint8)
        b = np.resize(a, lb) if la else rng.integers(0, 4, lb).astype(
            np.uint8)
        b = b.copy()
        hit = rng.random(lb) < 0.08
        b[hit] = rng.integers(0, 5, int(hit.sum()))
        return a, b

    lens = [(0, 37), (41, 0), (1, 40)]
    lens += [tuple(int(x) for x in rng.integers(33, 65, 2)) for _ in range(20)]
    lens += [(2048, 2100), (130, 2100), (2100, 2300), (2470, 2049)]
    return [pair(la, lb) for la, lb in lens]


PAIRS = _dna_pairs()
SHORT = PAIRS[:23]  # one bucket of 21 pairs


def _rows(aligner):
    """The grid rows whose cells ran pairs (each has a pool in stats())."""
    return sorted({int(k.split(",")[0])
                   for k in aligner.stats().get("cell_pools", {})})


def _values(results):
    return (np.array([r.distance for r in results], np.float32),
            np.array([r.similarity for r in results], np.float32))


# dp = 3 divides no bucket's pow2 row count, which taxtk pads
@pytest.mark.parametrize("dp,pairs", [(dp, PAIRS) for dp in DPS]
                         + [(3, SHORT)])
def test_align_pairs_match_taxtk_sharded(dp, pairs, monkeypatch):
    long_calls = []
    real = torch_aligner_mod.batched_edit_distance_systolic

    def systolic(a, *args, **kw):
        long_calls.append(len(a))
        return real(a, *args, **kw)

    monkeypatch.setattr(torch_aligner_mod, "batched_edit_distance_systolic",
                        systolic)
    port = BatchAligner("dna", dna_backend="myers", mesh=_cpu_mesh(dp),
                        device="cpu")
    got = _values(port.align_pairs(pairs))

    ref = JaxAligner("dna", dna_backend="myers", mesh=jax_make_mesh(dp, tp=1))
    ref_shards = []
    ref_sharded = ref._myers_sharded
    ref._myers_sharded = lambda *a: ref_shards.append(1) or ref_sharded(*a)
    want = _values(ref.align_pairs(pairs))

    assert ref_shards, "taxtk did not take its sharded path"
    assert _rows(port) == list(range(dp))
    # the pairs past 2,048 bp take the long route on their cells
    n_long = sum(min(len(a), len(b)) > 2048 for a, b in pairs)
    assert sum(long_calls) == n_long
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    want_dist = [max(len(a), len(b)) if not (len(a) and len(b))
                 else myers_batch([(a, b)])[0] for a, b in pairs]
    np.testing.assert_array_equal(got[0], np.float32(want_dist))


def _corpus(tax):
    """tests/test_mesh_aligner.py's corpus: _synthesize_case at seed 77."""
    rng = random.Random(77)
    recordsets, qseqs, refseqs = [], {}, {}
    for case in range(6):
        made = _synthesize_case(rng, tax)
        if made is None:
            continue
        refs, qs, records = made
        qid = f"q{case}"
        for r in records:
            r.query_identifier = qid
            r.reference_identifier = f"c{case}_" + r.reference_identifier
        refseqs.update({f"c{case}_" + k: v for k, v in refs.items()})
        qseqs[qid] = qs["q0"]
        recordsets.append(records)
    return recordsets, qseqs, refseqs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(taxtk taxonomy, port taxonomy, taxtk record sets, port record sets,
    query seqs, reference seqs): the port's records are copies of taxtk's,
    field for field (node indices agree: both taxonomies are parsed from
    one dump)."""
    d = tmp_path_factory.mktemp("tax")
    jtax = make_taxonomy(d, prune=True)
    nodes, names = write_dump(str(d))
    ttax = parse_ncbi_flat_files(nodes, names, "testver", DEFAULT_RANKS)
    ttax = ttax.prune_to_marked_ranks(DEFAULT_RANKS)
    jsets, qseqs, refseqs = _corpus(jtax)
    fields = [f.name for f in dataclasses.fields(AlignmentRecord)]
    tsets = [[AlignmentRecord(**{f: getattr(r, f) for f in fields})
              for r in rs] for rs in jsets]
    return jtax, ttax, jsets, tsets, qseqs, refseqs


def _run(engine_cls, tax, sets, qseqs, refseqs, **kw):
    engine = engine_cls(tax, DictStore(qseqs), DictStore(refseqs), **kw)
    out = io.StringIO()
    engine.run(iter([list(rs) for rs in sets]), out)
    return out.getvalue(), engine


@pytest.fixture(scope="module")
def single_gff3(corpus):
    _, ttax, _, tsets, qseqs, refseqs = corpus
    aligner = BatchAligner("dna", dna_backend="myers", device="cpu")
    return _run(RpaEngine, ttax, tsets, qseqs, refseqs, aligner=aligner)[0]


@pytest.mark.parametrize("dp", DPS)
def test_engine_gff3_matches_taxtk_sharded_and_single(corpus, single_gff3,
                                                      dp):
    jtax, ttax, jsets, tsets, qseqs, refseqs = corpus
    ref = JaxAligner("dna", dna_backend="myers", mesh=jax_make_mesh(dp, tp=1))
    want, _ = _run(JaxEngine, jtax, jsets, qseqs, refseqs, aligner=ref)
    port = BatchAligner("dna", dna_backend="myers", mesh=_cpu_mesh(dp),
                        device="cpu")
    got, _ = _run(RpaEngine, ttax, tsets, qseqs, refseqs, aligner=port)
    assert _rows(port) == list(range(dp))
    assert got == want
    assert got == single_gff3
    assert got.count("\n") > len(tsets)


def test_engine_mesh_backend_bypasses_bare_path(corpus, single_gff3):
    """With RpaEngine(mesh=...) the engine backend owns placement and the
    bare mesh is not read (taxtk aligner.py:637): an aligner with a bare
    mesh of 4 rows under an engine mesh of 2 runs on rows 0 and 1 only."""
    _, ttax, _, tsets, qseqs, refseqs = corpus
    aligner = BatchAligner("dna", dna_backend="myers", mesh=_cpu_mesh(4),
                           device="cpu")
    got, engine = _run(RpaEngine, ttax, tsets, qseqs, refseqs,
                       aligner=aligner, mesh=_cpu_mesh(2))
    assert aligner.mesh_backend is engine.mesh_backend is not None
    assert _rows(aligner) == [0, 1]
    assert got == single_gff3


def test_engine_builds_its_aligner_with_the_mesh(corpus):
    jtax, ttax, _, _, qseqs, refseqs = corpus
    m = _cpu_mesh(2)
    engine = RpaEngine(ttax, DictStore(qseqs), DictStore(refseqs), mesh=m,
                       device="cpu")
    assert engine.aligner.mesh is m
    assert engine.aligner.mesh_backend is engine.mesh_backend
    jm = jax_make_mesh(2, tp=1)
    jengine = JaxEngine(jtax, DictStore(qseqs), DictStore(refseqs), mesh=jm)
    assert jengine.aligner.mesh is jm


def test_protein_aligner_ignores_the_mesh():
    rng = np.random.default_rng(4)
    pairs = [(rng.integers(0, 24, int(la)).astype(np.uint8),
              rng.integers(0, 24, int(lb)).astype(np.uint8))
             for la, lb in rng.integers(0, 90, (21, 2))]
    with_mesh = BatchAligner("protein", mesh=_cpu_mesh(2), device="cpu")
    plain = BatchAligner("protein", device="cpu")
    got = _values(with_mesh.align_pairs(pairs))
    want = _values(plain.align_pairs(pairs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert with_mesh._grid() is None


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    """A mesh that names a card on a host without one is an error, never
    a quiet run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    aligner = BatchAligner("dna", dna_backend="myers", device="cpu",
                           mesh=Mesh([[torch.device("cuda", 0)]] * 2))
    with pytest.raises(TaxtkError):
        aligner.align_pairs(PAIRS[:4])
    assert _rows(aligner) == []


@pytest.mark.cuda
def test_sharded_path_on_card_matches_host_myers():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the sharded path runs on a card)")
    card = torch.device("cuda", 0)
    aligner = BatchAligner("dna", dna_backend="myers", device="cuda",
                           mesh=Mesh([[card]] * 2))
    got = _values(aligner.align_pairs(PAIRS))
    want = [max(len(a), len(b)) if not (len(a) and len(b))
            else myers_batch([(a, b)])[0] for a, b in PAIRS]
    np.testing.assert_array_equal(got[0], np.float32(want))
    assert _rows(aligner) == [0, 1]

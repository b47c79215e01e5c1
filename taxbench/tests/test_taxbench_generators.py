"""The generators: deterministic by seed, the same length strata on every
seed, and write_dump byte-equal to the fixture it copies."""

import filecmp
import importlib.util
import os

import numpy as np
import pytest

from taxbench.run import ROOT
from taxbench import workload


def _make(tmp_path, name, seed, **params):
    mix = {"generator": name, "params": params}
    return workload.make(mix, str(tmp_path / f"{name}-{seed}"), seed)


def _bytes(files):
    out = {}
    for key in ("refdata", "mapping", "alignments", "query"):
        with open(files[key], "rb") as f:
            out[key] = f.read()
    return out


@pytest.mark.parametrize("name, params", [
    ("dna_sample", dict(contigs=6, min_len=1000, max_len=3000)),
    ("protein_sample", dict(orfs=30, min_len=60, max_len=200)),
])
def test_generators_deterministic_by_seed(tmp_path, name, params):
    seed = 2**31 + 77  # the driver's seeds pass 32 signed bits
    a = _make(tmp_path / "a", name, seed, **params)
    b = _make(tmp_path / "b", name, seed, **params)
    c = _make(tmp_path / "c", name, seed + 1, **params)
    assert _bytes(a) == _bytes(b)
    assert a["query_size"] == b["query_size"]
    assert _bytes(a)["query"] != _bytes(c)["query"]


def test_length_strata_equal_across_seeds():
    n, lo, hi = 512, 1000, 98304
    for seed in (1, 2**31 + 5, 4_000_000_007):
        rng = np.random.RandomState(seed % (1 << 32))
        lengths, parts = workload.stratified_lengths(rng, n, lo, hi)
        # the k-th shortest lies in the k-th stratum (whole bases)
        edges = lo + (hi + 1 - lo) * np.arange(n + 1) / n
        got = np.sort(lengths)
        assert (got >= np.floor(edges[:-1])).all()
        assert (got < edges[1:]).all()
        assert (parts == 0).all()


def test_parts_and_segments_equal_across_seeds():
    """Every seed puts 9 of 512 lengths above the cut, and gives each part
    1, 2 and 3 segments in equal shares."""
    for seed in (3, 2**31 + 9, 4_000_000_011):
        rng = np.random.RandomState(seed % (1 << 32))
        lengths, parts = workload.stratified_lengths(rng, 512, 1000, 100000,
                                                     (98305,))
        assert ((lengths >= 98305) == (parts == 1)).all()
        assert (parts == 1).sum() == 9 and lengths.max() <= 100000
        segs = workload.balanced_counts(rng, parts, 3)
        for k, size in ((0, 503), (1, 9)):
            counts = np.bincount(segs[parts == k], minlength=4)[1:]
            assert counts.sum() == size and counts.max() - counts.min() <= 1


def test_dna_sample_lengths_from_strata(tmp_path):
    files = _make(tmp_path, "dna_sample", 9, contigs=8, min_len=1000,
                  max_len=9000)
    with open(files["query"]) as f:
        lengths = [len(ln.strip()) for ln in f if not ln.startswith(">")]
    edges = 1000 + 1000 * np.arange(9)
    got = np.sort(lengths)
    assert (got >= edges[:-1]).all() and (got <= edges[1:]).all()
    assert files["query_size"] == sum(lengths)


def test_write_dump_is_the_fixtures(tmp_path):
    path = os.path.join(ROOT, "tests", "fixture_tax.py")
    spec = importlib.util.spec_from_file_location("fixture_tax_orig", path)
    orig = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(orig)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    for x, y in zip(orig.write_dump(str(tmp_path / "a")),
                    workload.write_dump(str(tmp_path / "b"))):
        assert filecmp.cmp(x, y, shallow=False)

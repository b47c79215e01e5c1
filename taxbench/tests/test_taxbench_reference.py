"""The plain reference against brute force, and against the port at a
tiny sample on the CPU: the same realigned values, GFF3 lines and bins."""

import numpy as np
import pytest

from tiny_mixes import PROTEIN_200, TINY
from taxbench import ref_align, run


def _levenshtein(a, b):
    prev = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = np.empty(len(b) + 1, np.int64)
        cur[0] = i
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[-1]


def _nw(a, b):
    """score, matches and diagonal steps, preferring diagonal, then a step
    along b, then a step along a"""
    S = ref_align.BLOSUM62
    H = np.zeros((len(a) + 1, len(b) + 1), np.int64)
    M = np.zeros_like(H)
    G = np.zeros_like(H)
    H[:, 0] = -np.arange(len(a) + 1)
    H[0, :] = -np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            d = H[i - 1, j - 1] + S[a[i - 1], b[j - 1]]
            h, v = H[i, j - 1] - 1, H[i - 1, j] - 1
            H[i, j] = best = max(d, h, v)
            if d == best:
                M[i, j] = M[i - 1, j - 1] + (a[i - 1] == b[j - 1])
                G[i, j] = G[i - 1, j - 1] + 1
            elif h == best:
                M[i, j], G[i, j] = M[i, j - 1], G[i, j - 1]
            else:
                M[i, j], G[i, j] = M[i - 1, j], G[i - 1, j]
    return H[-1, -1], M[-1, -1], G[-1, -1]


def test_edit_distances_brute_force():
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(30):
        a = rng.integers(0, 4, int(rng.integers(0, 100)))
        b = np.concatenate([a, rng.integers(0, 4, 40)])[: int(rng.integers(0, 140))]
        b = b.copy()
        mut = rng.random(len(b)) < 0.2
        b[mut] = rng.integers(0, 4, mut.sum())
        pairs.append((a, b))
    got = ref_align.edit_distances(pairs, "cpu")
    assert list(got) == [_levenshtein(a, b) for a, b in pairs]


def test_protein_stats_brute_force():
    rng = np.random.default_rng(4)
    pairs = [(rng.integers(0, 20, int(rng.integers(1, 40))),
              rng.integers(0, 20, int(rng.integers(1, 40))))
             for _ in range(20)]
    got = ref_align.protein_stats(pairs, "cpu")
    for k, (a, b) in enumerate(pairs):
        assert tuple(got[:, k]) == _nw(a, b)


@pytest.mark.parametrize("cell", list(TINY))
def test_port_matches_reference_on_cpu(cell):
    res = run.run_cell(cell, 2**31 + 3, 0.1, 0, device="cpu",
                       traffic=TINY[cell])
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"], checks
    assert checks["pairs_compared"] > 0 and checks["samples_checked"] >= 1
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["metrics"]["setup_s"]["value"] > 0


def test_protein_reference_depends_on_order(tmp_path):
    """taxator-tk realigns a protein pair in the order RPA asks for it, and
    the alignment's statistics depend on that order: at the seeded
    200-ORF sample, the reference's float32 distance or similarity of some
    pair (a, b) differs from its swap (b, a), so no engine may serve one
    order from the other's value."""
    from taxbench import workload
    from taxbench.reference import Reference

    files = workload.make(PROTEIN_200, str(tmp_path / "data"), 2**31 + 11)
    contigs = run.sample_contigs(files["alignments"], PROTEIN_200,
                                 2**31 + 11)
    pairs = Reference(files, True).check(contigs)["pairs"]

    def bits(v):
        return np.float32(v[0]).tobytes() + np.float32(v[1]).tobytes()

    swapped = [(k, k[:3] + (k[4], k[3])) for k in pairs if k[4] is not None]
    assert swapped and all(s in pairs for _, s in swapped)
    assert any(bits(pairs[k]) != bits(pairs[s]) for k, s in swapped)


def test_capture_binds_the_round_by_name(monkeypatch):
    """Capture and the witness read a round's tasks, pair caches and
    requests by name through the real method's signature: a round with
    its parameters reordered and one more added still passes every
    argument through and is captured."""
    from taxtk_torch.engine.executor import RpaEngine
    from taxbench import witness

    seen = []

    def align_round(self, extra, reqs_per_task, pair_caches, tasks, caches,
                    flag=False):
        seen.append((extra, flag, type(pair_caches[0]).__name__))
        pair_caches[0][("s", 0, 1)] = 7
        pair_caches[0].setdefault(("s", 1, 0), 7)
        yield "finish"

    monkeypatch.setattr(RpaEngine, "_align_round", align_round)
    task = type("Task", (), {"qid": "c1"})()
    caches = [{}]
    capture = run.Capture(["c1"])
    with capture.active(), witness.no_mirror():
        gen = RpaEngine._align_round(None, "x", [[("s", 0, 1)]], caches,
                                     [task], ["seg"], flag=True)
        assert list(gen) == ["finish"]
    assert seen == [("x", True, "Unmirrored")]
    [(got_task, cache, keys)] = capture.take()
    assert got_task is task and keys == {("s", 0, 1)}
    assert cache == {("s", 0, 1): 7}

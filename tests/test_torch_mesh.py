"""taxtk_torch's dp x tp mesh against taxtk's, on the CPU.

The port drives a grid of torch devices from one process; here the grid
names the CPU once per cell ([cpu] * 8, the counterpart of taxtk's 8
virtual CPU devices from conftest.py).  Every comparison is exact: the
grid shape and routing equal taxtk's, `pass0_merge` and `dryrun_step`
are array-equal to taxtk's, and the mesh engine's GFF3 (and -l log) is
byte-identical to taxtk's mesh run and to the port's single-device run.
The `cuda` tests need two cards and skip otherwise.
"""

import contextlib
import importlib
import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))

from bench_e2e import make_workload, make_workload_protein  # noqa: E402
from fixture_tax import make_taxonomy  # noqa: E402
from test_parallel import _expected  # noqa: E402

from taxtk.cli import taxator as jax_cli  # noqa: E402
from taxtk.engine.aligner import BatchAligner as JaxAligner  # noqa: E402
from taxtk.parallel import engine_mesh as jax_engine_mesh  # noqa: E402
from taxtk.parallel import mesh as jax_mesh  # noqa: E402
from taxtk_torch.cli import taxator as torch_cli  # noqa: E402
from taxtk_torch.engine import aligner as torch_aligner_mod  # noqa: E402
from taxtk_torch.engine.aligner import BatchAligner  # noqa: E402
from taxtk_torch.ops import seqpool  # noqa: E402
from taxtk_torch.parallel import engine_mesh, mesh  # noqa: E402

RANKS = ["superkingdom", "phylum", "class", "order", "family", "genus",
         "species"]
CPU = torch.device("cpu")


def _cpu_mesh(n, tp):
    return mesh.make_mesh(n, tp=tp, devices=[CPU] * n)


@pytest.fixture(scope="module")
def tax(tmp_path_factory):
    return make_taxonomy(tmp_path_factory.mktemp("tax"), prune=True)


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    return make_workload(str(tmp_path_factory.mktemp("dna")), 3, seed=3,
                         min_len=300, max_len=500)


@pytest.fixture(scope="module")
def protein(tmp_path_factory):
    return make_workload_protein(str(tmp_path_factory.mktemp("protein")), 10,
                                 min_len=40, max_len=120)


def _engine(pkg, paths, aligner, mesh=None, protein=False, logsink=None):
    """Parse, group and build package `pkg`'s RPA engine on a workload;
    returns (engine, record sets)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    aln_path, query_fa, ref_fa, map_path, tax_dir, _ = paths
    os.environ["TAXATORTK_TAXONOMY_NCBI"] = tax_dir
    tax = mod("taxonomy.flat").load_taxonomy_from_environment(RANKS)
    tax = tax.prune_to_marked_ranks(RANKS)
    seqid2taxid = mod("formats.mapping").load_seqid_taxid_mapping(map_path)
    recs = []
    with open(aln_path) as f:
        for _, rec in mod("formats.alignments").iter_alignment_records(f):
            rec.reference_node = tax.node(seqid2taxid[rec.reference_identifier])
            recs.append(rec)
    store = mod("refpack.store")
    engine = mod("engine.executor").RpaEngine(
        tax, store.IndexedFastaStore(query_fa), store.IndexedFastaStore(ref_fa),
        aligner=aligner, logsink=logsink, protein=protein, mesh=mesh,
    )
    rsets = list(mod("engine.recordsets").iter_record_sets(iter(recs), True,
                                                           False))
    return engine, rsets


def _run(pkg, paths, aligner, mesh=None, protein=False, logged=False):
    """GFF3 (and the -l log when logged) of one engine run."""
    log = io.StringIO() if logged else None
    engine, rsets = _engine(pkg, paths, aligner, mesh, protein, log)
    out = io.StringIO()
    engine.run(iter(rsets), out)
    return (out.getvalue(), log.getvalue()) if logged else out.getvalue()


# ---------------------------------------------------------------- the grid
def test_make_mesh_shapes_and_default_tp():
    assert _cpu_mesh(8, 2).shape == {"dp": 4, "tp": 2}
    for n in (1, 2, 4, 8):
        got = mesh.make_mesh(n, devices=[CPU] * n).shape
        assert got == dict(jax_mesh.make_mesh(n).shape), n
    grid = _cpu_mesh(8, 2).devices
    assert len(grid) == 4 and all(row == [CPU, CPU] for row in grid)
    with pytest.raises(ValueError):
        mesh.make_mesh(6, tp=4, devices=[CPU] * 6)


@pytest.mark.parametrize("n,tp", [(8, 2), (8, 1), (4, 2), (2, 1)])
def test_dryrun_matches_taxtk_and_serial(tax, n, tp):
    got = mesh.dryrun_step(_cpu_mesh(n, tp), tax.path)
    want = jax_mesh.dryrun_step(jax_mesh.make_mesh(n, tp=tp), tax.path)
    for k in want[3]:
        np.testing.assert_array_equal(got[3][k], want[3][k])
    serial = _expected(got[3], tax)
    for g, w, s in zip(got[:3], want[:3], serial):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, s)


# --------------------------------------------------------- pass-0 merge
def _merge_rows(tax, tp, seed):
    """Candidate rows for 9 tasks: ties in dist, sim and score (the slot
    breaks them), a task whose rows all sit on shard 0, and, at tp >= 2,
    shard tp - 1 with no rows at all."""
    rng = np.random.default_rng(seed)
    n_nodes = tax.path.shape[0]
    per_shard = [[] for _ in range(tp)]
    for seg in range(9):
        n = int(rng.integers(1, 12))
        for i in range(n):
            dist = np.float32(rng.integers(0, 3))  # ties
            sim = np.float32(rng.choice([10.0, 10.5, 11.0]))
            score = np.float32(rng.choice([40.0, 41.5]))
            row = (seg, dist, sim, score, i, int(rng.integers(0, n_nodes)))
            if seg == 4:
                shard = 0  # every row of this task on one shard
            else:
                shard = int(rng.integers(0, max(1, tp - 1)))
            per_shard[shard].append(row)
    return per_shard


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_pass0_merge_matches_taxtk(tax, dp, tp):
    per_shard = _merge_rows(tax, tp, seed=10 * dp + tp)
    got = engine_mesh.MeshEngineBackend(_cpu_mesh(dp * tp, tp),
                                        tax.path).pass0_merge(per_shard, 9)
    # taxtk's grid holds at most its 8 virtual devices; the merge does
    # not depend on dp, so 4 x 4 is held against taxtk's 2 x 4
    jdp = dp if dp * tp <= 8 else 8 // tp
    want = jax_engine_mesh.MeshEngineBackend(
        jax_mesh.make_mesh(jdp * tp, tp=tp), tax.path).pass0_merge(per_shard,
                                                                   9)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_pass0_merge_matches_host_reduction(dna):
    """The merge equals the host loop's reductions on every live task (the
    engine reads the merged values; taxtk's
    test_pass0_merge_matches_host_reduction)."""
    from taxtk_torch.engine.executor import SegmentCache, drive_sync
    from taxtk_torch.models.rpa import RpaTask

    eng, rsets = _engine("taxtk_torch", dna,
                         BatchAligner("dna", dna_backend="myers",
                                      device="cpu"),
                         mesh=_cpu_mesh(8, 2))
    tax = eng.tax
    tasks = [RpaTask(tax, rs) for rs in rsets]
    caches = [SegmentCache(t, eng.query_store, eng.db_store, False)
              for t in tasks]
    pair_caches = [dict() for _ in tasks]
    reqs = [t.prepare() for t in tasks]
    drive_sync(eng._align_round(tasks, caches, pair_caches, reqs))
    merged = eng._pass0_collective_merge(tasks, pair_caches)
    assert merged
    for ti, t in enumerate(tasks):
        if t.result is not None:
            continue
        dists, sims = t.pass0_table(pair_caches[ti])
        best = 0
        for i in range(t.n):
            key = (dists[i], -sims[i], -float(t.records[i].score))
            bkey = (dists[best], -sims[best], -float(t.records[best].score))
            if key < bkey:
                best = i
        m = merged[ti]
        assert int(m["best_slot"]) == best
        assert np.float32(m["best_dist"]) == dists[best]
        co = [t.records[i].reference_node for i in range(t.n)
              if dists[i] == dists[best] and sims[i] == sims[best]
              and t.records[i].score == t.records[best].score]
        assert int(m["rtax"]) == tax.lca_reduce(co)
        assert int(m["lca_allnodes"]) == tax.lca_reduce(
            [r.reference_node for r in t.records])
        assert int(m["support"]) == max(int(s) for s in sims)


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("kind,tp", [("dna", 2), ("dna", 4), ("protein", 2),
                                     ("protein", 4)])
def test_mesh_engine_matches_taxtk_and_single_device(dna, protein, kind,
                                                     tp):
    """The port's mesh (the plain versions on [cpu] * 8) against taxtk's
    mesh run, whose DNA aligner is its host C++ Myers (distances are exact
    on every backend; XLA's Myers would compile for each of the eight
    devices)."""
    paths = dna if kind == "dna" else protein
    is_protein = kind == "protein"
    mode = "protein" if is_protein else "dna"
    backend = {} if is_protein else {"dna_backend": "myers"}
    jm = jax_mesh.make_mesh(8, tp=tp)
    jax_backend = {} if is_protein else {"dna_backend": "native"}
    want = _run("taxtk", paths, JaxAligner(mode, mesh=jm, **jax_backend), jm,
                protein=is_protein)
    seqpool.reset_shared_pools()
    port = BatchAligner(mode, device="cpu", **backend)
    got = _run("taxtk_torch", paths, port, _cpu_mesh(8, tp),
               protein=is_protein)
    single = _run("taxtk_torch", paths, BatchAligner(mode, device="cpu",
                                                     **backend),
                  protein=is_protein)
    assert got == want == single
    assert got.count("\n") > 3
    # the pairs ran on more than one cell of the grid
    calls = port.stats()
    assert port.pairs_aligned > 0
    if not is_protein:
        assert len(calls["cell_pools"]) > 1


def test_mesh_oversized_route(tmp_path, monkeypatch):
    """The oversized-round route (systolic_max_pairs = 0: every long chunk
    through the pattern-block-chunked entry) on each cell of a 4 x 2 grid,
    on a contig whose pairs pass 2048 bp: the GFF3 equals taxtk's mesh run
    (host C++ aligner; tests/test_torch_chunked.py holds the port's
    single-device route against taxtk's)."""
    paths = make_workload(str(tmp_path), 1, seed=1, min_len=2100,
                          max_len=2400)
    calls = []
    real = torch_aligner_mod.batched_edit_distance_long

    def counted(a_codes, b_codes, a_len, b_len, **kw):
        calls.append(min(map(min, zip(a_len, b_len))))  # shortest pattern
        return real(a_codes, b_codes, a_len, b_len, **kw)

    monkeypatch.setattr(torch_aligner_mod, "batched_edit_distance_long",
                        counted)
    seqpool.reset_shared_pools()
    al = BatchAligner("dna", dna_backend="myers", device="cpu")
    al.systolic_max_pairs = 0
    got = _run("taxtk_torch", paths, al, _cpu_mesh(8, 2))
    jm = jax_mesh.make_mesh(8, tp=2)
    want = _run("taxtk", paths, JaxAligner("dna", dna_backend="native",
                                           mesh=jm), jm)
    assert got == want and got.count("\n") > 1
    assert len(calls) > 1 and min(calls) > 2048


def test_mesh_cell_pools_are_stable_and_hit(dna):
    """Each cell of a grid that names one device eight times keeps its own
    pool; dp rows come from a stable content hash, so two cold runs give
    the same per-cell traffic, and pass-1/2 re-alignments hit the pool of
    the cell that shipped their rows (taxtk's
    test_mesh_dp_rows_are_stable_and_pool_local)."""
    def run_and_stats():
        seqpool.reset_shared_pools()
        al = BatchAligner("dna", dna_backend="myers", device="cpu")
        out = _run("taxtk_torch", dna, al, _cpu_mesh(8, 2))
        caches = al._pool_caches
        assert len({id(c) for c in caches.values()}) == len(caches)
        return out, {k: (c.hits, c.misses) for k, c in caches.items()}

    out1, stats1 = run_and_stats()
    out2, stats2 = run_and_stats()
    assert out1 == out2
    assert stats1 == stats2
    assert len(stats1) > 1
    assert sum(h for h, _ in stats1.values()) > 0


def test_one_by_one_mesh_shares_the_single_device_pool():
    """A 1 x 1 grid's cell uses the device's process-wide pool, the one
    the single-device aligner holds (taxtk keys its pools by device)."""
    seqpool.reset_shared_pools()
    al = BatchAligner("dna", dna_backend="myers", device="cpu")
    al.mesh_backend = engine_mesh.MeshEngineBackend(_cpu_mesh(1, 1),
                                                    np.zeros((1, 1), np.int32))
    assert al._device_pool(0, 0) is al.pool_cache
    al.mesh_backend = engine_mesh.MeshEngineBackend(_cpu_mesh(2, 1),
                                                    np.zeros((1, 1), np.int32))
    al._pool_caches.clear()
    assert al._device_pool(0, 0) is not al._device_pool(1, 0)
    assert al.pool_cache not in (al._device_pool(0, 0), al._device_pool(1, 0))


def _routing_pairs(seed):
    rng = np.random.default_rng(seed)
    lens = ([(int(m), int(n)) for m, n in rng.integers(20, 900, (60, 2))]
            + [(2200, 2500), (3000, 2100), (2400, 2300)] + [(0, 40)])
    pairs = [(rng.integers(0, 4, m).astype(np.uint8),
              rng.integers(0, 4, n).astype(np.uint8)) for m, n in lens]
    # a hot text: many pairs share one segment, so a dp row overflows
    hot = rng.integers(0, 4, 700).astype(np.uint8)
    pairs += [(rng.integers(0, 4, 500).astype(np.uint8), hot)
              for _ in range(30)]
    return pairs


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (8, 1)])
def test_grid_routing_matches_taxtk(monkeypatch, dp, tp):
    """The same pairs and shard ids put every pair on the same grid cell,
    in the same list and order, as taxtk's _dispatch_mesh (short pairs and
    long pairs apart)."""
    pairs = _routing_pairs(dp * 10 + tp)
    shard_ids = [int(s) for s in
                 np.random.default_rng(tp).integers(0, tp, len(pairs))]
    jm = jax_mesh.make_mesh(dp * tp, tp=tp)
    jgrid = {d: (r, c) for r, row in enumerate(jm.devices)
             for c, d in enumerate(row)}
    jal = JaxAligner("dna", dna_backend="myers-pallas", mesh=jm)
    jal.mesh_backend = jax_engine_mesh.MeshEngineBackend(jm, np.zeros((1, 1)))
    want = {}

    def jax_set(pairs, work, tpu_long, results, finishers, pool_cache):
        dev = next(d for d, c in jal._pool_caches.items() if c is pool_cache)
        want[jgrid[dev]] = (list(work), list(tpu_long))

    monkeypatch.setattr(jal, "_dispatch_set", jax_set)
    jal.align_pairs(pairs, shard_ids=shard_ids)

    seqpool.reset_shared_pools()
    tal = BatchAligner("dna", dna_backend="myers", device="cpu")
    tal.mesh_backend = engine_mesh.MeshEngineBackend(_cpu_mesh(dp * tp, tp),
                                                     np.zeros((1, 1)))
    got = {}

    def torch_set(pairs, work, dev_long, results, finishers, device,
                  pool_cache):
        cell = next(k for k, c in tal._pool_caches.items()
                    if c is pool_cache)
        assert device == CPU
        got[cell] = (list(work), list(dev_long))

    monkeypatch.setattr(tal, "_dispatch_set", torch_set)
    tal.align_pairs(pairs, shard_ids=shard_ids)
    assert got == want
    assert any(lst for _, lst in got.values())  # long pairs routed too
    assert len(got) > 1


def _balance_cases():
    rng = np.random.default_rng(5)
    cases = []
    for _ in range(20):
        dp, tp = int(rng.choice([2, 3, 4, 8])), int(rng.choice([1, 2, 4]))
        per = {}
        k = 0
        for _ in range(int(rng.integers(1, 3 * dp * tp))):
            r, c = int(rng.integers(0, dp)), int(rng.integers(0, tp))
            n0, n1 = int(rng.integers(0, 40)), int(rng.integers(0, 6))
            v = per.setdefault((r, c), ([], []))
            v[0].extend(range(k, k + n0))
            v[1].extend(range(k + n0, k + n0 + n1))
            k += n0 + n1
        cases.append((per, dp, tp))
    # taxtk's two hand cases (tests/test_engine_mesh.py)
    cases.append(({(1, 0): (list(range(40)), []), (0, 1): ([100, 101], []),
                   (2, 1): ([102], [])}, 4, 2))
    cases.append(({(0, 0): (list(range(40)), [])}, 2, 1))
    return cases


@pytest.mark.parametrize("case", range(len(_balance_cases())))
def test_balance_dp_rows_matches_taxtk(case):
    per, dp, tp = _balance_cases()[case]

    def copy():
        return {k: (list(a), list(b)) for k, (a, b) in per.items()}

    got, want = copy(), copy()
    BatchAligner._balance_dp_rows(got, dp, tp)
    JaxAligner._balance_dp_rows(want, dp, tp)
    assert got == want


def test_logged_mesh_run_and_poisoned_merge(dna, monkeypatch):
    """A logged (-l) mesh run recomputes the pass-0 reductions on the host
    and checks the merge against them: it writes the unlogged run's GFF3
    and taxtk's log, and a poisoned merge raises."""
    jm = jax_mesh.make_mesh(8, tp=2)
    want = _run("taxtk", dna, JaxAligner("dna", dna_backend="native",
                                         mesh=jm), jm, logged=True)

    def port(grid):
        return _run("taxtk_torch", dna,
                    BatchAligner("dna", dna_backend="myers", device="cpu"),
                    grid, logged=True)

    got = port(_cpu_mesh(8, 2))
    assert got == want
    assert "PASS\t0" in got[1]
    assert got[0] == _run("taxtk_torch", dna,
                          BatchAligner("dna", dna_backend="myers",
                                       device="cpu"), _cpu_mesh(8, 2))
    real = engine_mesh.MeshEngineBackend.pass0_merge

    def poisoned(self, per_shard_rows, T):
        out = real(self, per_shard_rows, T)
        out["rtax"] = out["rtax"] * 0 + 12345
        return out

    monkeypatch.setattr(engine_mesh.MeshEngineBackend, "pass0_merge",
                        poisoned)
    with pytest.raises(RuntimeError, match="collective pass-0 merge diverged"):
        port(_cpu_mesh(8, 2))


# ------------------------------------------------------------------ CLI
def _cli(main, argv, aln_path, monkeypatch):
    """(rc, stdout, stderr) of a taxator main() in this process."""
    out, err = io.StringIO(), io.StringIO()
    with open(aln_path) as stdin:
        monkeypatch.setattr(sys, "stdin", stdin)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _argv(paths):
    aln, qfa, rfa, mapping, tax_dir, _ = paths
    os.environ["TAXATORTK_TAXONOMY_NCBI"] = tax_dir
    return ["-g", mapping, "-q", qfa, "-f", rfa, "-i", rfa + ".fai"]


@pytest.mark.parametrize("spec", ["1x1", "2x2", "4x2"])
def test_cli_mesh_matches_taxtk(dna, monkeypatch, spec):
    """The port's default CPU backend (the plain Myers versions) on each
    cell; taxtk with its host C++ aligner (see above)."""
    argv = _argv(dna) + ["--mesh", spec]
    want = _cli(jax_cli.main, argv + ["--dna-backend", "native"], dna[0],
                monkeypatch)
    got = _cli(torch_cli.main, argv + ["--device", "cpu"], dna[0],
               monkeypatch)
    assert got[:2] == want[:2]
    assert want[0] == 0 and want[1].count("\n") > 3


@pytest.mark.parametrize("spec", ["4by2", "x2", "2x"])
def test_cli_bad_mesh_spec_matches_taxtk(dna, monkeypatch, spec):
    argv = _argv(dna) + ["--mesh", spec]
    want = _cli(jax_cli.main, argv, dna[0], monkeypatch)
    got = _cli(torch_cli.main, argv + ["--device", "cpu"], dna[0],
               monkeypatch)
    assert got == want
    assert want[0] == 1 and "bad --mesh spec" in want[2]


def test_cli_mesh_on_missing_cards_stops(dna, monkeypatch):
    """--mesh with the default --device cuda takes cards only: with fewer
    than it needs (none here) it stops, and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc, out, err = _cli(torch_cli.main, _argv(dna) + ["--mesh", "2x2"],
                        dna[0], monkeypatch)
    assert rc == 1
    assert "--mesh 2x2 needs 4 devices; 0 available" in err
    assert out == ""


# ------------------------------------------------ repairs of earlier slices
def test_shared_pool_cache_keys_unindexed_cuda_by_current_card(monkeypatch):
    """"cuda" and "cuda:N" for the current card N name one pool; another
    key on the same device names another."""
    seqpool.reset_shared_pools()
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    a = seqpool.shared_pool_cache("cuda")
    assert a is seqpool.shared_pool_cache(torch.device("cuda", 1))
    assert a is not seqpool.shared_pool_cache("cuda:0")
    assert a.device == torch.device("cuda", 1)
    assert a is not seqpool.shared_pool_cache("cuda:1", key=(0, 1))
    assert seqpool.shared_pool_cache("cpu") is seqpool.shared_pool_cache(CPU)
    seqpool.reset_shared_pools()


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")


@pytest.mark.cuda
def test_dev_pending_copies_from_a_card_that_is_not_current():
    """A result on card 1 read back while card 0 is current: the event
    must follow the copy on card 1's stream (queued behind a spin)."""
    _two_cards()
    with torch.cuda.device(1):
        torch.cuda._sleep(200_000_000)
        dev = torch.arange(1 << 20, dtype=torch.int32, device="cuda:1")
    assert torch.cuda.current_device() == 0
    got = []
    pending = torch_aligner_mod._DevPending(dev, np.asarray, got.append)
    pending.wait()
    pending.run()
    np.testing.assert_array_equal(got[0], np.arange(1 << 20, dtype=np.int32))


@pytest.mark.cuda
def test_swar_at_nw8_on_a_second_card(monkeypatch):
    """Row 5 at nw = 8 (past 48 KB of shared memory, which needs the
    kernel attribute on each card) on card 0 and then on card 1, against
    the plain version."""
    _two_cards()
    from test_torch_protein import _batch
    from taxtk_torch.ops import protein_cuda

    real = protein_cuda.kernel_geometry
    monkeypatch.setattr(protein_cuda, "kernel_geometry",
                        lambda B, M, N, nw_=None, swar=False:
                        real(B, M, N, 8, swar))
    rng = np.random.default_rng(8)
    ac, bc, al, bl = _batch(rng, 64, (200, 1024), (200, 1024))
    for card in (0, 1):
        dev = torch.device("cuda", card)
        args = protein_cuda.protein_inputs(ac, bc, al, bl, dev,
                                           seqpool.DevicePoolCache(dev))
        assert torch.equal(protein_cuda.protein_swar(*args),
                           protein_cuda.protein_plain(*args))

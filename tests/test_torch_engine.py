"""taxtk_torch engine and CLI against taxtk, end to end on the CPU.

The port's RPA engine (device="cpu", backend "myers": the plain versions
of both CUDA kernels) must write the same GFF3 and decision log bytes as
taxtk's engine on its production route (myers-pallas, Pallas kernels in
interpret mode), with the routing threshold lowered on both aligners so
the short and the systolic kernel routes both run.  The port's CLI must
print what taxtk's CLI prints on the test_cli_e2e refpack.
"""

import importlib
import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))

from bench_e2e import make_workload  # noqa: E402
from test_cli_e2e import refpack, run_cli  # noqa: E402,F401

import taxtk.ops.pallas_myers_systolic as pms  # noqa: E402
from taxtk.cli import taxator as jax_cli  # noqa: E402
from taxtk.engine.aligner import BatchAligner as JaxAligner  # noqa: E402
from taxtk_torch.cli import taxator as torch_cli  # noqa: E402
from taxtk_torch.engine import aligner as torch_aligner_mod  # noqa: E402
from taxtk_torch.ops.seqpool import reset_shared_pools  # noqa: E402

RANKS = ["superkingdom", "phylum", "class", "order", "family", "genus",
         "species"]


def _run_engine(pkg, paths, aligner, protein=False):
    """Parse + group + RPA engine of package `pkg`; returns (gff3, log)."""
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
    out, log = io.StringIO(), io.StringIO()
    engine = mod("engine.executor").RpaEngine(
        tax, store.IndexedFastaStore(query_fa), store.IndexedFastaStore(ref_fa),
        aligner=aligner, logsink=log, protein=protein,
    )
    rsets = mod("engine.recordsets").iter_record_sets(iter(recs), True, False)
    engine.run(rsets, out)
    return out.getvalue(), log.getvalue()


def test_engine_gff3_and_log_match_taxtk(tmp_path, monkeypatch):
    paths = make_workload(str(tmp_path), 3, seed=3, min_len=1000,
                          max_len=2000)
    threshold = 400  # both kernel routes at test sizes

    # taxtk: the Pallas kernels in interpret mode, systolic entry at the
    # small test geometry of tests/test_long_segments.py (no result change)
    real_systolic = pms.batched_edit_distance_systolic

    def small_systolic(a, b, al, bl, **kw):
        kw.pop("interpret", None)
        return real_systolic(a, b, al, bl, block_words=2, sub_tile=2,
                             text_chunk=64, interpret=True,
                             lazy=kw.get("lazy", False),
                             pool_cache=kw.get("pool_cache"))

    monkeypatch.setattr(pms, "batched_edit_distance_systolic", small_systolic)
    ref = JaxAligner("dna", dna_backend="myers-pallas", pallas_interpret=True)
    ref.long_pattern_threshold = threshold
    want = _run_engine("taxtk", paths, ref)

    # the port: plain versions of both kernels, counted per route
    calls = {"short": 0, "systolic": 0}
    for route, name in (("short", "batched_edit_distance_short"),
                        ("systolic", "batched_edit_distance_systolic")):
        real = getattr(torch_aligner_mod, name)

        def counted(*a, _real=real, _route=route, **kw):
            calls[_route] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(torch_aligner_mod, name, counted)
    reset_shared_pools()
    port = torch_aligner_mod.BatchAligner("dna", dna_backend="myers",
                                          device="cpu")
    port.long_pattern_threshold = threshold
    got = _run_engine("taxtk_torch", paths, port)

    assert calls["short"] > 0 and calls["systolic"] > 0, calls
    assert port.pairs_aligned == ref.pairs_aligned
    assert got[0] == want[0]  # GFF3
    assert got[1] == want[1]  # decision log
    assert got[0].count("\n") > 3 and got[1]


@pytest.mark.parametrize("backend", ["myers", "native", "wavefront",
                                     "myers-pallas"])
def test_cli_stdout_matches_taxtk(refpack, monkeypatch, capsys, backend):  # noqa: F811
    monkeypatch.setenv("TAXATORTK_TAXONOMY_NCBI", str(refpack["dir"]))
    argv = [
        "-a", "rpa", "-g", refpack["mapping"], "-q", refpack["qfile"],
        "-f", refpack["refdata"], "-i", refpack["refdata"] + ".fai",
        "-x", "0.5", "-o", "0",
    ]
    rc_ref, want = run_cli(jax_cli.main, argv + ["--dna-backend", backend],
                           refpack["alignments"], monkeypatch, capsys)
    rc, got = run_cli(
        torch_cli.main, argv + ["--device", "cpu", "--dna-backend", backend],
        refpack["alignments"], monkeypatch, capsys)
    assert rc_ref == rc == 0
    assert got == want
    assert got.startswith("##gff-version 3\n")


def test_cli_unported_modes_fail_clearly(refpack, monkeypatch, capsys):  # noqa: F811
    """Every mode is ported: --mesh runs (on the CPU here, equal to the
    single-device run); what fails is a grid of more cards than there
    are, clearly and without falling back to the CPU."""
    import torch

    monkeypatch.setenv("TAXATORTK_TAXONOMY_NCBI", str(refpack["dir"]))
    argv = ["-g", refpack["mapping"], "-q", refpack["qfile"],
            "-f", refpack["refdata"]]
    outs = []
    for extra in (["--mesh", "1x1", "--device", "cpu"], ["--device", "cpu"]):
        monkeypatch.setattr(sys, "stdin", io.StringIO(refpack["alignments"]))
        assert torch_cli.main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].startswith("##gff-version 3\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(sys, "stdin", io.StringIO(refpack["alignments"]))
    assert torch_cli.main(argv + ["--mesh", "1x1"]) == 1
    captured = capsys.readouterr()
    assert "--mesh 1x1 needs 1 devices; 0 available" in captured.err
    assert captured.out == ""


def test_default_device_is_cuda():
    import torch

    from taxtk_torch.device import resolve_device
    from taxtk_torch.utils.errors import TaxtkError

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(TaxtkError, match="device='cpu'"):
            torch_aligner_mod.BatchAligner("dna")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("mode,taxtk_name,route", [
    ("dna", "myers-pallas", "myers-cuda"),
    ("protein", "wavefront-pallas", "wavefront-cuda")])
def test_aligner_takes_taxtk_backend_names(mode, taxtk_name, route):
    """taxtk's names of its kernel routes give the port's kernel route,
    pool cache included; on the CPU it runs the plain versions."""
    from taxtk.ops import oracle

    kw = {f"{mode}_backend": taxtk_name}
    al = torch_aligner_mod.BatchAligner(mode, device="cpu", **kw)
    assert getattr(al, f"{mode}_backend") == route
    assert al.pool_cache is not None
    if mode == "dna":
        rng = np.random.default_rng(5)
        pairs = [(rng.integers(0, 4, m).astype(np.uint8),
                  rng.integers(0, 4, n).astype(np.uint8))
                 for m, n in [(30, 35), (0, 4), (64, 60)]]
        assert [int(v.distance) for v in al.align_pairs(pairs)] == [
            oracle.edit_distance(a, b) for a, b in pairs]


def test_empty_and_host_long_routes_match_oracle():
    """Empty sides resolve on the host; pairs beyond the device caps run
    the host C++ Myers on its thread, mixed with device buckets."""
    from taxtk.ops import oracle

    rng = np.random.default_rng(4)
    pairs = [(rng.integers(0, 4, m).astype(np.uint8),
              rng.integers(0, 5, n).astype(np.uint8))
             for m, n in [(0, 30), (40, 0), (50, 70), (300, 280), (700, 650),
                          (90, 2000)]]
    al = torch_aligner_mod.BatchAligner("dna", dna_backend="myers",
                                        device="cpu")
    al.long_pattern_threshold = 200
    al.tpu_long_pattern_cap = 500  # (700, 650) goes to the host thread
    got = al.align_pairs(pairs)
    for (a, b), v in zip(pairs, got):
        want = oracle.dna_align(a, b)
        assert v.distance == np.float32(want.distance)
        assert v.similarity == np.float32(want.similarity)
    assert "host_long" in al.stage_seconds

"""taxtk_torch's binning pipeline against taxtk's, byte for byte, on the CPU.

Each test runs taxtk and the port (device="cpu": the plain versions of the
kernels) on the same inputs and compares what they write: every output
file of run_binning_workflow (the gzip alignments archive decompressed,
since gzip stamps its header with the time), the CLI's rc, stdout and
stderr with the outdir replaced, and the units the workflow is built of.
Each package gets its own copy of the inputs, so that each writes its own
.fai files.  The tolerance is zero: every output is text.
"""

import gzip
import io
import os
import shutil

import numpy as np
import pytest

from test_orf_last import (  # noqa: F401
    last_case,
    protein_workflow_case,
    rev_translate,
    revcomp,
)
from test_pipeline import MAF_TEXT, refpack_dir  # noqa: F401
from test_refpack_shard import _mini_refpack, _run
from test_toolcheck import _fake_tool, fake_path  # noqa: F401

import taxtk.pipeline.workflows as jax_wf
import taxtk_torch.pipeline.workflows as torch_wf
from taxtk.cli import pipeline as jax_cli
from taxtk.pipeline import maf as jax_maf
from taxtk.pipeline import orf as jax_orf
from taxtk.pipeline import summaries as jax_summaries
from taxtk.pipeline import toolcheck as jax_toolcheck
from taxtk.parallel import shardserver as jax_shards
from taxtk.refpack.store import IndexedFastaStore as JaxStore
from taxtk.refpack.store import InMemoryFastaStore as JaxInMemoryStore
from taxtk.taxonomy.newick import NewickBuilder as JaxNewick
from taxtk.utils.errors import TaxtkError as JaxError
from taxtk_torch.cli import pipeline as torch_cli
from taxtk_torch.constants import DEFAULT_RANKS
from taxtk_torch.engine import aligner as torch_aligner_mod
from taxtk_torch.engine.executor import RpaEngine
from taxtk_torch.engine.recordsets import iter_record_sets
from taxtk_torch.formats.alignments import parse_alignment_line
from taxtk_torch.parallel import shardserver as torch_shards
from taxtk_torch.parallel.refpack import ShardedRefpackStore, split_refpack
from taxtk_torch.pipeline import maf as torch_maf
from taxtk_torch.pipeline import orf as torch_orf
from taxtk_torch.pipeline import summaries as torch_summaries
from taxtk_torch.pipeline import toolcheck as torch_toolcheck
from taxtk_torch.refpack.store import FaiIndex
from taxtk_torch.refpack.store import IndexedFastaStore as TorchStore
from taxtk_torch.refpack.store import InMemoryFastaStore
from taxtk_torch.taxonomy.flat import parse_ncbi_flat_files
from taxtk_torch.taxonomy.newick import NewickBuilder as TorchNewick
from taxtk_torch.utils.errors import TaxtkError as TorchError

from fixture_tax import make_taxonomy, write_dump

DNA_OUTPUTS = {"alignments", "gff3", "binning", "taxpath", "taxsummary",
               "vprofile", "html", "krona_support", "krona_data",
               "krona_sunburst"}


def _own_copy(case, dst):
    """The case's refpack and input files copied under dst, .fai files
    left out, so that each package reads its own copy and builds and
    writes its own indexes."""
    os.makedirs(dst)
    out = dict(case)
    for key in ("root", "qfile", "aln"):
        if key not in case:
            continue
        target = os.path.join(dst, os.path.basename(case[key]))
        if os.path.isdir(case[key]):
            shutil.copytree(case[key], target,
                            ignore=shutil.ignore_patterns("*.fai"))
        else:
            shutil.copy2(case[key], target)
        out[key] = target
    return out


def _outputs(paths, outdir):
    """Every output of a workflow run by key: its name under outdir and its
    bytes (the alignments archive decompressed)."""
    out = {}
    for key, p in paths.items():
        if key == "orf_tool":
            out[key] = p
            continue
        opener = gzip.open if key == "alignments" else open
        with opener(p, "rb") as f:
            out[key] = (os.path.relpath(p, outdir), f.read())
    return out


def _fai_bytes(case):
    """The .fai files a run wrote beside its inputs, by name."""
    found = {}
    for base, _, files in os.walk(os.path.dirname(case["qfile"])):
        for name in files:
            if name.endswith(".fai"):
                with open(os.path.join(base, name), "rb") as f:
                    found[name] = f.read()
    return found


def _both_workflows(case, tmp_path, **kw):
    """run_binning_workflow of taxtk and of the port (on the CPU), each on
    its own copy of the case; returns both outputs and both copies."""
    runs = []
    for pkg, wf, extra in (("taxtk", jax_wf, {}),
                           ("taxtk_torch", torch_wf, {"device": "cpu"})):
        own = _own_copy(case, str(tmp_path / pkg))
        outdir = str(tmp_path / pkg / "out")
        args = dict(kw)
        if "alignments_file" in args:
            args["alignments_file"] = own["aln"]
        paths = wf.run_binning_workflow(own["root"], own["qfile"], outdir,
                                        **args, **extra)
        runs.append((_outputs(paths, outdir), own))
    return runs


@pytest.mark.parametrize("route", ["sort", "fallback"])
def test_workflow_outputs_match_taxtk(refpack_dir, tmp_path,  # noqa: F811
                                      monkeypatch, route):
    """Every output file equal, through the external `sort` pipe and
    through the tempfile merge-sort fallback (no `sort` on PATH)."""
    if route == "fallback":
        for wf in (jax_wf, torch_wf):
            real = wf._which
            monkeypatch.setattr(
                wf, "_which",
                lambda p, _real=real: None if p == "sort" else _real(p))
    (want, want_case), (got, got_case) = _both_workflows(
        refpack_dir, tmp_path, alignments_file=refpack_dir["aln"])
    assert set(got) == DNA_OUTPUTS
    assert got == want
    assert _fai_bytes(got_case) == _fai_bytes(want_case)
    assert len(_fai_bytes(got_case)) == 2  # the query's and the refpack's
    gff3 = got["gff3"][1].decode()
    assert gff3.startswith("##gff-version 3\n") and gff3.count("\n") > 2


def test_protein_workflow_with_orf_calling_matches_taxtk(
        protein_workflow_case, tmp_path):  # noqa: F811
    (want, _), (got, _) = _both_workflows(
        protein_workflow_case, tmp_path,
        alignments_file=protein_workflow_case["aln"], protein=True,
        orf_call=True)
    assert set(got) == DNA_OUTPUTS | {"orfs", "orf_tool"}
    assert got["orf_tool"] == "builtin"
    assert got == want
    assert got["binning"][1].count(b"contig") >= 2


def test_last_workflow_matches_taxtk(last_case, tmp_path,  # noqa: F811
                                     monkeypatch):
    """The LAST pipeline with the stub lastal on PATH (both packages see
    the same PATH): query sharding over two cores and in-order merge."""
    monkeypatch.setenv("PATH",
                       last_case["bindir"] + os.pathsep + os.environ["PATH"])
    (want, _), (got, _) = _both_workflows(last_case, tmp_path,
                                          aligner_kind="last", cores=2)
    assert set(got) == DNA_OUTPUTS
    assert got == want
    argv = open(last_case["stub"] + ".argv").read().splitlines()
    assert sum(not a.startswith("--version") for a in argv) == 4  # 2 x 2


def test_last_workflow_refuses_protein(last_case, tmp_path):  # noqa: F811
    msgs = []
    for wf, err, extra in ((jax_wf, JaxError, {}),
                           (torch_wf, TorchError, {"device": "cpu"})):
        with pytest.raises(err) as e:
            wf.run_binning_workflow(
                last_case["root"], last_case["qfile"], str(tmp_path / "o"),
                aligner_kind="last", protein=True, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "the LAST pipeline is nucleotide-only"


def test_merge_sort_writer_matches_taxtk(tmp_path):
    """The port's _MergeSortWriter against taxtk's on the same ragged
    writes, spilled in several tempfile runs."""
    import random

    rng = random.Random(5)
    lines = ["##gff-version 3"] + [
        f"c{rng.randrange(60)}\ttaxator-tk\tsequence_feature\t{k}"
        for k in range(500)]
    text = "".join(ln + "\n" for ln in lines)
    cuts = [0]
    while cuts[-1] < len(text):
        cuts.append(cuts[-1] + rng.randrange(1, 200))
    outs = []
    for wf in (jax_wf, torch_wf):
        out = io.StringIO()
        w = wf._MergeSortWriter(out, str(tmp_path), chunk_lines=64)
        for a, b in zip(cuts, cuts[1:]):
            w.write(text[a:b])
        w.finish()
        assert w.runs == []
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert outs[1].splitlines()[0] == "##gff-version 3"


def _maf_of(case):
    """The case's alignments as ungapped LAST MAF blocks (reference first,
    query second), forward strand."""
    genomes = {}
    with open(os.path.join(case["root"], "refdata.fna")) as f:
        for hdr, seq in zip(f, f):
            genomes[hdr[1:].strip()] = seq.strip()
    blocks = ["# LAST version stub\n"]
    with gzip.open(case["aln"], "rt") as f:
        for line in f:
            q, _, _, qlen, r, rs, _, score = line.split("\t")[:8]
            qlen, off = int(qlen), int(rs) - 1
            rtext = genomes[r][off:off + qlen]
            blocks.append(
                f"\na score={score} expect=1e-9\n"
                f"s {r} {off} {qlen} + {len(genomes[r])} {rtext}\n"
                f"s {q} 0 {qlen} + {qlen} {case['queries'][q]}\n")
    return "".join(blocks)


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("mode", ["alignments", "maf", "protein",
                                  "missing-refpack"])
def test_pipeline_cli_matches_taxtk(request, tmp_path, capsys, mode):
    """taxtk-binning of both packages: the same rc, stdout and stderr with
    the outdir replaced, and the same output files."""
    case = request.getfixturevalue(
        "protein_workflow_case" if mode == "protein" else "refpack_dir")
    if mode == "maf":
        maf = tmp_path / "in.maf"
        maf.write_text(_maf_of(case))
    results = []
    for pkg, main, extra in (("taxtk", jax_cli.main, []),
                             ("taxtk_torch", torch_cli.main,
                              ["--device", "cpu"])):
        own = _own_copy(case, str(tmp_path / pkg))
        outdir = str(tmp_path / pkg / "out")
        root = own["root"] + ("-none" if mode == "missing-refpack" else "")
        argv = [root, own["qfile"], outdir]
        if mode == "maf":
            argv += ["--maf", str(maf)]
        else:
            argv += ["--alignments", own["aln"]]
        if mode == "protein":
            argv += ["--protein"]
        rc, out, err = _run_cli(main, argv + extra, capsys)
        files = {}
        if os.path.isdir(outdir):
            for name in sorted(os.listdir(outdir)):
                opener = gzip.open if name.endswith(".gz") else open
                with opener(os.path.join(outdir, name), "rb") as f:
                    files[name] = f.read()
        results.append((rc, out.replace(str(tmp_path / pkg), "DIR"),
                        err.replace(str(tmp_path / pkg), "DIR"), files))
    assert results[1] == results[0]
    rc, out, err, files = results[1]
    if mode == "missing-refpack":
        assert rc == 1 and err.startswith("pipeline error: refpack incomplete")
    else:
        assert rc == 0 and out.startswith("Results are in 'DIR/out/'.")
        assert files["sample.gff3"].count(b"\n") > 2
        if mode == "maf":
            with gzip.open(case["aln"], "rb") as f:
                assert (files["maf_converted.alignments"].count(b"\n")
                        == f.read().count(b"\n"))


def test_pipeline_cli_default_device_is_cuda(refpack_dir, tmp_path,  # noqa: F811
                                             capsys):
    """Without --device the pipeline runs on the card; on a host without
    one it stops with resolve_device's error before any stage runs."""
    import torch

    if torch.cuda.is_available():
        assert torch_cli.build_parser().parse_args(
            ["r", "q", "o"]).device == "cuda"
        return
    outdir = tmp_path / "out"
    rc, out, err = _run_cli(
        torch_cli.main, [refpack_dir["root"], refpack_dir["qfile"],
                         str(outdir), "--alignments", refpack_dir["aln"]],
        capsys)
    assert rc == 1 and out == ""
    assert err.startswith("pipeline error: taxtk_torch runs on a CUDA device")
    assert "device='cpu'" in err
    assert not outdir.exists()


def test_pipeline_cli_surfaces_kernel_failure(refpack_dir, tmp_path,  # noqa: F811
                                              monkeypatch):
    """A failing kernel is not a TaxtkError: it leaves the CLI as the
    exception it is (a traceback and a non-zero exit), not as "pipeline
    error"."""
    def broken(*a, **kw):
        raise RuntimeError("myers_short: CUDA error 719")

    monkeypatch.setattr(torch_aligner_mod, "batched_edit_distance_short",
                        broken)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        torch_cli.main([refpack_dir["root"], refpack_dir["qfile"],
                        str(tmp_path / "out"), "--alignments",
                        refpack_dir["aln"], "--device", "cpu"])


# ------------------------------------------------------------------ units
@pytest.mark.parametrize("protein", [False, True])
def test_convert_maf_matches_taxtk(protein):
    outs = []
    for maf in (jax_maf, torch_maf):
        out = io.StringIO()
        n = maf.convert_maf(io.StringIO(MAF_TEXT), out, protein=protein)
        blocks = [vars(b) for b in maf.iter_maf_blocks(io.StringIO(MAF_TEXT))]
        outs.append((n, out.getvalue(), blocks))
    assert outs[1] == outs[0]
    assert outs[1][0] == 2


PROT = "MKLVNQWERTYIPASDFGHKLCVNMQWERTYIPASDF"
ORF_CASES = {
    "forward": ("TAA" + rev_translate(PROT) + "TAA", 96),
    "reverse": (revcomp("TAA" + rev_translate(PROT) + "TAA"), 96),
    "short-filtered": ("TAA" + rev_translate("MKLVNQWERTY") + "TAA", 96),
    "short-kept": ("TAA" + rev_translate("MKLVNQWERTY") + "TAA", 33),
    "ambiguous": (rev_translate("K" * 20) + "NNN" + rev_translate("K" * 19),
                  96),
}


@pytest.mark.parametrize("name", sorted(ORF_CASES))
def test_orfs_of_sequence_matches_taxtk(name):
    dna, min_length = ORF_CASES[name]
    want = list(jax_orf.orfs_of_sequence("c", dna, min_length=min_length))
    got = list(torch_orf.orfs_of_sequence("c", dna, min_length=min_length))
    assert got == want
    assert got or name == "short-filtered"


def test_call_orfs_matches_taxtk(tmp_path):
    fa = (f">ctg1 desc\n{'TAA' + rev_translate('A' * 50) + 'TAA'}\n"
          f">ctg2\nACGT\n>ctg3\n{ORF_CASES['reverse'][0]}\n")
    outs = []
    for orf in (jax_orf, torch_orf):
        out = io.StringIO()
        n = orf.call_orfs(io.StringIO(fa), out, min_length=96)
        src = tmp_path / "in.fna"
        src.write_text(fa)
        faa = tmp_path / f"{orf.__name__}.faa"
        tool = orf.call_orfs_file(str(src), str(faa))
        outs.append((n, out.getvalue(), tool, faa.read_text()))
    assert outs[1] == outs[0]
    assert outs[1][0] >= 2 and outs[1][2] == "builtin"


def _toolcheck_case(tc, name, bindir, rp):
    """One toolcheck scenario of tests/test_toolcheck.py run through module
    tc; returns what it observed (warnings, results, raised messages)."""
    warned = []
    if name == "manifest":
        return {k: vars(v) for k, v in tc.MANIFEST.items()}
    if name == "match":
        _fake_tool(bindir, "blastn", "blastn: 2.11.0+")
        return (tc.probe_tool_version("blastn"),
                tc.verify_external_tools(["blastn"], warn=warned.append),
                warned)
    if name == "mismatch":
        _fake_tool(bindir, "blastn", "blastn: 2.16.0+")
        return tc.verify_external_tools(["blastn"], warn=warned.append), warned
    if name == "missing":
        return (tc.verify_external_tools(["lastal", "orfm"],
                                         warn=warned.append), warned)
    if name == "strict":
        _fake_tool(bindir, "orfm", "OrfM v0.6.0")
        try:
            tc.verify_external_tools(["orfm"], strict=True)
        except (JaxError, TorchError) as e:
            return type(e).__name__, str(e)
        return None
    if name == "refpack-record":
        _fake_tool(bindir, "blastn", "blastn: 2.16.0+")
        recorded = tc.record_tool_versions(rp, ["blastn", "lastal"])
        with open(os.path.join(rp, "tool_versions.json"), "rb") as f:
            blob = f.read()
        same = tc.verify_external_tools(["blastn"], refpack_dir=rp,
                                        warn=warned.append)
        _fake_tool(bindir, "blastn", "blastn: 2.11.0+")
        changed = tc.verify_external_tools(["blastn"], refpack_dir=rp,
                                           warn=warned.append)
        return recorded, blob, same, changed, warned
    raise ValueError(name)


@pytest.mark.parametrize("name", ["manifest", "match", "mismatch", "missing",
                                  "strict", "refpack-record"])
def test_toolcheck_matches_taxtk(fake_path, tmp_path, name):  # noqa: F811
    results = []
    for tc in (jax_toolcheck, torch_toolcheck):
        for f in os.listdir(fake_path):
            os.unlink(os.path.join(fake_path, f))
        rp = tmp_path / tc.__name__
        rp.mkdir()
        results.append(_toolcheck_case(tc, name, fake_path, str(rp)))
    assert results[1] == results[0]
    assert results[1]
    assert torch_toolcheck._VERSIONS_FILE == "tool_versions.json"


def test_refpack_tool_record_reads_across_packages(fake_path, tmp_path):  # noqa: F811
    """A refpack indexed by either package verifies in the other."""
    _fake_tool(fake_path, "lastal", "lastal 1180")
    for writer, reader in ((jax_toolcheck, torch_toolcheck),
                           (torch_toolcheck, jax_toolcheck)):
        rp = tmp_path / writer.__name__
        rp.mkdir()
        writer.record_tool_versions(str(rp), ["lastal"])
        assert reader.verify_external_tools(
            ["lastal"], refpack_dir=str(rp), warn=lambda m: None) == []


@pytest.mark.parametrize("gz", [False, True])
def test_taxonomy_version_hash_matches_taxtk(tmp_path, gz):
    nodes, _ = write_dump(str(tmp_path))
    if gz:
        with open(nodes, "rb") as src, gzip.open(nodes + ".gz", "wb") as dst:
            dst.write(src.read())
        nodes += ".gz"
    want = jax_summaries.taxonomy_version_hash(nodes)
    assert torch_summaries.taxonomy_version_hash(nodes) == want
    assert len(want) == 32


def _port_taxonomy(tmpdir, prune=False):
    """fixture_tax.make_taxonomy, parsed by the port."""
    os.makedirs(tmpdir, exist_ok=True)
    nodes, names = write_dump(str(tmpdir))
    tax = parse_ncbi_flat_files(nodes, names, "testver", DEFAULT_RANKS)
    return tax.prune_to_marked_ranks(DEFAULT_RANKS) if prune else tax


@pytest.mark.parametrize("ranks,names,fill", [
    (["species", "genus", "family"], False, False),
    (["genus", "phylum"], True, False),
    (["species", "order", "superkingdom"], False, True),
    (["species", "nonsense-rank"], True, True),
])
def test_newick_builder_matches_taxtk(tmp_path, capsys, ranks, names, fill):
    taxa = ["2111111", "21111111", "2111121", "2211111", "31", "99999",
            "211", "2111112", "1"]
    outs = []
    for cls, tax in ((JaxNewick, make_taxonomy(tmp_path)),
                     (TorchNewick, _port_taxonomy(tmp_path / "port"))):
        b = cls(tax, ranks, show_names=names, fill_empty_ranks=fill)
        for t in taxa:
            b.add(t)
        outs.append((b.build(), capsys.readouterr()))
    assert outs[1] == outs[0]
    assert outs[1][0].endswith(");\n") and "99999" in outs[1][1].err


# ----------------------------------------------------------------- shards
@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("taxtk_torch", "taxtk_torch"), ("taxtk", "taxtk_torch"),
    ("taxtk_torch", "taxtk")])
def test_remote_shard_store_across_packages(tmp_path, server_pkg, client_pkg):
    """The wire format is shared: a port client reads a taxtk server and a
    taxtk client a port server, each answer equal to the local store's."""
    mods = {"taxtk": (jax_shards, JaxStore),
            "taxtk_torch": (torch_shards, TorchStore)}
    _, fa, _, _, _, mapping = _mini_refpack(tmp_path)
    shards, store_cls = mods[server_pkg]
    server = shards.ShardServer(store_cls(fa), host="127.0.0.1", port=0)
    server.serve_background()
    try:
        local = TorchStore(fa)
        remote = mods[client_pkg][0].RemoteShardStore(
            "127.0.0.1", server.port, timeout=30)
        try:
            sid = sorted(mapping)[1]
            assert remote.sequence_length(sid) == local.sequence_length(sid)
            assert remote.get_sequence(sid, 5, 60) == local.get_sequence(
                sid, 5, 60)
            with pytest.raises(KeyError):
                remote.sequence_length("nope")
            with pytest.raises(KeyError):
                remote.get_sequence("nope", 0, 3)
            specs = [(sid, 0, 50, False), (sid, 10, 80, True),
                     (sid, 3, 40, False)]
            for protein in (False, True):
                got = remote.fetch_encode_batch(specs, protein=protein)
                want = local.fetch_encode_batch(specs, protein=protein)
                assert len(got) == len(want) == 3
                for g, w in zip(got, want):
                    assert g.dtype == np.uint8 and np.array_equal(g, w)
        finally:
            remote.close()
    finally:
        server.shutdown()
        server.server_close()


def _port_run(tax, query_store, db_store, rows, mapping):
    """The port engine (device="cpu") on the rows; returns its GFF3."""
    records = []
    for ln in rows:
        r = parse_alignment_line(ln)
        r.reference_node = tax.node(mapping[r.reference_identifier])
        records.append(r)
    out = io.StringIO()
    RpaEngine(tax, query_store, db_store, device="cpu").run(
        iter_record_sets(iter(records)), out)
    return out.getvalue()


def test_remote_sharded_engine_matches_taxtk_monolithic(tmp_path):
    """The port engine on connect_sharded of two served shards writes the
    GFF3 taxtk's engine writes on the whole refpack."""
    jax_tax, fa, mp, qf, rows, mapping = _mini_refpack(tmp_path, seed=23)
    want = _run(jax_tax, JaxInMemoryStore(qf), JaxStore(fa), rows, mapping)
    assert want.count("\n") > 1

    tax = _port_taxonomy(tmp_path / "port", prune=True)
    parts = split_refpack(fa, 2, str(tmp_path / "shards"), mapping_path=mp)
    servers = []
    store = None
    try:
        endpoints = []
        for part_fa, _ in parts:
            FaiIndex.build(part_fa).save(part_fa + ".fai")
            srv = torch_shards.ShardServer(TorchStore(part_fa),
                                           host="127.0.0.1", port=0)
            srv.serve_background()
            servers.append(srv)
            endpoints.append(("127.0.0.1", srv.port))
        store = torch_shards.connect_sharded(endpoints)
        assert isinstance(store, ShardedRefpackStore)
        got = _port_run(tax, InMemoryFastaStore(qf), store, rows, mapping)
    finally:
        if store is not None:
            for shard in store.stores:
                shard.close()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    assert got == want

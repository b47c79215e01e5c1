"""The port's companion CLIs and taxator's surface against taxtk's, on the CPU.

Each case runs the same argv through taxtk's main and the port's main, each
package in a directory of its own, and compares rc, stdout and stderr (with
the directory replaced) and the files the command wrote: tools, taxknife,
alignments-filter, index, and taxator with the flags that change its
output, repeated -f over the port's own shards and the edge inputs.  The
last tests start the seven port CLIs and a port shard server as
processes.
"""

import io
import os
import random
import select
import stat
import subprocess
import sys

import numpy as np
import pytest

from fixture_tax import write_dump
from test_cli_e2e import refpack  # noqa: F401
from test_edge_inputs import env  # noqa: F401
from test_pipeline import MAF_TEXT
from test_refpack_shard import _mini_refpack

from taxtk.cli import alignments_filter as jax_filter
from taxtk.cli import index as jax_index
from taxtk.cli import taxator as jax_taxator
from taxtk.cli import taxknife as jax_taxknife
from taxtk.cli import tools as jax_tools
from taxtk.parallel.shardserver import RemoteShardStore as JaxRemote
from taxtk_torch.cli import alignments_filter as torch_filter
from taxtk_torch.cli import index as torch_index
from taxtk_torch.cli import taxator as torch_taxator
from taxtk_torch.cli import taxknife as torch_taxknife
from taxtk_torch.cli import tools as torch_tools
from taxtk_torch.parallel.shardserver import RemoteShardStore as TorchRemote
from taxtk_torch.refpack.store import IndexedFastaStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _call(main, argv, stdin, monkeypatch, capsys):
    """main(argv) with stdin; returns (rc, stdout, stderr).  argparse's
    exit (a usage error) counts as its code."""
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


def _files(d):
    """Every file under d by relative path, with its bytes."""
    found = {}
    for base, _, names in os.walk(d):
        for name in names:
            p = os.path.join(base, name)
            with open(p, "rb") as f:
                found[os.path.relpath(p, d)] = f.read()
    return found


def _both(mains, argv, stdin, setup, tmp_path, monkeypatch, capsys):
    """The command in each package, each in its own directory made by
    setup(dir): argv and stdin have "{dir}" replaced by that directory.
    Returns both (rc, stdout, stderr, files), "{dir}" put back."""
    results = []
    for pkg, main in zip(("taxtk", "taxtk_torch"), mains):
        d = tmp_path / pkg
        d.mkdir()
        setup(d)
        sub = lambda s: s.replace("{dir}", str(d))  # noqa: E731
        rc, out, err = _call(main, [sub(a) for a in argv], sub(stdin),
                             monkeypatch, capsys)
        files = _files(str(d))
        back = lambda s: s.replace(str(d), "{dir}")  # noqa: E731
        results.append((rc, back(out), back(err), files))
    return results


# ------------------------------------------------------------------ tools
ALIGNMENTS = (
    "q1\t5\t50\t100\tr1\t10\t55\t81.5\t0.001\t40\t46\n"
    "q1\t1\t99\t100\tr2\t200\t102\t120\t1e-30\t90\t99\n"
    "# a comment\n"
    "q2\t3\t60\t60\tr1\t1\t58\t44\t2.5e-7\t50\t58\n"
)
GENES = (
    "##gff-version 3\n"
    "ctg1\tprodigal\tCDS\t101\t400\t.\t+\t0\tID=orf1\n"
    "ctg1\tprodigal\tCDS\t501\t800\t.\t-\t0\tID=orf2\n"
    "ctg2\tprodigal\tCDS\t1\t90\t.\t+\t0\tprotein_id=orf3\n"
    "short\tline\n"
)
PROT_ALIGNMENTS = (
    "orf1\t1\t50\t100\trp\t1\t50\t60\t0\t45\t50\n"
    "orf2\t1\t50\t100\trp\t1\t50\t60\t0\t45\t50\n"
    "orf3\t2\t30\t30\trq\t4\t32\t33\t1e-5\t20\t29\n"
    "orfX\t1\t10\t10\trp\t1\t10\t5\t1\t5\t10\n"
)


def _tools_setup(d):
    _, fa, mp, _, _, _ = _mini_refpack(d, seed=3)
    (d / "genes.gff3").write_text(GENES)


TOOLS_CASES = {
    "strip": (["strip-fasta-identifiers"],
              ">seq1 long description\nACGT\n>seq2 more\nTTTT\n>seq3\nAC"),
    "strip-duplicate": (["strip-fasta-identifiers"], ">a x\nA\n>a y\nC\n"),
    "blasttab": (["alignments2blasttab"], ALIGNMENTS),
    "maf": (["maf2alignments"], MAF_TEXT),
    "maf-protein": (["maf2alignments", "--protein"], MAF_TEXT),
    "map-prot-dna": (["map-prot-dna", "{dir}/genes.gff3"], PROT_ALIGNMENTS),
    "split-refpack": (["split-refpack", "{dir}/refdata.fna", "{dir}/out",
                       "-n", "3", "-g", "{dir}/mapping.tax", "--index"], ""),
    "split-refpack-plain": (["split-refpack", "{dir}/refdata.fna",
                             "{dir}/out", "-n", "2"], ""),
    "split-refpack-zero": (["split-refpack", "{dir}/refdata.fna",
                            "{dir}/out", "-n", "0"], ""),
    "split-refpack-missing": (["split-refpack", "{dir}/nope.fna",
                               "{dir}/out", "-n", "2"], ""),
    "no-command": ([], ""),
}


@pytest.mark.parametrize("case", sorted(TOOLS_CASES))
def test_tools_matches_taxtk(tmp_path, monkeypatch, capsys, case):
    argv, stdin = TOOLS_CASES[case]
    want, got = _both((jax_tools.main, torch_tools.main), argv, stdin,
                      _tools_setup, tmp_path, monkeypatch, capsys)
    assert got == want
    rc, out, err, files = got
    if case in ("strip-duplicate", "split-refpack-zero",
                "split-refpack-missing"):
        assert rc == 1 and err.startswith("error: ")
    elif case == "no-command":
        assert rc == 2
    else:
        assert rc == 0 and out
    if case == "split-refpack":
        assert sum(p.endswith(".fai") for p in files) == 3


def test_serve_shard_process_serves_both_clients(tmp_path):
    """`python -m taxtk_torch.cli.tools serve-shard` prints its port and
    serves a port client and a taxtk client alike."""
    _, fa, _, _, _, mapping = _mini_refpack(tmp_path)
    local = IndexedFastaStore(fa)
    proc = subprocess.Popen(
        [sys.executable, "-m", "taxtk_torch.cli.tools", "serve-shard", fa,
         "--host", "127.0.0.1", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready, "serve-shard printed no port"
        port = int(proc.stdout.readline())
        sid = sorted(mapping)[0]
        specs = [(sid, 0, 40, False), (sid, 7, 90, True)]
        for cls in (TorchRemote, JaxRemote):
            remote = cls("127.0.0.1", port, timeout=30)
            try:
                assert remote.sequence_length(sid) == local.sequence_length(
                    sid)
                assert remote.get_sequence(sid, 2, 30) == local.get_sequence(
                    sid, 2, 30)
                for g, w in zip(remote.fetch_encode_batch(specs),
                                local.fetch_encode_batch(specs)):
                    assert np.array_equal(g, w)
            finally:
                remote.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


# --------------------------------------------------------------- taxknife
TAXKNIFE_CASES = {
    "traverse-skip-unknown": (["--mode", "traverse", "-r", "genus"],
                              "99999\n2111111\n"),
    "traverse-keep-unknown": (["--mode", "traverse", "-r", "genus", "-t",
                               "-b", "NA"], "99999\n"),
    "traverse-keep-not-rank": (["--mode", "traverse", "-r", "genus", "-k"],
                               "2\n"),
    "traverse-field": (["-m", "traverse", "-f", "2", "-r", "species",
                        "family", "bogus"],
                       "a\t21111111\tx\n# c\nb\t2211111\n\nc\n"),
    "traverse-positional": (["traverse", "-r", "order"], "2111121\n31\n"),
    "annotate-rank": (["--mode", "annotate", "-s", "rank"],
                      "2111111\n21111\n"),
    "annotate-name": (["-s", "name", "-c", "NA"], "2111112\n424242\n3\n"),
    "annotate-path": (["-s", "path", "-f", "2"],
                      "x\t21111111\ty\tz\nw\t31\n"),
    "annotate-taxid-path-all": (["-s", "taxid-path", "-a"],
                                "21111111\n21121\n"),
    "annotate-bad-show": (["-s", "lineage"], "2\n"),
    "tree": (["-m", "tree", "-q", "species", "genus", "-o",
              "{dir}/tree.newick"], "2111111\n2111121\n2211111\n31\n9\n"),
    "tree-names-fill": (["-m", "tree", "-q", "species", "order", "-v", "-i",
                         "-o", "{dir}/t.newick"], "21111111\n2111112\n22\n"),
    "field-zero": (["-f", "0"], "2\n"),
    "unknown-mode": (["-m", "frobnicate"], "2\n"),
    "version": (["-V"], ""),
}


@pytest.mark.parametrize("case", sorted(TAXKNIFE_CASES))
def test_taxknife_matches_taxtk(tmp_path, monkeypatch, capsys, case):
    argv, stdin = TAXKNIFE_CASES[case]
    monkeypatch.setenv("TAXATORTK_TAXONOMY_NCBI", str(tmp_path / "tax"))
    (tmp_path / "tax").mkdir()
    write_dump(str(tmp_path / "tax"))
    want, got = _both((jax_taxknife.main, torch_taxknife.main), argv, stdin,
                      lambda d: None, tmp_path, monkeypatch, capsys)
    assert got == want
    rc, out, err, files = got
    assert rc == (1 if case in ("annotate-bad-show", "field-zero") else 0)
    if case.startswith("tree"):
        assert len(files) == 1
        assert next(iter(files.values())).endswith(b");\n")


def test_taxknife_without_taxonomy_matches_taxtk(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.delenv("TAXATORTK_TAXONOMY_NCBI", raising=False)
    want, got = _both((jax_taxknife.main, torch_taxknife.main),
                      ["-s", "rank"], "2\n", lambda d: None, tmp_path,
                      monkeypatch, capsys)
    assert got == want
    assert got[0] == 1 and "TAXATORTK_TAXONOMY_NCBI" in got[2]


# ------------------------------------------------------ alignments-filter
def _filter_alignments():
    """Alignment rows from a seed: 4 queries with 2 to 8 rows each against
    6 references, some references hit twice, scores, e-values and
    identities spread."""
    rng = random.Random(17)
    rows = []
    for q in range(4):
        qlen = rng.randrange(80, 300)
        for _ in range(rng.randrange(2, 9)):
            r = rng.randrange(6)
            alen = rng.randrange(qlen // 2, qlen)
            ident = rng.randrange(alen // 2, alen + 1)
            qs = rng.randrange(1, qlen - alen + 2)
            rs = rng.randrange(1, 5000)
            rows.append(
                f"q{q}\t{qs}\t{qs + alen - 1}\t{qlen}\tr{r}\t{rs}\t"
                f"{rs + alen - 1}\t{rng.randrange(20, 400)}\t"
                f"{10.0 ** -rng.randrange(0, 40):g}\t{ident}\t{alen}")
    return "\n".join(rows) + "\n"


def _filter_setup(d):
    (d / "ref.tax").write_text(
        "".join(f"r{r}\t{['2111111', '2111112', '2211111'][r % 3]}\n"
                for r in range(6)))
    (d / "query.tax").write_text("q0\t2111111\nq1\t2211111\nq2\t31\n"
                                 "q3\t2111112\n")


FILTER_CASES = {
    "default": [],
    "min-score": ["-m", "150"],
    "min-pid": ["-p", "0.8"],
    "top-percent": ["-t", "0.3"],
    "max-evalue": ["-e", "1e-10"],
    "max-evalue-min-score-top": ["-e", "1e-5", "-m", "100", "-t", "0.95"],
    "best-alignments": ["-b", "2"],
    "sort-score": ["-s"],
    "keep-best-per-ref": ["-k"],
    "keep-best-per-taxid": ["--keep-best-per-taxid", "-y", "{dir}/ref.tax"],
    "keep-best-per-taxid-no-map": ["--keep-best-per-taxid"],
    "min-support": ["-c", "5"],
    "remove-ref-from-query-taxon": ["-r", "-x", "{dir}/query.tax", "-y",
                                    "{dir}/ref.tax"],
    "remove-ref-no-maps": ["-r"],
    "mask-by-star": ["-z", "-b", "1", "-s"],
    "version": ["-V"],
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_alignments_filter_matches_taxtk(tmp_path, monkeypatch, capsys, case):
    stdin = _filter_alignments()
    want, got = _both((jax_filter.main, torch_filter.main),
                      FILTER_CASES[case], stdin, _filter_setup, tmp_path,
                      monkeypatch, capsys)
    assert got == want
    assert got[0] == 0 and got[1]


def test_alignments_filter_malformed_input_matches_taxtk(
        tmp_path, monkeypatch, capsys):
    want, got = _both((jax_filter.main, torch_filter.main), ["-s"],
                      "q1\t1\t2\n", lambda d: None, tmp_path, monkeypatch,
                      capsys)
    assert got == want
    assert got[0] == 1 and got[2].startswith("error: ")


# ------------------------------------------------------------------ index
def _stub(bindir, name, version):
    """An indexer stub: prints its version when asked, else does nothing."""
    path = bindir / name
    path.write_text(f"#!/bin/sh\ncase \"$1\" in -version|--version) "
                    f"echo '{version}';; esac\nexit 0\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


def _index_setup(d):
    (d / "rp").mkdir()
    (d / "rp" / "refdata.fna").write_text(">r1\nACGTACGT\nACG\n>r2 x\nTT\n")


INDEX_CASES = {
    "blast-no-tools": (["blast", "{dir}/rp"], False),
    "last-no-tools": (["last", "{dir}/rp", "--cores", "2"], False),
    "blast-protein-missing": (["blast-protein", "{dir}/rp"], False),
    "blast-stub-tools": (["blast", "{dir}/rp"], True),
    "last-stub-tools": (["last", "{dir}/rp"], True),
    "version": (["-V", "blast", "{dir}/rp"], False),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_matches_taxtk(tmp_path, monkeypatch, capsys, case):
    """The .fai and tool_versions.json it writes, its rc, stdout and
    stderr; with no indexer on PATH, and with stub indexers."""
    argv, tools = INDEX_CASES[case]
    bindir = tmp_path / "bin"
    bindir.mkdir()
    if tools:
        for name, version in (("makeblastdb", "makeblastdb: 2.11.0+"),
                              ("blastn", "blastn: 2.11.0+"),
                              ("lastdb", "lastdb 1170"),
                              ("lastal", "lastal 1170")):
            _stub(bindir, name, version)
    monkeypatch.setenv("PATH", str(bindir))
    want, got = _both((jax_index.main, torch_index.main), argv, "",
                      _index_setup, tmp_path, monkeypatch, capsys)
    assert got == want
    rc, out, err, files = got
    assert rc == (1 if case == "blast-protein-missing" else 0)
    if case.endswith("tools"):
        assert "rp/refdata.fna.fai" in files
        assert "rp/tool_versions.json" in files
        assert (files["rp/tool_versions.json"] != b"{}") == tools


# ---------------------------------------------------------------- taxator
@pytest.mark.parametrize("flags", [
    [], ["-t", "0.5", "-x", "0.5"], ["-r", "species", "genus", "family"],
    ["-s", "0"]], ids=["plain", "t-x", "ranks", "s0"])
def test_taxator_flags_match_taxtk(refpack, monkeypatch, capsys, flags):  # noqa: F811
    monkeypatch.setenv("TAXATORTK_TAXONOMY_NCBI", str(refpack["dir"]))
    argv = ["-a", "rpa", "-g", refpack["mapping"], "-q", refpack["qfile"],
            "-f", refpack["refdata"], "-i", refpack["refdata"] + ".fai"]
    want = _call(jax_taxator.main, argv + flags, refpack["alignments"],
                 monkeypatch, capsys)
    got = _call(torch_taxator.main, argv + flags + ["--device", "cpu"],
                refpack["alignments"], monkeypatch, capsys)
    assert got[:2] == want[:2]
    assert got[0] == 0 and got[1].startswith("##gff-version 3\n")
    assert got[1].count("\n") > 3


@pytest.mark.parametrize("mismatched", [False, True])
def test_taxator_repeated_f_on_port_shards(tmp_path, monkeypatch, capsys,
                                           mismatched):
    """Shards made by the port's `tools split-refpack --index`, each given
    with -f and -i: the port prints what taxtk prints on the whole refpack;
    a -f without its -i is the same fatal error in both."""
    _, fa, mp, qf, rows, _ = _mini_refpack(tmp_path, seed=9)
    monkeypatch.setenv("TAXATORTK_TAXONOMY_NCBI", str(tmp_path))
    aln = "\n".join(rows) + "\n"
    base = ["-a", "rpa", "-g", mp, "-q", qf]
    rc, out, _ = _call(torch_tools.main,
                       ["split-refpack", fa, str(tmp_path / "sh"), "-n", "3",
                        "--index"], "", monkeypatch, capsys)
    shards = out.split()
    assert rc == 0 and len(shards) == 3
    argv = list(base)
    for part in shards:
        argv += ["-f", part] + ([] if mismatched else ["-i", part + ".fai"])
    if mismatched:
        argv += ["-i", shards[0] + ".fai"]
        want = _call(jax_taxator.main, argv, aln, monkeypatch, capsys)
    else:
        want = _call(jax_taxator.main, base + ["-f", fa], aln, monkeypatch,
                     capsys)
    got = _call(torch_taxator.main, argv + ["--device", "cpu"], aln,
                monkeypatch, capsys)
    assert got[:2] == want[:2]
    if mismatched:
        assert got[0] == 1 and "need one -i per -f" in got[2]
    else:
        assert got[0] == 0 and got[1].count("\n") > 1


EDGE_INPUTS = {
    "empty": "",
    "comment-only": "# nothing\n\n# more\n",
    "malformed": "not a record\n",
    "unknown-mapping": "q1\t1\t4\t4\tUNKNOWN\t1\t4\t8\t0\t4\t4\n",
}


@pytest.mark.parametrize("case", sorted(EDGE_INPUTS))
def test_taxator_edge_inputs_match_taxtk(env, monkeypatch, capsys, case):  # noqa: F811
    argv = ["-a", "rpa", "-g", str(env / "map.tax"), "-q",
            str(env / "q.fna"), "-f", str(env / "ref.fna")]
    stdin = EDGE_INPUTS[case]
    want = _call(jax_taxator.main, argv, stdin, monkeypatch, capsys)
    got = _call(torch_taxator.main, argv + ["--device", "cpu"], stdin,
                monkeypatch, capsys)
    assert got[:2] == want[:2]
    fatal = case in ("malformed", "unknown-mapping")
    assert got[0] == (1 if fatal else 0)
    if fatal:
        assert "unrecoverable" in got[2] or "bad taxon mapping" in got[2]
    else:
        assert got[1] == "##gff-version 3\n"


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("name", ["taxator", "binner", "pipeline", "tools",
                                  "index", "taxknife", "alignments_filter"])
def test_module_entry_points(name):
    r = subprocess.run(
        [sys.executable, "-m", f"taxtk_torch.cli.{name}", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.startswith("usage: ")

"""Port of taxtk/pipeline/workflows.py: the same workflow, its RPA engine on
the card unless the caller passes device="cpu".  The port keeps its own
copy and imports nothing of taxtk.

End-to-end binning workflows (Python equivalents of the bash pipelines).

run_binning_workflow mirrors binning-blast.bash / binning-last.bash /
binning-blast-protein.bash (reference: extended/binning-*.bash): candidate
alignment via an external aligner (blastn / lastal / blastp — gated on
availability), then the in-process RPA engine, sorted GFF3, consensus
binning, and summaries.  Stage outputs land in the working directory as
restartable checkpoints exactly like the reference
(sample.alignments.gz, sample.gff3, sample.binning).
"""

from __future__ import annotations

import gzip
import os
import shutil
import subprocess
import sys
from typing import Dict, Optional

from ..constants import DEFAULT_RANKS
from ..engine.executor import RpaEngine
from ..engine.recordsets import iter_record_sets
from ..formats.alignments import iter_alignment_records
from ..formats.mapping import load_seqid_taxid_mapping
from ..binning.binner import run_binner
from ..device import resolve_device
from ..engine.metrics import span
from ..refpack.store import IndexedFastaStore
from ..taxonomy.flat import parse_ncbi_flat_files
from ..utils.errors import TaxtkError, FileError
from .summaries import binning_to_summary, taxonomy_version_hash

SAMPLE_NAME = "sample"


class Refpack:
    """Refpack layout contract (reference: extended/lib/common.sh:93-128):
    refdata.fna(.fai), mapping.tax, ncbi-taxonomy/, aligner-index/."""

    def __init__(self, root: str, protein: bool = False):
        self.root = os.path.abspath(root)
        ext = "faa" if protein else "fna"
        self.refdata = os.path.join(self.root, f"refdata.{ext}")
        self.refdata_index = self.refdata + ".fai"
        self.mapping = os.path.join(self.root, "mapping.tax")
        self.taxonomy_dir = os.path.join(self.root, "ncbi-taxonomy")
        self.protein = protein
        for p in (self.refdata, self.mapping, self.taxonomy_dir):
            if not os.path.exists(p):
                raise FileError("refpack incomplete", path=p)

    def aligner_index(self, kind: str) -> str:
        sub = {"blast": "aligner-index/blast/nuc",
               "blast-protein": "aligner-index/blast/prot",
               "last": "aligner-index/last/nuc"}[kind]
        return os.path.join(self.root, sub)

    def load_taxonomy(self, ranks=DEFAULT_RANKS):
        def pick(base):
            for cand in (base + ".gz", base):
                p = os.path.join(self.taxonomy_dir, cand)
                if os.path.exists(p):
                    return p
            raise FileError("taxonomy dump missing", path=base)

        nodes = pick("nodes.dmp")
        names = pick("names.dmp")
        version_file = os.path.join(self.taxonomy_dir, "version.txt")
        version = ""
        if os.path.exists(version_file):
            with open(version_file) as fh:
                version = fh.readline().strip()
        if not version:
            version = taxonomy_version_hash(nodes)
        tax = parse_ncbi_flat_files(nodes, names, version, ranks)
        return tax


def _which(prog: str) -> Optional[str]:
    return shutil.which(prog)


class _MergeSortWriter:
    """Bounded-memory `LC_ALL=C sort -k1,1` replacement (key-1 compare,
    whole line as last resort): buffers up to `chunk_lines` GFF3 lines,
    spills each sorted chunk to a tempfile, and k-way heap-merges the runs
    on finish().  Used when coreutils `sort` is unavailable so the
    streaming contract holds at config-5 scale either way."""

    def __init__(self, out_fh, tmpdir: str, chunk_lines: int = 200_000):
        self.out = out_fh
        self.tmpdir = tmpdir
        self.chunk_lines = chunk_lines
        self.buf: list = []
        self.runs: list = []
        self._tail = ""

    @staticmethod
    def _key(line: str):
        return (line.split("\t", 1)[0], line)

    def write(self, text: str) -> int:
        data = self._tail + text
        lines = data.split("\n")
        self._tail = lines.pop()  # incomplete last line (or "")
        self.buf.extend(lines)
        if len(self.buf) >= self.chunk_lines:
            self._spill()
        return len(text)

    def _spill(self) -> None:
        if not self.buf:
            return
        import tempfile

        self.buf.sort(key=self._key)
        fh = tempfile.TemporaryFile("w+", dir=self.tmpdir)
        fh.write("".join(l + "\n" for l in self.buf))
        fh.seek(0)
        self.runs.append(fh)
        self.buf = []

    def finish(self) -> None:
        import heapq

        if self._tail:
            self.buf.append(self._tail)
            self._tail = ""
        if not self.runs:  # everything fit in one chunk
            self.buf.sort(key=self._key)
            self.out.write("".join(l + "\n" for l in self.buf))
            self.buf = []
            return
        self._spill()
        for line in heapq.merge(
            *((l.rstrip("\n") for l in f) for f in self.runs),
            key=self._key,
        ):
            self.out.write(line + "\n")
        for f in self.runs:
            f.close()
        self.runs = []


def _sorted_fallback(engine, resolved, fh, tmpdir: str) -> None:
    """Tempfile merge-sort fallback when coreutils `sort` is unavailable;
    matches `LC_ALL=C sort -k1,1` with bounded memory."""
    w = _MergeSortWriter(fh, tmpdir)
    rsets = iter_record_sets(resolved(), True, False)
    with span("pipeline.engine"):
        engine.run(rsets, w)
    with span("pipeline.sort"):
        w.finish()


def run_aligner_blast(refpack: Refpack, input_fasta: str, out_path: str,
                      algorithm: str = "dc-megablast", cores: int = 1,
                      extra_options: str = "") -> None:
    """blastn candidate generation (reference: binning-blast.bash:90-98)."""
    exe = _which("blastp" if refpack.protein else "blastn")
    if exe is None:
        raise TaxtkError("external aligner not found (blastn/blastp); provide "
                         "an alignments file instead")
    cmd = [exe, "-db", refpack.aligner_index("blast-protein" if refpack.protein else "blast"),
           "-outfmt", "6 qseqid qstart qend qlen sseqid sstart send bitscore evalue nident length",
           "-query", input_fasta, "-num_threads", str(cores)]
    if not refpack.protein:
        cmd[1:1] = ["-task", algorithm]
    if extra_options:
        cmd.extend(extra_options.split())
    # stream aligner stdout -> file, stripping spaces on the fly (the bash
    # pipeline's `tr -d ' '`, binning-blast.bash:98) — constant memory
    with open(out_path, "w") as out:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
        assert proc.stdout is not None
        for line in proc.stdout:
            out.write(line.replace(" ", ""))
        rc = proc.wait()
        if rc != 0:
            raise subprocess.CalledProcessError(rc, cmd)


def _split_fasta(input_fasta: str, n_parts: int, outdir: str) -> list:
    """Split a FASTA into <= n_parts contiguous record chunks (order
    preserved); the lastal-parallel analog of GNU parallel --pipepart
    --recstart '>' (reference: extended/bin/lastal-parallel:172)."""
    # record offsets
    offsets = []
    with open(input_fasta, "rb") as fh:
        pos = 0
        for line in fh:
            if line.startswith(b">"):
                offsets.append(pos)
            pos += len(line)
        end = pos
    if not offsets:
        return []
    n_parts = max(1, min(n_parts, len(offsets)))
    per = -(-len(offsets) // n_parts)
    parts = []
    with open(input_fasta, "rb") as fh:
        for k in range(0, len(offsets), per):
            start = offsets[k]
            stop = offsets[k + per] if k + per < len(offsets) else end
            path = os.path.join(outdir, f"qpart.{len(parts)}.fna")
            fh.seek(start)
            with open(path, "wb") as out:
                out.write(fh.read(stop - start))
            parts.append(path)
    return parts


def run_aligner_last(refpack: Refpack, input_fasta: str, out_path: str,
                     cores: int = 1, extra_options: str = "") -> None:
    """lastal candidate generation with the reference defaults `-f 1 -X 3
    -e 40` (reference: binning-last.bash:92) and within-host query sharding
    across cores with deterministic in-order merge (the lastal-parallel
    analog, extended/bin/lastal-parallel:160-196).  MAF output is converted
    to 11-column TSV on the fly (lastmaf2alignments -s semantics)."""
    from .maf import convert_maf

    exe = _which("lastal")
    if exe is None:
        raise TaxtkError("external aligner not found (lastal); provide an "
                         "alignments file or --maf instead")
    index = refpack.aligner_index("last")
    base = [exe, "-f", "1", "-X", "3", "-e", "40"]
    if extra_options:
        base.extend(extra_options.split())

    tmpdir = os.path.dirname(os.path.abspath(out_path))
    parts = _split_fasta(input_fasta, cores, tmpdir) if cores > 1 else [input_fasta]
    try:
        procs = []
        for part in parts:
            with open(part) as qf:
                procs.append(
                    subprocess.Popen(
                        base + [index, "-"], stdin=qf,
                        stdout=subprocess.PIPE, text=True,
                    )
                )
        with open(out_path, "w") as out:
            # in-order merge: part k's output is fully consumed before
            # part k+1 (lastal emits per-query blocks in input order, so
            # concatenation restores the global query order)
            for proc in procs:
                convert_maf(proc.stdout, out)
                rc = proc.wait()
                if rc != 0:
                    raise subprocess.CalledProcessError(rc, base)
    finally:
        for part in parts:
            if part != input_fasta and os.path.exists(part):
                os.unlink(part)


def run_binning_workflow(
    refpack_dir: str,
    input_fasta: str,
    outdir: str,
    alignments_file: Optional[str] = None,
    protein: bool = False,
    speedup: float = 0.5,
    cores: int = 1,
    glob_regex: Optional[str] = None,
    macro_batch: int = 512,
    aligner=None,
    aligner_kind: str = "blast",
    orf_call: bool = False,
    device="cuda",
) -> Dict[str, str]:
    """The full ALIGN => PREDICT => BIN => SUMMARIZE chain.

    When `alignments_file` is given the external-aligner stage is skipped
    (equivalent to restarting from sample.alignments.gz).

    aligner_kind: "blast" (blastn/blastp, binning-blast*.bash) or "last"
    (lastal -f 1 -X 3 -e 40 with query sharding, binning-last.bash).

    orf_call: protein pipeline gene-calling stage — the DNA input is
    ORF-called into sample.faa (real orfm when installed, built-in caller
    otherwise) which becomes the query set; the binner's default
    `([^_]+)_.*` regex globs ORFs back to contigs
    (reference: binning-blast-protein.bash:84,119).

    device: where the engine's default aligner runs (cuda or cpu); checked
    before any stage runs.  An `aligner` passed in carries its own device.
    """
    if aligner is None:
        resolve_device(device)
    if aligner_kind == "last" and protein:
        raise TaxtkError("the LAST pipeline is nucleotide-only")
    refpack = Refpack(refpack_dir, protein=protein)
    # version-pin check at workflow start (reference vendors its tools at
    # pinned versions, contrib/download.tsv; taxtk verifies the PATH
    # tools against the refpack's index-time record / the manifest and
    # warns on mismatch — a refpack indexed with one aligner version
    # must not silently classify with another)
    if alignments_file is None or orf_call:
        from .toolcheck import verify_external_tools

        tools = []
        if alignments_file is None:
            if aligner_kind == "last":
                tools.append("lastal")
            else:
                tools.append("blastp" if protein else "blastn")
        if orf_call:
            tools.append("orfm")
        verify_external_tools(tools, refpack_dir=refpack_dir)
    os.makedirs(outdir, exist_ok=True)
    with span("pipeline.taxonomy"):
        tax = refpack.load_taxonomy()
        tax_pruned = tax.prune_to_marked_ranks(DEFAULT_RANKS)
        mapping = load_seqid_taxid_mapping(refpack.mapping)

    # stage 0 (protein): ORF calling (binning-blast-protein.bash:84)
    orf_tool = None
    if orf_call:
        if not protein:
            raise TaxtkError("ORF calling requires the protein pipeline")
        from .orf import call_orfs_file

        faa = os.path.join(outdir, SAMPLE_NAME + ".faa")
        orf_tool = call_orfs_file(input_fasta, faa)
        input_fasta = faa

    # stage 1: candidate alignments
    aln_path = os.path.join(outdir, SAMPLE_NAME + ".alignments.gz")
    if alignments_file:
        src_open = gzip.open if alignments_file.endswith(".gz") else open
        with span("pipeline.archive"):
            with src_open(alignments_file, "rt") as src, \
                    gzip.open(aln_path, "wt") as dst:
                shutil.copyfileobj(src, dst)
    else:
        tmp = os.path.join(outdir, SAMPLE_NAME + ".alignments.tmp")
        if aligner_kind == "last":
            if protein:
                raise TaxtkError("the LAST pipeline is nucleotide-only")
            run_aligner_last(refpack, input_fasta, tmp, cores=cores)
        else:
            run_aligner_blast(refpack, input_fasta, tmp, cores=cores)
        with open(tmp) as src, gzip.open(aln_path, "wt") as dst:
            shutil.copyfileobj(src, dst)
        os.unlink(tmp)

    # stage 2: taxator (RPA).  Queries are served from the indexed on-disk
    # store (.fai built on first use): each task reads only its covered
    # range, so a config-5-scale query set (1M contigs) never needs to fit
    # in memory (reference indexed query access: sequencestorage.hh:319-406,
    # taxator -q/-v).  NOTE: like the reference's indexed store (and the
    # samtools .fai contract), query ids resolve by the FIRST whitespace
    # token of the header, and a .fai is written next to the input FASTA —
    # both intentional reference-parity changes from the old in-memory
    # full-header keying.
    with span("pipeline.stores"):
        query_store = IndexedFastaStore(input_fasta)
        db_store = IndexedFastaStore(refpack.refdata, refpack.refdata_index)

    def resolved():
        with gzip.open(aln_path, "rt") as fh:
            for _, rec in iter_alignment_records(fh):
                taxid = mapping.get(rec.reference_identifier)
                if taxid is None:
                    raise TaxtkError(
                        "bad taxon mapping for alignment reference sequence",
                        seqid=rec.reference_identifier,
                    )
                rec.reference_node = tax_pruned.node(taxid)
                yield rec

    engine = RpaEngine(
        tax_pruned,
        query_store,
        db_store,
        protein=protein,
        exclude_factor=speedup,
        macro_batch=macro_batch,
        aligner=aligner,
        device=device,
    )
    # stream GFF3 straight into an external `sort -k1,1` (the reference
    # pipeline's own reorder stage, binning-blast.bash:113): the engine
    # never buffers its output, sort spills to disk — RSS stays bounded at
    # config-4 scale (10k contigs).  The `##gff-version 3` header rides
    # through the sort and lands first under LC_ALL=C ('#' < [0-9A-Za-z]),
    # exactly like the reference pipeline keeps it.
    gff3_path = os.path.join(outdir, SAMPLE_NAME + ".gff3")
    engine_exc: list = []
    sort_exe = _which("sort")
    with open(gff3_path, "w") as fh:
        if sort_exe:
            env = dict(os.environ, LC_ALL="C")
            proc = subprocess.Popen(
                [sort_exe, "-k1,1", "-T", outdir],
                stdin=subprocess.PIPE, stdout=fh, text=True, env=env,
            )
            rsets = iter_record_sets(resolved(), True, False)
            try:
                with span("pipeline.engine"):
                    engine.run(rsets, proc.stdin)
            finally:
                with span("pipeline.sort"):
                    proc.stdin.close()
                    rc = proc.wait()
            if rc != 0:
                raise TaxtkError(f"sort failed with exit code {rc}")
        else:
            _sorted_fallback(engine, resolved, fh, outdir)

    # stage 3: binner
    binning_path = os.path.join(outdir, SAMPLE_NAME + ".binning")
    input_filename = os.path.basename(input_fasta)
    regex = glob_regex or ("([^_]+)_.*" if protein else "(.+)")
    with span("pipeline.binner"), open(gff3_path) as src, \
            open(binning_path, "w") as dst:
        run_binner(
            tax_pruned,
            [src],
            dst,
            sample_identifier=input_filename,
            glob_regex=regex,
        )

    # stage 4: summaries
    with span("pipeline.summaries"):
        paths = binning_to_summary(tax_pruned, binning_path, SAMPLE_NAME,
                                   outdir)
    paths.update(alignments=aln_path, gff3=gff3_path, binning=binning_path)
    if orf_tool is not None:
        paths.update(orfs=input_fasta, orf_tool=orf_tool)
    return paths

"""Copy of taxtk/cli/tools.py: the port keeps its own copy and imports nothing of taxtk.

Small companion tools (ports of reference extras).

  taxtk-tools strip-fasta-identifiers   truncate FASTA headers to the first
        token and enforce uniqueness (reference: extended/bin/
        fasta-strip-identifier:1-33)
  taxtk-tools alignments2blasttab       11-col alignments TSV -> BLAST
        12-col tabular (reference: core/extra/alignments2blasttab)
  taxtk-tools maf2alignments            LAST MAF -> alignments TSV
        (reference: extended/bin/lastmaf2alignments)
  taxtk-tools map-prot-dna              map protein-space alignments back to
        DNA coordinates via a gene GFF3 (reference: core/extra/
        map-alignments-prot-dna)
"""

from __future__ import annotations

import argparse
import sys

from ..formats.alignments import iter_alignment_records
from ..utils.errors import ParsingError


def strip_fasta_identifiers(instream, outstream) -> int:
    seen = set()
    for raw in instream:
        if raw.startswith(">"):
            ident = raw[1:].split()[0] if raw[1:].split() else ""
            if ident in seen:
                raise ParsingError("duplicate FASTA identifier", seqid=ident)
            seen.add(ident)
            outstream.write(">" + ident + "\n")
        else:
            outstream.write(raw if raw.endswith("\n") else raw + "\n")
    return len(seen)


def alignments_to_blasttab(instream, outstream) -> int:
    """qid sid pid alnlen mismatch gapopen qs qe ss se evalue bitscore.

    pid approximated as identities/alignment_length*100; mismatch/gapopen
    are not recoverable from the 11-col format and written as 0 (same
    information loss as the reference converter)."""
    n = 0
    for _, rec in iter_alignment_records(instream):
        pid = 100.0 * rec.identities / max(rec.alignment_length, 1)
        outstream.write(
            "\t".join(
                (
                    rec.query_identifier,
                    rec.reference_identifier,
                    f"{pid:.2f}",
                    str(rec.alignment_length),
                    "0",
                    "0",
                    str(rec.query_start),
                    str(rec.query_stop),
                    str(rec.reference_start),
                    str(rec.reference_stop),
                    "%g" % rec.evalue,
                    "%g" % float(rec.score),
                )
            )
            + "\n"
        )
        n += 1
    return n


def map_prot_dna(instream, outstream, gene_gff3: str) -> int:
    """Map ORF-space alignment coordinates back onto the source DNA using a
    gene GFF3 (seqid, start, end, strand per protein id)."""
    genes = {}
    with open(gene_gff3) as fh:
        for raw in fh:
            if raw.startswith("#") or not raw.strip():
                continue
            f = raw.rstrip("\n").split("\t")
            if len(f) < 9:
                continue
            attrs = dict(
                kv.split("=", 1) for kv in f[8].split(";") if "=" in kv
            )
            pid = attrs.get("ID") or attrs.get("protein_id")
            if pid:
                genes[pid] = (f[0], int(f[3]), int(f[4]), f[6])
    n = 0
    for _, rec in iter_alignment_records(instream):
        gene = genes.get(rec.query_identifier)
        if gene is None:
            continue
        dna_id, gstart, gend, strand = gene
        if strand == "+":
            qs = gstart + (rec.query_start - 1) * 3
            qe = gstart + rec.query_stop * 3 - 1
        else:
            qs = gend - rec.query_stop * 3 + 1
            qe = gend - (rec.query_start - 1) * 3
        rec.query_identifier = dna_id
        rec.query_start, rec.query_stop = min(qs, qe), max(qs, qe)
        rec.query_length = 0  # unknown at DNA scale without the source FASTA
        outstream.write(rec.print_line() + "\n")
        n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="taxtk-tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("strip-fasta-identifiers")
    sub.add_parser("alignments2blasttab")
    m = sub.add_parser("maf2alignments")
    m.add_argument("--protein", action="store_true")
    g = sub.add_parser("map-prot-dna")
    g.add_argument("gene_gff3")
    s = sub.add_parser("split-refpack")
    s.add_argument("fasta")
    s.add_argument("outdir")
    s.add_argument("-n", "--shards", type=int, required=True)
    s.add_argument("-g", "--mapping", default=None)
    s.add_argument("--index", action="store_true",
                   help="also build a .fai for each shard")
    sv = sub.add_parser(
        "serve-shard",
        help="serve a refpack shard's segment fetches over TCP "
        "(see taxtk.parallel.shardserver)",
    )
    sv.add_argument("fasta", help="shard FASTA (a .fai is built if missing)")
    sv.add_argument("--host", default="0.0.0.0")
    sv.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port (printed on stdout)")
    args = p.parse_args(argv)

    if args.cmd == "strip-fasta-identifiers":
        try:
            strip_fasta_identifiers(sys.stdin, sys.stdout)
        except ParsingError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    elif args.cmd == "alignments2blasttab":
        alignments_to_blasttab(sys.stdin, sys.stdout)
    elif args.cmd == "maf2alignments":
        from ..pipeline.maf import convert_maf

        convert_maf(sys.stdin, sys.stdout, protein=args.protein)
    elif args.cmd == "map-prot-dna":
        map_prot_dna(sys.stdin, sys.stdout, args.gene_gff3)
    elif args.cmd == "split-refpack":
        from ..parallel.refpack import split_refpack

        if args.shards < 1:
            print("error: --shards must be >= 1", file=sys.stderr)
            return 1
        try:
            parts = split_refpack(
                args.fasta, args.shards, args.outdir, mapping_path=args.mapping
            )
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        for fa, mp in parts:
            if args.index:
                from ..refpack.store import FaiIndex

                FaiIndex.build(fa).save(fa + ".fai")
            print(fa if mp is None else f"{fa}\t{mp}")
    elif args.cmd == "serve-shard":
        from ..parallel.shardserver import ShardServer
        from ..refpack.store import IndexedFastaStore

        store = IndexedFastaStore(args.fasta)
        server = ShardServer(store, host=args.host, port=args.port)
        print(f"{server.port}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Port of taxtk/cli/taxator.py: the taxator CLI on PyTorch and CUDA.

    python -m taxtk_torch.cli.taxator [flags] < alignments > out.gff3

Same flags and the same GFF3 bytes as taxtk's taxator.  The DNA backends
are myers-cuda (the hand-written Myers kernels; the default), myers (their
plain PyTorch versions), native (host C++), wavefront-cuda (the min-plus
wavefront kernel) and wavefront (its plain version); protein mode (-b protein)
has wavefront-cuda (the BLOSUM62 wavefront kernels; the default) and
wavefront (the plain recurrence).  taxtk's names myers-pallas and
wavefront-pallas are taken for myers-cuda and wavefront-cuda.  --device
picks the card (cuda, the default) or the CPU.

--mesh DPxTP shards the engine over a grid of DP x TP devices (pairs split
over dp, candidates over tp by refpack shard, the pass-0 reductions merged
across the grid; parallel/engine_mesh.py).  With --device cuda the grid
takes cuda:0 ... cuda:{DP*TP-1} and stops with an error when fewer cards
are visible (no fallback to the CPU); with --device cpu every cell is the
CPU.


Flags, defaults and the stdin->stdout text contract follow the reference
(reference: core/taxator.cpp:256-387): alignments TSV on stdin, GFF3 on
stdout.  The compute path is the TPU-batched RPA engine instead of the
producer/consumer thread pool; `-p` is accepted for compatibility (device
batching replaces host threads).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..constants import DEFAULT_RANKS, PROGRAM_VERSION, CITATION_NOTE
from ..native.parse import iter_alignment_records_fast
from ..formats.gff3 import PredictionRecord, GFF3_HEADER
from ..formats.mapping import load_seqid_taxid_mapping
from ..engine.recordsets import iter_record_sets
from ..engine.executor import RpaEngine
from ..models.lca import (
    DummyPredictionModel,
    LCASimplePredictionModel,
    MeganLCAPredictionModel,
    NBestLCAPredictionModel,
)
from ..refpack.store import (
    IndexedFastaStore,
    InMemoryFastaStore,
    load_identifier_whitelist,
)
from ..taxonomy.flat import load_taxonomy_from_environment
from ..utils.errors import TaxtkError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="taxtk-taxator",
        description="taxonomic assignment of query sequence segments (RPA)",
    )
    p.add_argument("--citation", action="store_true")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-a", "--algorithm", default="rpa")
    p.add_argument("-g", "--seqid-taxid-mapping")
    p.add_argument("-q", "--query-sequences")
    p.add_argument("-v", "--query-sequences-index")
    # -f/-i may be REPEATED to serve the database from refpack shards
    # (see taxtk.parallel.refpack / `taxtk-tools split-refpack`); the
    # reference accepts exactly one of each (core/taxator.cpp:283-286)
    p.add_argument("-f", "--ref-sequences", action="append")
    p.add_argument("-i", "--ref-sequences-index", action="append")
    p.add_argument("-p", "--processors", type=int, default=1)
    p.add_argument("-l", "--logfile", default="/dev/null")
    p.add_argument("-b", "--dataformat", default="nucleotide")
    # advanced options (reference hidden group, taxator.cpp:281-294)
    p.add_argument("-r", "--ranks", nargs="*", default=None)
    p.add_argument("-s", "--split-alignments", type=_boolarg, default=True)
    p.add_argument("-o", "--alignments-sorted", type=_boolarg, default=False)
    p.add_argument("-d", "--delete-notranks", type=_boolarg, default=True)
    p.add_argument("-x", "--heuristic-cutoff", type=float, default=0.5)
    p.add_argument("-t", "--toppercent", type=float, default=0.05)
    p.add_argument("-e", "--max-evalue", type=float, default=1000.0)
    p.add_argument("-c", "--min-support", type=int, default=1)
    p.add_argument("-m", "--minscore", type=float, default=0.0)
    p.add_argument("-n", "--nbest", type=int, default=1)
    p.add_argument("-u", "--ignore-unclassified", action="store_true")
    p.add_argument("-w", "--db-whitelist")
    p.add_argument("--macro-batch", type=int, default=None)
    p.add_argument("--profile", metavar="TRACE_DIR",
                   help="write a torch.profiler trace of the run "
                        "(trace.json) and its spans (spans.jsonl)")
    p.add_argument("--dna-backend",
                   choices=["myers-cuda", "myers", "native", "wavefront-cuda",
                            "wavefront", "myers-pallas"],
                   help="alignment kernel backend (default: myers-cuda on "
                        "cuda, myers on cpu); wavefront-cuda and wavefront "
                        "are the min-plus DP kernel and its plain version; "
                        "myers-pallas, taxtk's name, is myers-cuda")
    p.add_argument("--protein-backend",
                   choices=["wavefront-cuda", "wavefront", "wavefront-pallas"],
                   help="protein kernel backend (default: wavefront-cuda on "
                        "cuda, wavefront on cpu); wavefront-pallas, taxtk's "
                        "name, is wavefront-cuda")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device for the alignment kernels (default: cuda)")
    p.add_argument("--stats", action="store_true",
                   help="print run metrics and span totals to stderr "
                        "when done")
    p.add_argument("--mesh", metavar="DPxTP",
                   help="shard the engine over a DPxTP device mesh: pair "
                        "batches split over dp, candidates over tp (refpack "
                        "shards) with collective pass-0 merge")
    return p


def _boolarg(v: str) -> bool:
    return v not in ("0", "false", "False", "no")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(PROGRAM_VERSION)
        return 0
    if args.citation:
        print(CITATION_NOTE)
        return 0

    ranks = args.ranks if args.ranks else list(DEFAULT_RANKS)

    if not args.seqid_taxid_mapping:
        print("Specify a taxonomy mapping file for the reference sequence identifiers")
        return 1

    tax = load_taxonomy_from_environment(ranks)
    if tax is None:
        return 1
    if args.delete_notranks:
        tax = tax.prune_to_marked_ranks(ranks)

    seqid2taxid = load_seqid_taxid_mapping(args.seqid_taxid_mapping)

    try:
        records = _resolved_records(sys.stdin, seqid2taxid, tax)
        rsets = iter_record_sets(records, args.split_alignments, args.alignments_sorted)

        if args.algorithm == "rpa":
            if args.dataformat not in ("nucleotide", "protein"):
                print("data format can either be nucleotide or protein")
                return 1
            protein = args.dataformat == "protein"
            query_store = _open_store(
                args.query_sequences, args.query_sequences_index, None
            )
            whitelist = (
                load_identifier_whitelist(args.db_whitelist)
                if args.db_whitelist
                else None
            )
            db_store = _open_db_store(
                args.ref_sequences, args.ref_sequences_index, whitelist
            )
            logsink = None
            if args.logfile and args.logfile != "/dev/null":
                logsink = open(args.logfile, "a")
            try:
                from ..engine.aligner import BatchAligner

                mesh = (_make_mesh(args.mesh, args.device) if args.mesh
                        else None)
                aligner = BatchAligner(
                    "protein" if protein else "dna",
                    dna_backend=args.dna_backend,
                    protein_backend=args.protein_backend,
                    device=args.device,
                )
                engine = RpaEngine(
                    tax,
                    query_store,
                    db_store,
                    protein=protein,
                    exclude_factor=args.heuristic_cutoff,
                    toppercent=args.toppercent,
                    macro_batch=args.macro_batch,
                    logsink=logsink,
                    aligner=aligner,
                    mesh=mesh,
                )
                from ..engine import metrics

                # --stats and --profile keep the program's spans
                tracing = bool(args.stats or args.profile)
                if tracing:
                    metrics.start_tracing()
                try:
                    with metrics.profile(args.profile):
                        engine.run(rsets, sys.stdout)
                finally:
                    if tracing:
                        metrics.stop_tracing()
                        kept = metrics.drain()
                if args.profile:
                    metrics.write_spans(
                        os.path.join(args.profile, "spans.jsonl"),
                        kept["spans"])
                if args.stats:
                    engine.metrics.report()
                    print(f"taxtk_torch aligner: {json.dumps(aligner.stats())}",
                          file=sys.stderr)
                    print(metrics.format_totals(kept["spans"],
                                                kept["counts"]),
                          file=sys.stderr)
            finally:
                if logsink is not None:
                    logsink.close()
        elif args.algorithm in ("dummy", "simple-lca", "megan-lca", "ic-megan-lca", "n-best-lca"):
            model = _make_lca_model(args, tax)
            sys.stdout.write(GFF3_HEADER + "\n")
            prec = PredictionRecord(tax)  # persistent (serial-mode parity)
            for rset in rsets:
                model.predict(rset, prec)
                sys.stdout.write(prec.print_line() + "\n")
        else:
            print(
                "classification algorithm can either be: rpa (default), "
                "simple-lca, megan-lca, ic-megan-lca, n-best-lca"
            )
            return 1
        return 0
    except TaxtkError as e:
        print(f"An unrecoverable error occurred: {e}", file=sys.stderr)
        return 1


def _make_mesh(spec: str, device: str):
    """'DPxTP' -> a Mesh over the first DP*TP devices of `device`: the
    cards cuda:0 ... for cuda (an error when fewer are visible), the CPU
    named DP*TP times for cpu."""
    import torch

    from ..parallel.mesh import make_mesh

    try:
        dp_s, tp_s = spec.lower().split("x")
        dp, tp = int(dp_s), int(tp_s)
        if dp < 1 or tp < 1:
            raise ValueError
    except ValueError:
        raise TaxtkError(f"bad --mesh spec {spec!r}; expected DPxTP, e.g. 4x2")
    n = dp * tp
    if device == "cpu":
        devices = [torch.device("cpu")] * n
    else:
        k = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(k)]
    if len(devices) < n:
        raise TaxtkError(
            f"--mesh {spec} needs {n} devices; {len(devices)} available"
        )
    return make_mesh(n, tp=tp, devices=devices)


def _make_lca_model(args, tax):
    if args.algorithm == "dummy":
        return DummyPredictionModel(tax)
    if args.algorithm == "simple-lca":
        return LCASimplePredictionModel(tax)
    if args.algorithm in ("megan-lca", "ic-megan-lca"):
        return MeganLCAPredictionModel(
            tax,
            ignore_unclassified=args.ignore_unclassified,
            toppercent=args.toppercent,
            minscore=args.minscore,
            minsupport=args.min_support,
            maxevalue=args.max_evalue,
        )
    return NBestLCAPredictionModel(tax, args.nbest)


def _open_store(fasta, index, whitelist):
    if fasta is None:
        raise TaxtkError("missing FASTA file argument")
    if index:
        return IndexedFastaStore(fasta, index)
    return InMemoryFastaStore(fasta, whitelist)


def _open_db_store(fastas, indexes, whitelist):
    """One `-f` -> plain store; repeated `-f` -> hash-routed shard stores
    (each `-i` pairs with the `-f` at the same position)."""
    if not fastas:
        raise TaxtkError("missing FASTA file argument")
    if indexes and len(indexes) not in (0, len(fastas)):
        raise TaxtkError("need one -i per -f (or none)")
    stores = [
        _open_store(fa, indexes[k] if indexes else None, whitelist)
        for k, fa in enumerate(fastas)
    ]
    if len(stores) == 1:
        return stores[0]
    from ..parallel.refpack import ShardedRefpackStore

    return ShardedRefpackStore(stores)


def _resolved_records(stream, seqid2taxid, tax):
    """AlignmentRecordTaxonomy analog: resolve the reference taxon at parse
    time; unknown mappings/taxa are fatal (reference: alignmentrecord.hh:211-228).

    Uses the native columnar parser (taxtk/native/io.cpp) with transparent
    fallback to the Python line parser."""
    for _, rec in iter_alignment_records_fast(stream):
        taxid = seqid2taxid.get(rec.reference_identifier)
        if taxid is None:
            raise TaxtkError(
                "bad taxon mapping for alignment reference sequence",
                seqid=rec.reference_identifier,
            )
        rec.reference_node = tax.node(taxid)
        yield rec


if __name__ == "__main__":
    sys.exit(main())

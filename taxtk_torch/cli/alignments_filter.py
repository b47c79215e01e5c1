"""Copy of taxtk/cli/alignments_filter.py: the port keeps its own copy and imports nothing of taxtk.

taxtk-alignments-filter — drop-in equivalent of `alignments-filter`
(reference: core/alignments-filter.cpp:80-172): alignments TSV on stdin,
filtered/masked TSV on stdout; filter chain assembled from the flags in the
reference's order (:131-164).
"""

from __future__ import annotations

import argparse
import sys

from ..constants import PROGRAM_VERSION
from ..native.parse import iter_alignment_records_fast
from ..formats.mapping import load_seqid_taxid_mapping
from ..engine.recordsets import iter_record_sets
from ..engine.filters import (
    SortFilter,
    MinPIDFilter,
    MinScoreTopPercentFilter,
    MaxEvalueMinScoreTopPercentFilter,
    MinSupportFilter,
    NumBestBitscoreFilter,
    BestScorePerReferenceSeqIDFilter,
    TaxonMaskingFilter,
)
from ..utils.errors import TaxtkError


def build_parser():
    p = argparse.ArgumentParser(prog="taxtk-alignments-filter")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-m", "--min-score", type=float, default=0.0)
    p.add_argument("-p", "--min-pid", type=float, default=0.0)
    p.add_argument("-t", "--top-percent", type=float, default=1.0)
    p.add_argument("-e", "--max-evalue", type=float, default=-1.0)
    p.add_argument("-b", "--best-alignments", type=int, default=0)
    p.add_argument("-s", "--sort-score", action="store_true")
    p.add_argument("-k", "--keep-best-per-ref", action="store_true")
    # extension beyond the reference CLI: alignmentsfilter.hh:577 exists in
    # the reference library but is wired to no binary; needs -y mapping
    p.add_argument("--keep-best-per-taxid", action="store_true")
    p.add_argument("-c", "--min-support", type=int, default=1)
    p.add_argument("-r", "--remove-ref-from-query-taxon", action="store_true")
    p.add_argument("-x", "--taxon-mapping-sample")
    p.add_argument("-y", "--taxon-mapping-reference")
    p.add_argument("-z", "--mask-by-star", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(PROGRAM_VERSION)
        return 0

    filters = []
    if args.remove_ref_from_query_taxon:
        if not args.taxon_mapping_sample or not args.taxon_mapping_reference:
            print(
                "'--remove-ref-from-query-taxon' requires two mapping files: "
                "'--taxon-mapping-sample' and '--taxon-mapping-reference'"
            )
            return 0  # reference exits EXIT_SUCCESS here (:135)
        filters.append(
            TaxonMaskingFilter(
                load_seqid_taxid_mapping(args.taxon_mapping_sample),
                load_seqid_taxid_mapping(args.taxon_mapping_reference),
            )
        )
    if args.keep_best_per_ref:
        filters.append(BestScorePerReferenceSeqIDFilter())
    if args.keep_best_per_taxid:
        if not args.taxon_mapping_reference:
            print(
                "'--keep-best-per-taxid' requires '--taxon-mapping-reference'"
            )
            return 0
        from ..engine.filters import BestScorePerReferenceTaxIDFilter

        refmap = load_seqid_taxid_mapping(args.taxon_mapping_reference)
        filters.append(
            BestScorePerReferenceTaxIDFilter(
                key=lambda r: refmap[r.reference_identifier]
            )
        )
    if args.sort_score:
        filters.append(SortFilter())
    if args.min_pid > 0.0:
        filters.append(MinPIDFilter(args.min_pid))
    if args.max_evalue > 0:
        filters.append(
            MaxEvalueMinScoreTopPercentFilter(
                args.min_score, args.top_percent, args.max_evalue
            )
        )
    elif args.min_score or args.top_percent != 1.0:
        filters.append(MinScoreTopPercentFilter(args.min_score, args.top_percent))
    if args.best_alignments:
        filters.append(NumBestBitscoreFilter(args.best_alignments))
    if args.min_support:
        filters.append(MinSupportFilter(args.min_support))

    try:
        records = (rec for _, rec in iter_alignment_records_fast(sys.stdin))
        for rset in iter_record_sets(records, split_alignments=False):
            for f in filters:
                f.filter(rset)
            for rec in rset:
                if not rec.masked or args.mask_by_star:
                    sys.stdout.write(rec.print_line() + "\n")
        return 0
    except TaxtkError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

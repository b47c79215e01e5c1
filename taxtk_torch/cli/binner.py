"""Copy of taxtk/cli/binner.py: the port keeps its own copy and imports nothing of taxtk.

taxtk-binner — drop-in CLI equivalent of the reference `binner` binary
(reference: core/binner.cpp:56-346): GFF3 on stdin/files, bioboxes on stdout.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..constants import DEFAULT_RANKS, PROGRAM_VERSION, CITATION_NOTE
from ..binning.binner import run_binner
from ..taxonomy.flat import load_taxonomy_from_environment
from ..utils.errors import TaxtkError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="taxtk-binner", description="consensus binning of segment predictions"
    )
    p.add_argument("--citation", action="store_true")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-n", "--sample-identifier", required=False)
    p.add_argument("-g", "--glob-identifier", default="(.+)")
    p.add_argument("-s", "--sequence-min-support", type=int, default=50)
    p.add_argument("-j", "--signal-majority", type=float, default=0.7)
    p.add_argument("-i", "--identity-constrain", action="append", default=[])
    p.add_argument("-f", "--files", nargs="*", default=[])
    p.add_argument("-l", "--logfile", default="binning.log")
    # hidden options (binner.cpp:81-86)
    p.add_argument("-r", "--ranks", nargs="*", default=None)
    p.add_argument("-m", "--sample-min-support", default="0")
    p.add_argument("-d", "--delete-notranks", type=_boolarg, default=True)
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
    if not args.sample_identifier:
        print("the following arguments are required: -n/--sample-identifier", file=sys.stderr)
        return 1

    ranks = args.ranks if args.ranks else list(DEFAULT_RANKS)
    tax = load_taxonomy_from_environment(ranks)
    if tax is None:
        return 1
    if ranks and args.delete_notranks:
        tax = tax.prune_to_marked_ranks(ranks)

    constraints = {}
    for item in args.identity_constrain:
        rank, _, value = item.partition(":")
        if not rank:
            print(
                "Could not read identity constrain: rank cannot be empty string, "
                'use e.g. "-i species:0.8"',
                file=sys.stderr,
            )
            return 1
        try:
            constraints[rank] = float(value)
        except ValueError:
            print(
                f'Could not read identity constrain: "{value}" for rank "{rank}" '
                'as float, use e.g. "-i species:0.8"',
                file=sys.stderr,
            )
            return 1

    streams = []
    opened = []
    try:
        if not args.files:
            streams.append(sys.stdin)
        else:
            for f in args.files:
                if f == "-":
                    streams.append(sys.stdin)
                elif os.path.exists(f):
                    fh = open(f, "r")
                    opened.append(fh)
                    streams.append(fh)
                else:
                    print(f'Could not read file "{f}"', file=sys.stderr)
                    return 1

        log = open(args.logfile, "w") if args.logfile else None
        try:
            run_binner(
                tax,
                streams,
                sys.stdout,
                sample_identifier=args.sample_identifier,
                glob_regex=args.glob_identifier,
                min_support_per_sequence=args.sequence_min_support,
                signal_majority_per_sequence=args.signal_majority,
                min_support_in_sample=args.sample_min_support,
                identity_constraints=constraints,
                log=log,
            )
        finally:
            if log:
                log.close()
        return 0
    except TaxtkError as e:
        print("An unrecoverable error occurred.", file=sys.stderr)
        print(str(e), file=sys.stderr)
        return 1
    finally:
        for fh in opened:
            fh.close()


if __name__ == "__main__":
    sys.exit(main())

"""Copy of taxtk/cli/taxknife.py: the port keeps its own copy and imports nothing of taxtk.

taxtk-taxknife — drop-in equivalent of the reference `taxknife` utility
(reference: core/taxknife.cpp:41-464): line-oriented taxid processing with
modes traverse / annotate (name|rank|path|taxid-path) / tree.

Operates on the FULL taxonomy (the reference never prunes here); default
ranks mark the major ranks for path output.
"""

from __future__ import annotations

import argparse
import sys

from ..constants import DEFAULT_RANKS, PROGRAM_VERSION, FIELD_SEPARATOR
from ..taxonomy.flat import load_taxonomy_from_environment
from ..taxonomy.newick import NewickBuilder
from ..utils.errors import TaxonNotFound
from ..utils.tokenize import tokenize_single_char, ignore_line


def build_parser():
    p = argparse.ArgumentParser(prog="taxtk-taxknife")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-m", "--mode", default="annotate", nargs="?")
    p.add_argument("mode_positional", nargs="*", default=[])
    p.add_argument("-f", "--field", type=int, default=1)
    # traverse mode
    p.add_argument("-k", "--keep-not-rank", action="store_true")
    p.add_argument("-t", "--keep-not-taxid", action="store_true")
    p.add_argument("-b", "--set-invalid-traverse")
    p.add_argument("-r", "--traverse-ranks", nargs="*", default=None)
    # annotate mode
    p.add_argument("-a", "--allnodes", action="store_true")
    p.add_argument("-c", "--set-invalid-annotate")
    p.add_argument("-s", "--show", default="name")
    p.add_argument("-n", "--name-ranks", nargs="*", default=None)
    # tree mode
    p.add_argument("-q", "--tree-ranks", nargs="*", default=None)
    p.add_argument("-o", "--outfile", default="tree.newick")
    p.add_argument("-i", "--fill-intermediate", action="store_true")
    p.add_argument("-v", "--names", action="store_true")
    return p


def _iter_lines_with_fields(stream, field_pos):
    """Yields (prefix, field_value, suffix_fields) per non-comment line."""
    for raw in stream:
        line = raw.rstrip("\n")
        if ignore_line(line):
            continue
        fields = tokenize_single_char(line, FIELD_SEPARATOR, field_pos)
        if len(fields) < field_pos:
            continue
        prefix = "".join(f + FIELD_SEPARATOR for f in fields[: field_pos - 1])
        value = fields[field_pos - 1]
        rest = fields[field_pos:]
        yield prefix, value, rest


def _suffix(rest):
    # the tokenizer's always-appended remainder token reproduces the
    # reference's trailing separator on delimiter-less lines (utils.hh:77)
    return "".join(FIELD_SEPARATOR + f for f in rest)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(PROGRAM_VERSION)
        return 0
    operation = args.mode_positional[0] if args.mode_positional else args.mode
    if args.field < 1:
        print("Field number index is 1-based", file=sys.stderr)
        return 1

    tax = load_taxonomy_from_environment(DEFAULT_RANKS)
    if tax is None:
        return 1

    if operation == "traverse":
        return _mode_traverse(args, tax)
    if operation == "annotate":
        return _mode_annotate(args, tax)
    if operation == "tree":
        return _mode_tree(args, tax)
    print(f"unknown operation mode '{operation}' for --mode / -m", file=sys.stderr)
    return 0


def _mode_traverse(args, tax) -> int:
    """reference: taxknife.cpp:107-182"""
    rank_names = args.traverse_ranks or []
    ranks = set()
    for r in rank_names:
        if tax.rank_index(r) < 0:
            print(
                f"Rank '{r}' not found in taxonomy, not using for mapping.",
                file=sys.stderr,
            )
        else:
            ranks.add(r)
    for prefix, value, rest in _iter_lines_with_fields(sys.stdin, args.field):
        try:
            node = tax.node(value)
        except TaxonNotFound:
            msg = f"Could not find node with taxid {value} in the taxonomy"
            if not args.keep_not_taxid:
                print(msg + ", skipping record.", file=sys.stderr)
                continue
            print(msg + ".", file=sys.stderr)
            out = args.set_invalid_traverse if args.set_invalid_traverse else value
            sys.stdout.write(prefix + out + _suffix(rest) + "\n")
            continue
        while node != tax.ROOT and tax.rank_of(node) not in ranks:
            node = int(tax.parent[node])
        if args.keep_not_rank and node == tax.ROOT:
            out = args.set_invalid_traverse if args.set_invalid_traverse else value
        else:
            out = tax.taxid_of(node)
        sys.stdout.write(prefix + out + _suffix(rest) + "\n")
    return 0


def _mode_annotate(args, tax) -> int:
    """reference: taxknife.cpp:184-415"""
    show = args.show
    if show not in ("name", "rank", "path", "taxid-path"):
        print("unknown parameter for --show / -s", file=sys.stderr)
        return 1
    replace = args.set_invalid_annotate

    for prefix, value, rest in _iter_lines_with_fields(sys.stdin, args.field):
        try:
            node = tax.node(value)
        except TaxonNotFound:
            print(
                f"Could not find node with taxonomic id {value} in taxonomy",
                file=sys.stderr,
            )
            if replace is not None:
                sys.stdout.write(prefix + replace + _suffix(rest) + "\n")
            continue
        if show == "name":
            out = tax.name_of(node)
        elif show == "rank":
            out = tax.rank_of(node)
        else:
            # path / taxid-path: walk root -> node, selected ranks only
            # (or all nodes with -a); reference :288-410
            chain = tax.path_down(node)
            parts = []
            for c in chain:
                keep = args.allnodes or tax.rank_of(c) in DEFAULT_RANKS
                if keep:
                    parts.append(tax.name_of(c) if show == "path" else tax.taxid_of(c))
            out = ";".join(parts)
        sys.stdout.write(prefix + out + _suffix(rest) + "\n")
    return 0


def _mode_tree(args, tax) -> int:
    """reference: taxknife.cpp:416-455"""
    builder = NewickBuilder(
        tax,
        args.tree_ranks or [],
        show_names=args.names,
        fill_empty_ranks=args.fill_intermediate,
    )
    for prefix, value, rest in _iter_lines_with_fields(sys.stdin, args.field):
        builder.add(value)
        sys.stdout.write(prefix + value + _suffix(rest) + "\n")
    with open(args.outfile, "w") as fh:
        fh.write(builder.build())
    return 0


if __name__ == "__main__":
    sys.exit(main())

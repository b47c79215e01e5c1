"""Copy of taxtk/binning/binner.py: the port keeps its own copy and imports nothing of taxtk.

Sample-wide consensus binning: GFF3 segment predictions -> bioboxes.

Port of the binner program (reference: core/binner.cpp:56-346):
  STEP 0  group records by a regex capture on the query identifier
  STEP 1  sample-wide support accounting + low-support range pruning
  STEP 2  per-group consensus (combine_prediction_ranges) + identity
          constraints + bioboxes output

Output group order is first appearance in the input (the reference iterates
an unordered_map, so its order is hash-dependent; contents are identical).
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional, TextIO

from ..constants import BIOBOXES_FORMAT_VERSION, PROGRAM_VERSION
from ..formats.gff3 import PredictionRecord, iter_prediction_records
from ..taxonomy.flat import FlatTaxonomy
from .consensus import combine_prediction_ranges


def extract_regex(text: str, regex: Optional[re.Pattern]) -> str:
    # empty regex = full globbing (reference: binner.cpp:45-54)
    if regex is None or regex.pattern == "":
        return "consensus_sequence"
    m = regex.match(text)
    assert m is not None and m.group(1) != ""
    return m.group(1)


def write_bioboxes_header(
    out: TextIO,
    sample_identifier: str,
    taxonomy_version: str,
    custom_tag_prefix: str = "TaxatorTK",
):
    """reference: bioboxes.cpp:4-67"""
    out.write("# This is the bioboxes.org binning output format at\n")
    out.write("# https://github.com/bioboxes/rfc/tree/master/data-format\n\n")
    out.write(f"@Version:{BIOBOXES_FORMAT_VERSION}\n")
    out.write(f"@SampleID:{sample_identifier}\n")
    if taxonomy_version:
        out.write(f"@TaxonomyID:{taxonomy_version}\n")
    out.write(f"@_{custom_tag_prefix}_Version:{PROGRAM_VERSION}\n")
    out.write("\n")
    out.write(
        f"@@SequenceID\tTaxID\t_{custom_tag_prefix}_Support\t_{custom_tag_prefix}_Length\n"
    )


def run_binner(
    tax: FlatTaxonomy,
    streams: List[TextIO],
    out: TextIO,
    sample_identifier: str,
    glob_regex: str = "(.+)",
    min_support_per_sequence: int = 50,
    signal_majority_per_sequence: float = 0.7,
    min_support_in_sample: str = "0",
    identity_constraints: Optional[Dict[str, float]] = None,
    log: Optional[TextIO] = None,
) -> None:
    regex = re.compile(glob_regex) if glob_regex else None

    # interpret sample support: int >= 1 or fraction < 1 (binner.cpp:122-123)
    if "." in min_support_in_sample:
        min_support_abs = 0
        min_support_pct = float(min_support_in_sample)
    else:
        min_support_abs = int(min_support_in_sample)
        min_support_pct = 0.0

    # STEP 0: parse + group (binner.cpp:154-209)
    groups: Dict[str, List[PredictionRecord]] = {}
    order: List[str] = []
    for stream in streams:
        for rec in iter_prediction_records(stream, tax):
            name = extract_regex(rec.query_identifier, regex)
            if name not in groups:
                groups[name] = []
                order.append(name)
            groups[name].append(rec)

    # STEP 1: sample-wide support accounting (binner.cpp:216-250)
    print("Analyzing sample composition: ", end="", file=sys.stderr)
    support: Dict[int, int] = {}
    minimum_support_found = float("inf")
    root = tax.ROOT
    total_records = 0
    for name in order:
        for rec in groups[name]:
            total_records += 1
            chain = tax.path_up(rec.lower_node)  # lower -> root
            running = rec.get_support_at_node(rec.lower_node)
            minimum_support_found = min(minimum_support_found, running)
            support[chain[0]] = support.get(chain[0], 0) + running
            for node in chain[1:]:
                running = max(running, rec.get_support_at_node(node))
                support[node] = support.get(node, 0) + running
    root_support = support.get(root, 0)
    print(
        f"{len(support)} nested taxa with total support of {root_support} positions",
        file=sys.stderr,
    )

    if min_support_pct:
        min_support_abs = int(root_support * min_support_pct)

    # noise removal (binner.cpp:255-282)
    print("Noise removal: ", end="", file=sys.stderr)
    pruned_nodes = set()
    if minimum_support_found < min_support_abs:
        for name in order:
            records = groups[name]
            kept: List[PredictionRecord] = []
            for rec in records:
                chain = tax.path_up(rec.lower_node)
                k = 0
                while (
                    chain[k] != rec.upper_node
                    and support.get(chain[k], 0) < min_support_abs
                ):
                    pruned_nodes.add(chain[k])
                    k += 1
                if (
                    chain[k] == rec.upper_node
                    and support.get(chain[k], 0) < min_support_abs
                ):
                    pruned_nodes.add(chain[k])
                    continue  # remove whole range
                if chain[k] != rec.lower_node:
                    rec.prune_lower_node(chain[k])
                kept.append(rec)
            groups[name] = kept
    print(f"{len(pruned_nodes)} taxa removed", file=sys.stderr)

    # STEP 2: consensus + output (binner.cpp:284-338)
    print("Consensus taxonomy assignment: ", end="", file=sys.stderr)
    write_bioboxes_header(out, sample_identifier, tax.version)
    constraints = identity_constraints or {}
    for name in order:
        records = groups[name]
        if not records:
            continue
        if len(records) > 1:
            prec = combine_prediction_ranges(
                records,
                name,
                tax,
                signal_majority_per_sequence,
                min_support_per_sequence,
                log,
            )
        else:
            prec = records[0]

        if prec.upper_node != root and constraints:
            seqlen = float(prec.query_length)
            min_pid = 0.0
            predict_node = root
            target = prec.upper_node
            rank_pid = prec.get_support_at_node(target) / seqlen
            chain = tax.path_down(target)  # root -> target
            k = 0
            while True:
                k += 1
                node = chain[k]
                rank = tax.rank_of(node)
                if rank in constraints:
                    min_pid = max(min_pid, constraints[rank])
                if log is not None:
                    log.write(f"constraint ctrl: {rank_pid} >= {min_pid} ?\n")
                if rank_pid < min_pid:
                    break
                predict_node = node
                if node == target:
                    break
            out.write(
                f"{name}\t{tax.taxid_of(predict_node)}"
                f"\t{prec.get_support_at_node(predict_node)}\t{prec.query_length}\n"
            )
        else:
            out.write(
                f"{name}\t{tax.taxid_of(prec.upper_node)}"
                f"\t{prec.get_support_at_node(prec.upper_node)}\t{prec.query_length}\n"
            )
    print(" done", file=sys.stderr)

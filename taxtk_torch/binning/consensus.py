"""Copy of taxtk/binning/consensus.py: the port keeps its own copy and imports nothing of taxtk.

Consensus combination of per-segment taxon ranges.

Port of combinePredictionRanges (reference: core/src/predictionranges.hh:
117-266): all segment ranges walk their root->lower paths in lock-step; at
each level, diverging paths are reduced to the majority branch (by summed
total support); the result is either the deepest node whose *direct* support
clears the threshold ("direct" mode) or the deepest node whose *total*
support does ("fallback" mode).

Arithmetic parity: the reference accumulates support in
medium_unsigned_int (= uint16, types.hh:35), so support sums WRAP at 65536
and the threshold cast truncates — reproduced here with explicit masking.
"""

from __future__ import annotations

from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from ..formats.gff3 import PredictionRecord, BINNING_DIRECT, BINNING_FALLBACK
from ..taxonomy.flat import FlatTaxonomy

U16 = 0xFFFF


def combine_prediction_ranges(
    records: List[PredictionRecord],
    identifier: str,
    tax: FlatTaxonomy,
    min_signal_percentage: float,
    min_support: int,
    debug_output: Optional[TextIO] = None,
) -> PredictionRecord:
    assert len(records) > 1

    # per-record root->lower path with uint16 direct/total support vectors
    paths: List[List[int]] = []
    direct_vecs: List[List[int]] = []
    total_vecs: List[List[int]] = []
    summed_support = 0
    summed_length = 0
    seen_ids = set()
    for rec in records:
        lower = rec.lower_node
        depth = int(tax.depth[lower])
        support = rec.get_support_at(depth) & U16
        summed_support = (summed_support + support) & U16
        if rec.query_identifier not in seen_ids:
            seen_ids.add(rec.query_identifier)
            summed_length += rec.query_length
        direct = [rec.get_support_at(d) & U16 for d in range(depth + 1)]
        total = list(direct)
        for d in range(depth - 1, -1, -1):
            total[d] = max(total[d + 1], direct[d])
        paths.append(tax.path_down(lower))
        direct_vecs.append(direct)
        total_vecs.append(total)

    prec = PredictionRecord(tax)
    prec.query_identifier = identifier
    prec.query_length = summed_length
    prec.query_feature_begin = 1
    prec.query_feature_end = summed_length

    # threshold: float -> uint16 truncation quirk (predictionranges.hh:165)
    thresh_f = float(np.float32(min_signal_percentage) * summed_support)
    direct_support_thresh = max(int(thresh_f) & U16, min_support & U16)

    # lock-step walk; tuple state = (path, direct, total, pos)
    tlist = list(range(len(records)))
    pos = {k: 0 for k in tlist}

    def get_support() -> Tuple[int, int]:
        d = 0
        t = 0
        for k in tlist:
            p = pos[k]
            d = (d + direct_vecs[k][p]) & U16
            t = (t + total_vecs[k][p]) & U16
        return d, t

    def ended(k) -> bool:
        return pos[k] == len(direct_vecs[k]) - 1

    def reduce_to_majority() -> bool:
        # (predictionranges.hh:78-112) keep tuples on the max-total branch;
        # first node to reach the maximum wins ties
        nonlocal tlist
        if len(tlist) < 2:
            return False
        supports: Dict[int, float] = {}
        max_node = None
        max_support = 0.0
        for k in tlist:
            node = paths[k][pos[k]]
            supports[node] = supports.get(node, 0.0) + total_vecs[k][pos[k]]
            if supports[node] > max_support:
                max_support = supports[node]
                max_node = node
        if len(supports) == 1:
            return False
        tlist = [k for k in tlist if paths[k][pos[k]] == max_node]
        return True

    direct_support, total_support = get_support()
    path: List[List] = []  # entries [node, direct, total, branching]
    lower_direct_node_index = -1
    running = 0
    while tlist:
        node = paths[tlist[0]][pos[tlist[0]]]
        if direct_support >= direct_support_thresh:
            lower_direct_node_index = running
        path.append([node, direct_support, total_support, False])
        tlist = [k for k in tlist if not ended(k)]
        for k in tlist:
            pos[k] += 1
        running += 1
        path[-1][3] = reduce_to_majority()
        direct_support, total_support = get_support()

    if debug_output is not None:
        # reference format (predictionranges.hh:171-211)
        debug_output.write(
            f"\ncombining {len(records)} independent predictions for query "
            f"{identifier}, threshold {direct_support_thresh} "
            f"({int(min_signal_percentage * 100)} %)\n"
        )
        for rec in records:
            sup = rec.get_support_at_node(rec.lower_node)
            upper_chain = tax.path_down(rec.upper_node)[:-1]
            inner_chain = tax.path_down(rec.lower_node, rec.upper_node)
            debug_output.write(
                f"{sup}: "
                + "".join(tax.name_of(n) + ";" for n in upper_chain)
                + "["
                + ";".join(tax.name_of(n) for n in inner_chain)
                + "]\n"
            )
        debug_output.write("\n")
        debug_output.write("  L |  direct s. |    total s.| B | name\n")
        debug_output.write("--------------------------------------------\n")
        for node, d, t, b in path:
            star = "*" if d >= direct_support_thresh else ""
            debug_output.write(
                f"{int(tax.depth[node]):3d} | {d:10d} | {t:10d} | "
                f"{int(b)} | {star}{tax.name_of(node)}\n"
            )

    if lower_direct_node_index >= 0:  # direct mode (:213-251)
        if debug_output is not None:
            debug_output.write("using direct binning mode...\n")
        prec.binning_type = BINNING_DIRECT
        lower_node = path[lower_direct_node_index][0]
        lower_node_support = path[lower_direct_node_index][2]
        upper_node_support = lower_node_support
        upper_node = lower_node
        upper_direct_node_index = lower_direct_node_index
        for j in range(lower_direct_node_index, -1, -1):
            if path[j][1] >= direct_support_thresh:
                upper_node_support = path[j][2]
                upper_node = path[j][0]
                upper_direct_node_index = j
                if path[j][3]:
                    break
        prec.set_node_range(
            lower_node,
            upper_node,
            lower_support=lower_node_support,
            upper_support=upper_node_support,
        )
        for i in range(lower_direct_node_index, upper_direct_node_index, -1):
            prec.set_support_at(path[i][0], path[i][1])
        return prec

    # fallback mode (:254-265)
    if debug_output is not None:
        debug_output.write("using fallback binning mode...\n")
    prec.binning_type = BINNING_FALLBACK
    for i in range(len(path) - 1, -1, -1):
        if path[i][2] >= direct_support_thresh:
            prec.set_node_point(path[i][0], path[i][2])
            return prec
    prec.set_node_point(path[0][0], path[0][2])
    return prec

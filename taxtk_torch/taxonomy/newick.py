"""Copy of taxtk/taxonomy/newick.py: the port keeps its own copy and imports nothing of taxtk.

Rank-projected Newick subtree export.

Port of NewickTaxonFilter (reference: core/src/taxonfilter.hh:49-157):
collected taxids are mapped up to the nearest node whose rank is in the
given rank list; the induced tree over those nodes (plus root) is emitted as
Newick, optionally inserting anonymous `()` nodes for skipped ranks.
Sibling order is deterministic here (node-index order); the reference
iterates pointer-keyed maps so its sibling order is allocation-dependent.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

from .flat import FlatTaxonomy
from ..utils.errors import TaxonNotFound


class NewickBuilder:
    def __init__(
        self,
        tax: FlatTaxonomy,
        rank_names: Sequence[str],
        show_names: bool = False,
        fill_empty_ranks: bool = False,
    ):
        self.tax = tax
        self.rank_index: Dict[str, int] = {}
        for i, r in enumerate(rank_names):
            if tax.rank_index(r) < 0:
                print(
                    f"Rank '{r}' not found in taxonomy, ignoring.", file=sys.stderr
                )
                continue
            self.rank_index[r] = i
        self.show_names = show_names
        self.fill_empty_ranks = fill_empty_ranks
        self.collected: List[int] = []

    def add(self, taxid: str):
        try:
            node = self.tax.node(taxid)
        except TaxonNotFound:
            print(
                f"Could not find node with taxid {taxid} in the taxonomy, "
                "skipping record.",
                file=sys.stderr,
            )
            return
        node = self._up_to_rank(node)
        if node not in self.collected:
            self.collected.append(node)

    def _up_to_rank(self, node: int) -> int:
        tax = self.tax
        while node != tax.ROOT and tax.rank_of(node) not in self.rank_index:
            node = int(tax.parent[node])
        return node

    def build(self) -> str:
        tax = self.tax
        # subtree children: each collected node attaches to its nearest
        # rank-bearing ancestor (or root); intermediate ancestors join too
        children: Dict[int, List[int]] = {tax.ROOT: []}
        frontier = sorted(set(self.collected) - {tax.ROOT})
        seen = set(frontier)
        while frontier:
            node = frontier.pop()
            parent = self._up_to_rank(int(tax.parent[node]))
            children.setdefault(parent, [])
            if node not in children[parent]:
                children[parent].append(node)
            if parent != tax.ROOT and parent not in seen:
                seen.add(parent)
                frontier.append(parent)

        def label(node: int) -> str:
            return tax.name_of(node) if self.show_names else tax.taxid_of(node)

        def render(node: int) -> str:
            kids = sorted(children.get(node, ()))
            if kids:
                body = "(" + ",".join(render(k) for k in kids) + ")" + label(node)
            else:
                body = label(node)
            if self.fill_empty_ranks and node != tax.ROOT:
                parent = self._up_to_rank(int(tax.parent[node]))
                if parent != tax.ROOT:
                    ri = self.rank_index[tax.rank_of(node)]
                    pi = self.rank_index[tax.rank_of(parent)]
                    for _ in range(pi - ri - 1):  # anonymous intermediate
                        body = "(" + body + ")"
            return body

        inner = ",".join(render(k) for k in sorted(children[tax.ROOT]))
        return "(" + inner + ");\n"

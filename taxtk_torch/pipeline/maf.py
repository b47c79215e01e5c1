"""Copy of taxtk/pipeline/maf.py: the port keeps its own copy and imports nothing of taxtk.

MAF -> 11-column alignments TSV conversion (LAST pipeline input).

Port of the reference converter semantics (reference:
extended/bin/lastmaf2alignments:29-60): in each pairwise MAF block the FIRST
's' row is the reference, the SECOND the query; a '-' query strand flips the
query coordinates to forward orientation and swaps the reference coordinates
(the reverse-complement convention of doc/fileformats.md:30).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, TextIO

from ..utils.fmt import cxx_float, cxx_double


@dataclass
class MafBlock:
    score: float = 0.0
    expect: float = 0.0
    names: List[str] = field(default_factory=list)
    starts: List[int] = field(default_factory=list)
    sizes: List[int] = field(default_factory=list)
    strands: List[str] = field(default_factory=list)
    seq_sizes: List[int] = field(default_factory=list)
    texts: List[str] = field(default_factory=list)


def iter_maf_blocks(stream: TextIO) -> Iterator[MafBlock]:
    block: Optional[MafBlock] = None
    for raw in stream:
        line = raw.rstrip("\n")
        if line.startswith("a"):
            if block is not None and len(block.names) >= 2:
                yield block
            block = MafBlock()
            for pair in line[1:].split():
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    if k == "score":
                        block.score = float(v)
                    elif k in ("expect", "E"):
                        block.expect = float(v)
        elif line.startswith("s") and block is not None:
            f = line.split()
            # s name start alnsize strand seqsize text
            block.names.append(f[1])
            block.starts.append(int(f[2]))
            block.sizes.append(int(f[3]))
            block.strands.append(f[4])
            block.seq_sizes.append(int(f[5]))
            block.texts.append(f[6])
        elif not line or line.startswith("#"):
            continue
    if block is not None and len(block.names) >= 2:
        yield block


def maf_block_to_tsv(block: MafBlock, protein: bool = False) -> str:
    """One alignment TSV line (no trailing newline) per pairwise block."""
    assert len(block.names) >= 2, "pairwise alignments only, please"
    ref_i, qry_i = 0, 1
    assert block.strands[ref_i] == "+"
    identities = sum(
        1
        for x, y in zip(block.texts[ref_i], block.texts[qry_i])
        if x == y and x != "-"
    )
    aln_len = len(block.texts[ref_i])

    if block.strands[qry_i] == "+":
        qstart = block.starts[qry_i] + 1
        qstop = block.starts[qry_i] + block.sizes[qry_i]
        rstart = block.starts[ref_i] + 1
        rstop = block.starts[ref_i] + block.sizes[ref_i]
    elif protein:
        qstart = block.seq_sizes[qry_i] - block.starts[qry_i]
        qstop = block.seq_sizes[qry_i] - block.starts[qry_i] - block.sizes[qry_i] + 1
        rstart = block.starts[ref_i] + 1
        rstop = block.starts[ref_i] + block.sizes[ref_i]
    else:
        qstart = block.seq_sizes[qry_i] - block.starts[qry_i] - block.sizes[qry_i] + 1
        qstop = block.seq_sizes[qry_i] - block.starts[qry_i]
        rstart = block.starts[ref_i] + block.sizes[ref_i]
        rstop = block.starts[ref_i] + 1

    return "\t".join(
        (
            block.names[qry_i],
            str(qstart),
            str(qstop),
            str(block.seq_sizes[qry_i]),
            block.names[ref_i],
            str(rstart),
            str(rstop),
            cxx_float(block.score),
            cxx_double(block.expect),
            str(identities),
            str(aln_len),
        )
    )


def convert_maf(instream: TextIO, outstream: TextIO, protein: bool = False) -> int:
    n = 0
    for block in iter_maf_blocks(instream):
        outstream.write(maf_block_to_tsv(block, protein) + "\n")
        n += 1
    return n

"""Copy of taxtk/pipeline/orf.py: the port keeps its own copy and imports nothing of taxtk.

ORF calling: DNA contigs -> protein ORF FASTA for the protein pipeline.

The reference pipeline runs the external `orfm` binary before blastp
(reference: extended/binning-blast-protein.bash:84) and the binner globs
ORFs back to their parent contig with `([^_]+)_.*` (:119).  This module
provides the same stage: `call_orfs_file` uses a real `orfm` when it is on
PATH (gated, like the aligners) and otherwise falls back to the built-in
pure-Python caller with OrfM's semantics:

  * all six reading frames (frames 1-3 = forward offsets 0-2,
    frames 4-6 = reverse-complement offsets 0-2, OrfM convention)
  * ORFs are STOP-TO-STOP stretches — no start codon required
  * minimum ORF length in nucleotides (OrfM -m, default 96 = 32 aa)
  * headers `>{seqid}_{start}_{frame}_{counter}`: start is the 1-based
    nucleotide position of the ORF's first codon in the frame's reading
    direction, counter increments per emitted ORF within each sequence —
    the `{seqid}_` prefix is the contract the binner regex depends on
  * ambiguous bases translate to 'X' (not a stop: ORFs continue through)
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Iterator, TextIO, Tuple

_CODON = {}
for _i, _b1 in enumerate("TCAG"):
    for _j, _b2 in enumerate("TCAG"):
        for _k, _b3 in enumerate("TCAG"):
            _aa = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"[
                _i * 16 + _j * 4 + _k
            ]
            _CODON[_b1 + _b2 + _b3] = _aa

_COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")


def _translate(seq: str) -> str:
    n = len(seq) // 3
    return "".join(
        _CODON.get(seq[3 * i : 3 * i + 3], "X") for i in range(n)
    )


def orfs_of_sequence(
    seqid: str, seq: str, min_length: int = 96
) -> Iterator[Tuple[str, str]]:
    """Yield (header, protein) for every ORF of one sequence (all 6 frames,
    stop-to-stop, >= min_length nt)."""
    seq = seq.upper()
    rc = seq.translate(_COMPLEMENT)[::-1]
    min_aa = min_length // 3
    counter = 0
    for frame in range(1, 7):
        strand_seq = seq if frame <= 3 else rc
        off = (frame - 1) % 3
        prot = _translate(strand_seq[off:])
        start_aa = 0
        for run in prot.split("*"):
            if len(run) >= min_aa:
                counter += 1
                nt_start = off + 3 * start_aa + 1  # 1-based, frame direction
                yield (f"{seqid}_{nt_start}_{frame}_{counter}", run)
            start_aa += len(run) + 1  # skip the stop codon
    return


def call_orfs(instream: TextIO, outstream: TextIO, min_length: int = 96) -> int:
    """FASTA DNA -> FASTA protein ORFs (pure-Python orfm equivalent).
    Returns the number of ORFs written."""
    n = 0

    def flush(seqid, chunks):
        nonlocal n
        if seqid is None:
            return
        for header, prot in orfs_of_sequence(seqid, "".join(chunks), min_length):
            outstream.write(f">{header}\n{prot}\n")
            n += 1

    seqid = None
    chunks: list = []
    for line in instream:
        if line.startswith(">"):
            flush(seqid, chunks)
            seqid = line[1:].split(None, 1)[0].strip()
            chunks = []
        else:
            chunks.append(line.strip())
    flush(seqid, chunks)
    return n


def call_orfs_file(
    input_fasta: str, out_faa: str, min_length: int = 96
) -> str:
    """Run the ORF stage: real `orfm` when available (reference parity),
    else the built-in caller.  Returns the tool used ('orfm'/'builtin')."""
    exe = shutil.which("orfm")
    if exe:
        with open(input_fasta) as src, open(out_faa, "w") as dst:
            subprocess.run(
                [exe, "-m", str(min_length)], stdin=src, stdout=dst, check=True
            )
        return "orfm"
    with open(input_fasta) as src, open(out_faa, "w") as dst:
        call_orfs(src, dst, min_length)
    return "builtin"

"""Copy of taxtk/formats/bioboxes.py: the port keeps its own copy and imports nothing of taxtk.

Bioboxes.org binning format reader (the writer lives in binning/binner).

Equivalent of the reference's header-only BioboxesParser
(reference: core/src/bioboxes.hh:104-209): parses the `#` comment block,
`@Key:Value` header variables and the `@@`-prefixed column header, locates
the `_TaxatorTK_Support`/`_TaxatorTK_Length` custom columns when present,
and iterates body rows.  Used for round-trip testing of binner output and
for consuming binning files in the summary tools.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, TextIO


@dataclass
class BioboxesRow:
    seqid: str
    taxid: str
    extra_cols: List[str]
    line: str

    def support(self, reader: "BioboxesReader") -> Optional[int]:
        if reader.index_support is None:
            return None
        return int(self.extra_cols[reader.index_support])

    def length(self, reader: "BioboxesReader") -> Optional[int]:
        if reader.index_length is None:
            return None
        return int(self.extra_cols[reader.index_length])


@dataclass
class BioboxesReader:
    """Parse the header on construction; iterate rows afterwards.

    Mirrors the reference parser's behavior: the header ends at the first
    `@@` line, `@Key:Value` pairs collect into `header_variables`, `#`
    lines into `comments`, empty body lines are skipped."""

    stream: TextIO
    comments: List[str] = field(default_factory=list)
    header_variables: Dict[str, str] = field(default_factory=dict)
    columns: List[str] = field(default_factory=list)
    index_support: Optional[int] = None
    index_length: Optional[int] = None
    header_text: str = ""

    def __post_init__(self):
        for line in self.stream:
            line = line.rstrip("\n")
            self.header_text += line + "\n"
            if line.startswith("@@"):
                self.columns = line.split("\t")
                self.columns[0] = self.columns[0][2:]  # strip the @@
                for i, col in enumerate(self.columns):
                    if col == "_TaxatorTK_Support":
                        self.index_support = i
                    elif col == "_TaxatorTK_Length":
                        self.index_length = i
                break
            if line.startswith("#"):
                self.comments.append(line)
            elif line.startswith("@") and ":" in line:
                key, value = line.split(":", 1)
                self.header_variables[key] = value

    def __iter__(self) -> Iterator[BioboxesRow]:
        for line in self.stream:
            line = line.rstrip("\n")
            if not line:
                continue
            cols = line.split("\t")
            yield BioboxesRow(
                seqid=cols[0],
                taxid=cols[1] if len(cols) > 1 else "",
                extra_cols=cols,
                line=line,
            )


def read_bioboxes(path: str):
    """Open + fully parse a binning file; returns (reader, rows)."""
    with open(path) as fh:
        reader = BioboxesReader(fh)
        rows = list(reader)
    return reader, rows

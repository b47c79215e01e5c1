"""Copy of taxtk/cli/index.py: the port keeps its own copy and imports nothing of taxtk.

taxtk-index — build aligner indexes into a refpack.

Equivalent of index-blast.bash / index-blast-protein.bash / index-last.bash
(reference: extended/index-*.bash:51-57): creates
refpack/aligner-index/{blast,last}/... via external makeblastdb / lastdb
(gated on availability), and ensures the .fai index for refdata exists.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from ..constants import PROGRAM_VERSION
from ..refpack.store import FaiIndex


def build_parser():
    p = argparse.ArgumentParser(prog="taxtk-index")
    p.add_argument("kind", choices=["blast", "blast-protein", "last"])
    p.add_argument("refpack")
    p.add_argument("--cores", type=int, default=1)
    p.add_argument("-V", "--version", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(PROGRAM_VERSION)
        return 0

    protein = args.kind == "blast-protein"
    refdata = os.path.join(args.refpack, "refdata.faa" if protein else "refdata.fna")
    if not os.path.exists(refdata):
        print(f"refpack is missing {refdata}", file=sys.stderr)
        return 1

    # always (re)ensure the random-access index the RPA engine needs
    fai = refdata + ".fai"
    if not os.path.exists(fai):
        FaiIndex.build(refdata).save(fai)
        print(f"built {fai}")

    # snapshot the tool versions this refpack is indexed with — the
    # classification workflow verifies against them at startup
    # (pipeline/toolcheck.py; reference analog: contrib/download.tsv pins)
    from ..pipeline.toolcheck import record_tool_versions

    record_tool_versions(
        args.refpack,
        ["makeblastdb", "blastn", "blastp"]
        if args.kind in ("blast", "blast-protein")
        else ["lastdb", "lastal"],
    )

    if args.kind in ("blast", "blast-protein"):
        exe = shutil.which("makeblastdb")
        if exe is None:
            print("makeblastdb not found in PATH; skipped aligner index "
                  "(the .fai index was built)", file=sys.stderr)
            return 0
        outdir = os.path.join(args.refpack, "aligner-index", "blast")
        os.makedirs(outdir, exist_ok=True)
        out = os.path.join(outdir, "prot" if protein else "nuc")
        subprocess.run(
            [exe, "-in", refdata, "-dbtype", "prot" if protein else "nucl",
             "-out", out],
            check=True,
        )
        print(f"built BLAST index at {out}")
    else:
        exe = shutil.which("lastdb")
        if exe is None:
            print("lastdb not found in PATH; skipped aligner index "
                  "(the .fai index was built)", file=sys.stderr)
            return 0
        outdir = os.path.join(args.refpack, "aligner-index", "last")
        os.makedirs(outdir, exist_ok=True)
        out = os.path.join(outdir, "nuc")
        # reference flags: lastdb -P cores -Q 0 -i 10 (index-last.bash:51-57)
        subprocess.run(
            [exe, "-P", str(args.cores), "-Q", "0", "-i", "10", out, refdata],
            check=True,
        )
        print(f"built LAST index at {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

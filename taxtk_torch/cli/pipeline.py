"""Port of taxtk/cli/pipeline.py: taxtk-binning on PyTorch and CUDA.

    python -m taxtk_torch.cli.pipeline REFPACK INPUT.fna OUTDIR [flags]

Same flags, messages and output files as taxtk's, plus --device: the RPA
engine's kernels run on the card (cuda, the default) or, on request, on
the CPU.  It takes no backend flag: the engine runs its default routes.

taxtk-binning — end-to-end pipeline command.

Equivalent of `binning-blast.bash REFPACK INPUT.fna OUTDIR` and siblings
(reference: extended/binning-*.bash), with --alignments to restart from an
existing alignment archive (the reference's sample.alignments.gz
checkpoint) and --maf to convert LAST MAF output on the fly.
"""

from __future__ import annotations

import argparse
import sys

from ..constants import PROGRAM_VERSION


def build_parser():
    p = argparse.ArgumentParser(prog="taxtk-binning")
    p.add_argument("refpack")
    p.add_argument("input_fasta")
    p.add_argument("outdir")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("--protein", action="store_true",
                   help="protein pipeline: ORF-call the DNA input, then "
                        "blastp (binning-blast-protein.bash)")
    p.add_argument("--no-orf-calling", action="store_true",
                   help="with --protein: the input is already amino-acid "
                        "ORFs; skip the gene-calling stage")
    p.add_argument("--aligner", choices=["blast", "last"], default="blast",
                   help="candidate aligner: blastn/blastp or lastal "
                        "-f 1 -X 3 -e 40 with query sharding "
                        "(binning-last.bash)")
    p.add_argument("--alignments", help="existing 11-col TSV(.gz) to skip the aligner")
    p.add_argument("--maf", help="existing LAST MAF file to convert + use")
    p.add_argument("--speedup", type=float, default=0.5)
    p.add_argument("--cores", type=int, default=1)
    p.add_argument("--glob-identifier")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device for the alignment kernels (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(PROGRAM_VERSION)
        return 0

    from ..pipeline.workflows import run_binning_workflow
    from ..utils.errors import TaxtkError

    alignments = args.alignments
    if args.maf:
        import gzip
        import os

        from ..pipeline.maf import convert_maf

        converted = os.path.join(args.outdir, "maf_converted.alignments")
        os.makedirs(args.outdir, exist_ok=True)
        opener = gzip.open if args.maf.endswith(".gz") else open
        with opener(args.maf, "rt") as src, open(converted, "w") as dst:
            convert_maf(src, dst, protein=args.protein)
        alignments = converted

    try:
        paths = run_binning_workflow(
            args.refpack,
            args.input_fasta,
            args.outdir,
            alignments_file=alignments,
            protein=args.protein,
            speedup=args.speedup,
            cores=args.cores,
            glob_regex=args.glob_identifier,
            aligner_kind=args.aligner,
            # ORF calling is deterministic, so it also reruns on a restart
            # from --alignments (the records reference ORF identifiers)
            orf_call=args.protein and not args.no_orf_calling,
            device=args.device,
        )
    except TaxtkError as e:
        print(f"pipeline error: {e}", file=sys.stderr)
        return 1
    print(f"Results are in '{args.outdir}/'.")
    for k, v in paths.items():
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Tiny mixes of each configuration, for runs on the CPU: every contig
is checked."""

ALL = {"pairs": 10**9, "classes": [[1, 10**9]]}
TINY = {
    "dna-long": {"generator": "dna_sample",
                 "params": {"contigs": 3, "min_len": 1000, "max_len": 2500},
                 "check": ALL},
    "protein-blast/protein-orf": {
        "generator": "protein_sample",
        "params": {"orfs": 24, "min_len": 60, "max_len": 160},
        "check": ALL},
}

"""Tiny mixes of each configuration, for runs on the CPU: every contig
is checked.  PROTEIN_200 is the smallest protein sample whose seed
2**31 + 11 has pairs whose two orders align to different values."""

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
PROTEIN_200 = {"generator": "protein_sample",
               "params": {"orfs": 200, "min_len": 60, "max_len": 400},
               "check": ALL}

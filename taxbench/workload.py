"""Inputs of a cell, made from its seed: a refpack and one sample.

A traffic file (taxbench/traffic/<mix>.json) names its generator, a file
taxbench/generators/<generator>.py, and the generator's parameters;
`make(traffic, root, seed)` writes the refpack (refdata, mapping.tax,
ncbi-taxonomy/) and the sample (query FASTA, alignments TSV) under `root`
and returns their paths and the sample's query size.  This module holds
what the generators share: `write_dump` is a copy of
tests/fixture_tax.py::write_dump (the NCBI-style taxonomy of 22 nodes),
kept here so that the benchmark's yardstick does not move with the code it
measures.
"""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
SPECIES = ["2111111", "2111112", "2111121", "2211111", "21121", "31"]

NODES = [
    ("1", "1", "no rank"),
    ("2", "1", "superkingdom"),
    ("21", "2", "phylum"),
    ("211", "21", "class"),
    ("2111", "211", "order"),
    ("21111", "2111", "family"),
    ("211111", "21111", "genus"),
    ("2111111", "211111", "species"),
    ("21111111", "2111111", "no rank"),
    ("2111112", "211111", "species"),
    ("211112", "21111", "genus"),
    ("2111121", "211112", "species"),
    ("2112", "211", "no rank"),
    ("21121", "2112", "species"),
    ("22", "2", "phylum"),
    ("221", "22", "class"),
    ("2211", "221", "order"),
    ("22111", "2211", "family"),
    ("221111", "22111", "genus"),
    ("2211111", "221111", "species"),
    ("3", "1", "superkingdom"),
    ("31", "3", "species"),
]

NAMES = {
    "1": "root",
    "2": "Bacteria",
    "21": "Proteobacteria",
    "211": "Gammaproteobacteria",
    "2111": "Enterobacterales",
    "21111": "Enterobacteriaceae",
    "211111": "Escherichia",
    "2111111": "Escherichia coli",
    "21111111": "Escherichia coli K-12",
    "2111112": "Escherichia fergusonii",
    "211112": "Salmonella",
    "2111121": "Salmonella enterica",
    "2112": "unclassified Gammaproteobacteria",
    "21121": "gamma proteobacterium sp.",
    "22": "Firmicutes",
    "221": "Bacilli",
    "2211": "Bacillales",
    "22111": "Bacillaceae",
    "221111": "Bacillus",
    "2211111": "Bacillus subtilis",
    "3": "Archaea",
    "31": "Archaeon X",
}


def write_dump(dirpath):
    """Write nodes.dmp/names.dmp into dirpath; returns (nodes, names) paths."""
    nodes_path = os.path.join(dirpath, "nodes.dmp")
    names_path = os.path.join(dirpath, "names.dmp")
    with open(nodes_path, "w") as fh:
        for taxid, parent, rank in NODES:
            fh.write(f"{taxid}\t|\t{parent}\t|\t{rank}\t|\tx\t|\n")
    with open(names_path, "w") as fh:
        for taxid, name in NAMES.items():
            fh.write(f"{taxid}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
    return nodes_path, names_path


def stratified_lengths(rng, n, lo, hi, cuts=()):
    """n lengths in [lo, hi], one drawn inside each of n strata, in an
    order shuffled by rng; returns them and the part of each.  `cuts`
    split the range into parts, each starting at a cut; a part gets a share
    of the n strata in proportion to its width (largest remainders), and
    its strata are equal.  Every seed gets the same strata, so the count in
    each part is the same on every seed and the total length moves by
    less than one stratum's width."""
    bounds = np.array([lo, *cuts, hi + 1], np.int64)
    widths = np.diff(bounds)
    share = n * widths / widths.sum()
    counts = np.floor(share).astype(np.int64)
    rest = n - int(counts.sum())
    counts[np.argsort(counts - share, kind="stable")[:rest]] += 1
    lengths, parts = [], []
    for k, (start, width, m) in enumerate(zip(bounds[:-1], widths, counts)):
        lengths.append(start + (width * (np.arange(m) + rng.rand(m))
                                / max(m, 1)).astype(np.int64))
        parts.append(np.full(m, k))
    order = rng.permutation(n)
    return np.concatenate(lengths)[order], np.concatenate(parts)[order]


def balanced_counts(rng, parts, top):
    """For each part, the counts 1..top in equal shares (as far as whole
    numbers go), in an order shuffled by rng."""
    out = np.empty(len(parts), np.int64)
    for k in np.unique(parts):
        idx = np.flatnonzero(parts == k)
        out[idx] = 1 + rng.permutation(len(idx)) % top
    return out


def refpack(root, records, ext):
    tax_dir = os.path.join(root, "ncbi-taxonomy")
    os.makedirs(tax_dir, exist_ok=True)
    write_dump(tax_dir)
    ref_fa = os.path.join(root, f"refdata.{ext}")
    with open(ref_fa, "w") as f:
        for rid, seq in records.items():
            f.write(f">{rid}\n{seq.tobytes().decode()}\n")
    return ref_fa


def write_sample(root, lines, qfa, ext):
    sample = os.path.join(root, "sample")
    os.makedirs(sample, exist_ok=True)
    aln_path = os.path.join(sample, "sample.alignments")
    with open(aln_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    query_fa = os.path.join(sample, f"query.{ext}")
    with open(query_fa, "w") as f:
        f.write(qfa.getvalue())
    return aln_path, query_fa


def finish(root, ref_fa, mapping, lines, qfa, ext, total):
    map_path = os.path.join(root, "mapping.tax")
    with open(map_path, "w") as f:
        for rid, sp in mapping.items():
            f.write(f"{rid}\t{sp}\n")
    aln_path, query_fa = write_sample(root, lines, qfa, ext)
    return dict(refpack=root, refdata=ref_fa, mapping=map_path,
                taxonomy=os.path.join(root, "ncbi-taxonomy"),
                alignments=aln_path, query=query_fa, query_size=total)


def make(traffic, root, seed):
    """Write the cell's refpack and sample under root: the traffic mix's
    generator (taxbench/generators/<generator>.py, its `make`) with the
    mix's parameters and the seed."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "generators", traffic["generator"] + ".py")
    spec = importlib.util.spec_from_file_location(
        "taxbench_generator_" + traffic["generator"], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    os.makedirs(root, exist_ok=True)
    return mod.make(root, seed % (1 << 32), **traffic["params"])

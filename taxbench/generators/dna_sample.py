"""Nucleotide refpack and sample: a copy of
benchmarks/bench_e2e.py::make_workload with two changes, so that a
sample's cost does not swing with the seed: contig lengths are drawn by
`stratified_lengths` (a fixed set of strata, jittered and shuffled by the
seed, with the same count in each part between `cuts`) instead of one
uniform draw each, and each part's contigs take 1..max_segments segments
in equal shares (`balanced_counts`) instead of one uniform draw each."""

import io

import numpy as np

from taxbench.workload import (BASES, SPECIES, balanced_counts, finish,
                               refpack, stratified_lengths)


def make(root, seed, contigs, min_len, max_len, cuts=(), genome_len=120_000,
         query_divergence=0.01, min_identity=0.6, revcomp_share=0.35,
         max_segments=3):
    """Nucleotide refpack and sample (copy of bench_e2e.make_workload, with
    stratified lengths and balanced segment counts): six genomes mutated
    from one backbone, contigs drawn from genome 0 with
    `query_divergence`, each hit by every genome over 1..max_segments
    disjoint segments at identity >= min_identity, `revcomp_share` of the
    hits on the reverse strand."""
    rng = np.random.RandomState(seed)
    G = genome_len
    backbone = BASES[rng.randint(0, 4, G)]
    genomes, mapping = {}, {}
    for gi, sp in enumerate(SPECIES):
        mut = rng.rand(G) < (0.02 + 0.05 * (gi % 3))
        g = backbone.copy()
        g[mut] = BASES[rng.randint(0, 4, mut.sum())]
        genomes[f"genome{gi}"] = g
        mapping[f"genome{gi}"] = sp
    ref_fa = refpack(root, genomes, "fna")
    lengths, parts = stratified_lengths(rng, contigs, min_len, max_len, cuts)
    segments = balanced_counts(rng, parts, max_segments)

    lines = []
    qfa = io.StringIO()
    total = 0
    gids = list(genomes)
    for q in range(contigs):
        L = int(lengths[q])
        st = int(rng.randint(0, G - L))
        frag = genomes[gids[0]][st : st + L].copy()
        mut = rng.rand(L) < query_divergence
        frag[mut] = BASES[rng.randint(0, 4, mut.sum())]
        qid = f"contig{q}"
        qfa.write(f">{qid}\n{frag.tobytes().decode()}\n")
        total += L
        nseg = int(segments[q])
        bounds = (np.sort(rng.choice(np.arange(1, L - 100), nseg - 1,
                                     replace=False))
                  if nseg > 1 else np.array([], int))
        for seg in np.split(np.arange(L), bounds):
            qs, qe = int(seg[0]) + 1, int(seg[-1]) + 1
            if qe - qs < 150:
                continue
            for gid in gids:
                w = genomes[gid][st + qs - 1 : st + qe]
                fw = frag[qs - 1 : qe]
                ident = int((w == fw).sum())
                if ident < min_identity * len(fw):
                    continue
                score = max(5.0, 2.0 * ident - len(fw))
                rs, re = st + qs, st + qe
                if rng.rand() < revcomp_share:
                    rs, re = re, rs  # reverse-strand convention
                lines.append(f"{qid}\t{qs}\t{qe}\t{L}\t{gid}\t{rs}\t{re}\t"
                             f"{score:.1f}\t1e-30\t{ident}\t{len(fw)}")
    return finish(root, ref_fa, mapping, lines, qfa, "fna", total)

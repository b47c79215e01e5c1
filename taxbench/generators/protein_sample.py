"""Protein refpack and sample: a copy of
benchmarks/bench_e2e.py::make_workload_protein."""

import io

import numpy as np

from taxbench.workload import AA, SPECIES, finish, refpack


def make(root, seed, orfs, min_len, max_len, min_orf=50,
                   query_divergence=0.03, min_identity=0.5):
    """Protein refpack and sample (copy of
    bench_e2e.make_workload_protein): orfs // 8 families over six
    proteomes, ORFs of at least min_orf residues cut from a family with
    `query_divergence`, each hit by every proteome at identity >=
    min_identity."""
    rng = np.random.RandomState(seed)
    n_fams = max(8, orfs // 8)
    fam_len = rng.randint(min_len, max_len + 1, n_fams)
    families = [AA[rng.randint(0, 20, L)] for L in fam_len]
    mapping, refs = {}, {}
    for gi, sp in enumerate(SPECIES):
        for fi, fam in enumerate(families):
            p = fam.copy()
            mut = rng.rand(len(p)) < (0.05 + 0.06 * (gi % 3))
            p[mut] = AA[rng.randint(0, 20, mut.sum())]
            refs[f"prot{gi}_{fi}"] = p
            mapping[f"prot{gi}_{fi}"] = sp
    ref_fa = refpack(root, refs, "faa")

    lines = []
    qfa = io.StringIO()
    total = 0
    for q in range(orfs):
        fi = int(rng.randint(0, n_fams))
        fam = families[fi]
        L = int(rng.randint(min(min_orf, len(fam)), len(fam) + 1))
        st = int(rng.randint(0, len(fam) - L + 1))
        orf = fam[st : st + L].copy()
        mut = rng.rand(L) < query_divergence
        orf[mut] = AA[rng.randint(0, 20, mut.sum())]
        qid = f"contig{q}_1"  # ORF id globbing convention
        qfa.write(f">{qid}\n{orf.tobytes().decode()}\n")
        total += L
        for gi in range(len(SPECIES)):
            rid = f"prot{gi}_{fi}"
            ident = int((refs[rid][st : st + L] == orf).sum())
            if ident < min_identity * L:
                continue
            score = max(5.0, 2.0 * ident - L)
            lines.append(f"{qid}\t1\t{L}\t{L}\t{rid}\t{st+1}\t{st+L}\t"
                         f"{score:.1f}\t1e-20\t{ident}\t{L}")
    return finish(root, ref_fa, mapping, lines, qfa, "faa", total)

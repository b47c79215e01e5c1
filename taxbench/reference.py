"""The benchmark's plain reference of `taxtk-binning --alignments`.

It reads only the cell's generated inputs (the alignments TSV, the query
FASTA, the refpack's FASTA, mapping and NCBI dump) and imports nothing of
the program.  For the contigs it is asked about it works out, by the
published semantics of taxator-tk v1.5.0 and written serially here:

  * the record sets: one query's consecutive records, split where a
    record starts after every earlier one (sorted by start, stop, order)
    has stopped (alignmentrecord.hh:418-504);
  * the RPA of each set (taxonpredictionmodelsequence.hh:341-837): the
    pass-through of a single record, the exact-match shortcut, pass 0
    against the query, pass 1 over anchors with its outgroup and band
    factor, pass 2 over the outgroup, in float32 with the reference's
    quirks (an int score cutoff, int outgroup distances, the INT_MAX
    seed of the upper distance); each pair is realigned by ref_align;
  * the GFF3 line of each set (predictionrecord.hh:248-309);
  * the binner's line of each contig: its sets' ranges combined by the
    lock-step majority walk with uint16 sums (predictionranges.hh:117-266),
    default options (-s 50, -j 0.7, no sample-wide pruning).

`Reference(files, protein)` parses once; `check(contigs)` gives every
realigned value (the whole superset of pairs a set can ask for), the GFF3
lines and the bin lines of those contigs.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np

from . import ref_align

f32 = np.float32
FLT_MAX = f32(np.finfo(np.float32).max)
INT_MAX_F = f32(2147483647)
RANKS = ("superkingdom", "phylum", "class", "order", "family", "genus",
         "species")
U16 = 0xFFFF
DNA_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    DNA_CODE[_c] = _i
    DNA_CODE[ord(chr(_c).lower())] = _i
AA_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(ref_align.AA20.encode()):
    AA_CODE[_c] = _i


class Taxonomy:
    """The NCBI dump cut to the seven ranks (and the root): each node's
    nearest kept ancestor becomes its parent."""

    def __init__(self, tax_dir):
        parent, rank = {}, {}
        with open(f"{tax_dir}/nodes.dmp") as fh:
            for line in fh:
                f = line.split("\t|\t")
                parent[f[0]], rank[f[0]] = f[1], f[2]
        keep = [t for t in parent if t == "1" or rank[t] in RANKS]
        self.parent = {}
        for t in keep:
            p = parent[t]
            while t != "1" and p not in keep:
                p = parent[p]
            self.parent[t] = p if t != "1" else None
        self.depth = {}
        for t in keep:
            d, n = 0, t
            while self.parent[n] is not None:
                n, d = self.parent[n], d + 1
            self.depth[t] = d

    def path_up(self, t):
        out = [t]
        while self.parent[out[-1]] is not None:
            out.append(self.parent[out[-1]])
        return out

    def lca(self, a, b):
        up = set(self.path_up(a))
        for n in self.path_up(b):
            if n in up:
                return n
        raise ValueError(f"no common ancestor of {a} and {b}")

    def is_below(self, anc, node):
        """anc is a strict ancestor of node"""
        return anc != node and anc in self.path_up(node)


class Record:
    __slots__ = ("qid", "qs", "qe", "qlen", "rid", "rs", "re", "score",
                 "ident", "alen", "node", "order")

    def __init__(self, fields, node, order):
        self.qid = fields[0]
        self.qs, self.qe, self.qlen = (int(x) for x in fields[1:4])
        self.rid = fields[4]
        self.rs, self.re = int(fields[5]), int(fields[6])
        self.score = f32(float(fields[7]))
        self.ident, self.alen = int(fields[9]), int(fields[10])
        self.node = node
        self.order = order

    def key(self):
        return (self.rid, self.rs, self.re, self.qs, self.qe)


def read_fasta(path):
    seqs, name, chunks = {}, None, []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks).encode()
                name, chunks = line[1:].split()[0], []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks).encode()
    return seqs


def record_sets(records):
    """Split one query's records into sets of overlapping query ranges."""
    ranked = sorted(records, key=lambda r: (r.qs, r.qe, r.order))
    sets, cur, stop = [], [], None
    for r in ranked:
        if stop is not None and r.qs > stop:
            sets.append(cur)
            cur, stop = [], None
        cur.append(r)
        stop = r.qe if stop is None else max(stop, r.qe)
    if cur:
        sets.append(cur)
    return sets


class Reference:
    def __init__(self, files, protein, device="cpu", control=None,
                 exclude_factor=0.5, toppercent=0.05, min_support=50,
                 majority=0.7):
        self.protein = protein
        self.device = device
        # control: None, or "bfloat16" to round every realigned value
        # through bfloat16 (the precision below the values' float32)
        self.control = control
        self.exclude = f32(exclude_factor)
        self.reeval = f32(1.0 - f32(toppercent))
        self.min_support = min_support
        self.majority = majority
        self.tax = Taxonomy(files["taxonomy"])
        mapping = {}
        with open(files["mapping"]) as fh:
            for line in fh:
                rid, taxid = line.split()[:2]
                mapping[rid] = taxid
        self.refs = read_fasta(files["refdata"])
        self.query = read_fasta(files["query"])
        self.runs = OrderedDict()  # qid -> its records, in input order
        with open(files["alignments"]) as fh:
            for order, line in enumerate(fh):
                if not line.strip():
                    continue
                f = line.rstrip("\n").split("\t")
                rec = Record(f, mapping[f[4]], order)
                self.runs.setdefault(rec.qid, []).append(rec)
        self.glob = re.compile("([^_]+)_.*" if protein else "(.+)")

    # ------------------------------------------------------------ sequences
    def _encode(self, raw):
        table = AA_CODE if self.protein else DNA_CODE
        codes = table[np.frombuffer(raw, np.uint8)]
        if self.protein and (codes == 255).any():
            raise ValueError("residue outside the 20 standard amino acids")
        return codes

    def _segment(self, rec, qrs, qre):
        """The reference range of a record, widened by the query range's
        overhangs; swapped coordinates read the reverse complement."""
        left, right = rec.qs - qrs, qre - rec.qe
        seq = self.refs[rec.rid]
        if not self.protein and rec.rs > rec.re:
            start = rec.re - right if right < rec.re else 1
            stop = rec.rs + left
            codes = self._encode(seq[start - 1 : min(stop, len(seq))])
            return np.where(codes < 4, 3 - codes, codes)[::-1].copy()
        start = rec.rs - left if left < rec.rs else 1
        stop = rec.re + right
        return self._encode(seq[start - 1 : min(stop, len(seq))])

    # ------------------------------------------------------------ alignment
    def _align(self, pairs):
        """(distance, similarity) float32 of each pair, as RPA reads them."""
        if not pairs:
            return []
        la = np.array([len(a) for a, _ in pairs], np.int64)
        lb = np.array([len(b) for _, b in pairs], np.int64)
        if not self.protein:
            d = ref_align.edit_distances(pairs, self.device)
            dist = d.astype(np.float32)
            sim = (np.minimum(la, lb) - (d - np.abs(la - lb))).astype(
                np.float32)
        else:
            score, matches, diag = ref_align.protein_stats(pairs, self.device)
            selfs = np.array([ref_align.BLOSUM62[a, a].sum()
                              + ref_align.BLOSUM62[b, b].sum()
                              for a, b in pairs], np.int64)
            length = matches + (diag - matches) + (la + lb - 2 * diag)
            empty = (la == 0) | (lb == 0)
            safe = np.where(selfs == 0, 1, selfs)
            norm = length.astype(np.float32) / safe.astype(np.float32)
            dist = np.where(empty, f32(0), (selfs - 2 * score).astype(
                np.float32) * norm).astype(np.float32)
            sim = np.where(empty, f32(0), (2 * score).astype(np.float32)
                           * norm).astype(np.float32)
        if self.control == "bfloat16":
            import torch

            def bf(x):
                return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
            dist, sim = bf(dist), bf(sim)
        return list(zip(dist.astype(np.float32), sim.astype(np.float32)))

    # ------------------------------------------------------------ check
    def check(self, contigs):
        """Realigned values, GFF3 lines and bin lines of `contigs` (query
        ids), as {"pairs": {(qid, qrs, qre, key_a, key_b|None): (d, s)},
        "gff3": {qid: [lines]}, "bins": {name: line}}."""
        sets = []
        for qid in contigs:
            for rs in record_sets(self.runs[qid]):
                sets.append((qid, rs))
        # every pair any pass of any set can ask for; an edit distance and
        # the similarity made from it are the same in both orders, so a
        # DNA pair is aligned once for both
        want, seqs, same = [], [], []
        for qid, rs in sets:
            if len(rs) < 2:
                continue
            qrs = min(r.qs for r in rs)
            qre = max(r.qe for r in rs)
            q = self._encode(self.query[qid][qrs - 1 : qre])
            segs = [self._segment(r, qrs, qre) for r in rs]
            for i, r in enumerate(rs):
                want.append((qid, qrs, qre, r.key(), None))
                seqs.append((segs[i], q))
                for j, r2 in enumerate(rs):
                    key = (qid, qrs, qre, r.key(), r2.key())
                    if j != i and (self.protein or j > i):
                        want.append(key)
                        seqs.append((segs[i], segs[j]))
                    elif j != i:
                        same.append((key, (qid, qrs, qre, r2.key(), r.key())))
        values = dict(zip(want, self._align(seqs)))
        for key, other in same:
            values[key] = values[other]
        gff3, bins = {}, {}
        for qid, rs in sets:
            line = self._gff3(self._predict(qid, rs, values))
            gff3.setdefault(qid, []).append(line)
        for qid in contigs:
            name = self.glob.match(qid).group(1)
            bins[name] = self._bin(name, [self._parse(ln) for ln in gff3[qid]])
        return {"pairs": values, "gff3": gff3, "bins": bins}

    # ------------------------------------------------------------ RPA
    def _predict(self, qid, rs, values):
        tax = self.tax
        n = len(rs)
        qlen = rs[0].qlen
        if n == 1:
            r = rs[0]
            return dict(qid=qid, qlen=qlen, begin=r.qs, end=r.qe,
                        lower=r.node, upper="1", support=r.ident,
                        rtax=r.node, ival=f32(1.0))
        qrs = min(r.qs for r in rs)
        qre = max(r.qe for r in rs)
        qrlen = qre - qrs + 1
        recs = sorted(rs, key=lambda r: (-float(r.score), -r.ident))
        out = dict(qid=qid, qlen=qlen, begin=qrs, end=qre)

        def exact(r):
            return r.alen == qrlen and r.ident == qrlen

        if exact(recs[0]):  # the exact-match shortcut
            best = recs[0].score
            lnode, unode, i = recs[0].node, None, 1
            while True:
                if i == n:
                    unode = "1"
                    break
                if recs[i].score == best:
                    lnode = tax.lca(lnode, recs[i].node)
                else:
                    uscore, unode = recs[i].score, lnode
                    while i < n and recs[i].score == uscore:
                        unode = tax.lca(unode, recs[i].node)
                        i += 1
                    break
                i += 1
            return dict(out, lower=lnode, upper=unode, support=qrlen,
                        rtax=lnode, ival=f32(0.0))

        def pair(i, j=None):
            key = (qid, qrs, qre, recs[i].key(),
                   None if j is None else recs[j].key())
            return values[key]

        # pass 0: realign the best-scoring records against the query
        qdist = [FLT_MAX] * n
        qsim = [f32(0.0)] * n
        threshold = f32(self.reeval * recs[0].score)
        qgroup, best = [], 0
        support = 0
        for i, r in enumerate(recs):
            if exact(r):
                qgroup.append(i)
                qdist[i], qsim[i] = f32(0.0), f32(r.ident)
            elif r.score >= threshold:
                qgroup.append(i)
                d, s = pair(i)
                qdist[i], qsim[i] = d, max(s, f32(r.ident))
            else:
                qsim[i] = f32(r.ident)
            if qdist[i] < qdist[best]:
                best = i
            elif qdist[i] == qdist[best] and (
                    qsim[i] > qsim[best]
                    or (qsim[i] == qsim[best] and r.score > recs[best].score)):
                best = i
            support = max(support, int(qsim[i]))
        lca_all = recs[0].node
        for r in recs:
            lca_all = tax.lca(lca_all, r.node)
        rtax = recs[best].node
        kept = []
        for i in sorted(qgroup):
            if (qdist[i] == qdist[best] and qsim[i] == qsim[best]
                    and recs[i].score == recs[best].score):
                rtax = tax.lca(rtax, recs[i].node)
                kept.append(i)

        # pass 1: each anchor against the candidates
        qgroup = kept
        outgroup, lca_root_min = [], 255
        ival_g, lnode_g, unode_g, band_max = f32(0.0), rtax, rtax, f32(1.0)
        while True:
            anchor = qgroup.pop(0)
            qd = qdist[anchor]
            rnode = recs[anchor].node
            band = [(f32(0.0), rnode)]
            lnode, ldist, udist = rtax, f32(0.0), FLT_MAX
            cands = []
            pid_upper = pid_guar = pid_heur = 0.0
            score_cut = 0
            i = 0
            while (lnode != "1" and i < n
                   and float(recs[i].score) >= float(score_cut)):
                cnode = recs[i].node
                spid = recs[i].ident / qrlen
                if float(qsim[i]) / qrlen >= max(pid_guar, pid_heur):
                    if i == anchor:
                        d = f32(0.0)
                    elif qdist[i] == f32(0.0):
                        d = qdist[anchor]
                    else:
                        d = pair(i, anchor)[0]
                    band.append((d, cnode))
                    if d == f32(0.0):
                        if i in qgroup:
                            qgroup.remove(i)
                    elif d <= qd:
                        lnode = tax.lca(lnode, cnode)
                        ldist = max(ldist, d)
                    else:
                        if d < udist:
                            udist = d
                            if spid > pid_upper:
                                pid_upper = spid
                                pid_guar = spid * 2.0 - 1.0
                                pid_heur = float(f32(spid) * self.exclude)
                            if not score_cut:
                                score_cut = int(recs[i].score * self.exclude)
                        cands.append((i, int(d)))
                i += 1
            bf = self._band_factor(band, rnode)
            band_max = max(band_max, bf)
            qd_ex = f32(qd * bf)
            min_upper = INT_MAX_F
            curated = []
            for idx, di in cands:
                d = f32(di)
                if d > qd_ex:
                    if d > min_upper:
                        continue
                    min_upper = min(min_upper, d)
                elif min_upper > qd_ex:
                    min_upper = d
                else:
                    min_upper = max(min_upper, d)
                curated.append((idx, di))
            unode = lnode
            for idx, di in curated:
                if f32(di) > min_upper:
                    continue
                cnode = recs[idx].node
                unode = tax.lca(cnode, unode)
                depth = tax.depth[tax.lca(cnode, rtax)]
                if depth > lca_root_min:
                    continue
                if depth < lca_root_min:
                    lca_root_min, outgroup = depth, []
                if idx not in outgroup:
                    outgroup.append(idx)
            ival = f32(0.0)
            if unode != lnode and ldist < qd:
                ival = f32((qd - ldist) / f32(udist - ldist))
            ival_g = max(ival, ival_g)
            unode_g = tax.lca(unode_g, unode)
            lnode_g = tax.lca(lnode_g, lnode)
            if not (qgroup and lnode_g != "1"):
                break

        # pass 2: the outgroup anchors widen the upper node
        outgroup = sorted(outgroup)
        while outgroup:
            anchor = outgroup.pop(0)
            if unode_g == lca_all:
                continue
            pid_a = float(qsim[anchor]) / qrlen
            pid_cut = max(pid_a * 2.0 - 1.0, pid_a * float(self.exclude))
            score_cut = f32(recs[anchor].score * self.exclude)
            i = 0
            while i < n and recs[i].score >= score_cut:
                if float(qsim[i]) / qrlen >= pid_cut:
                    cnode = recs[i].node
                    if i == anchor:
                        d = f32(0.0)
                    else:
                        if tax.is_below(unode_g, cnode) or cnode == unode_g:
                            i += 1
                            continue
                        d = pair(i, anchor)[0]
                        qdist[i] = d
                    if d == f32(0.0):
                        if i in outgroup:
                            outgroup.remove(i)
                    else:
                        if qdist[anchor] == FLT_MAX:
                            qa_d, qa_s = pair(anchor)
                            qdist[anchor] = qa_d
                            qsim[anchor] = max(qa_s, qsim[anchor])
                        if d <= f32(qdist[anchor] * band_max):
                            unode_g = tax.lca(unode_g, cnode)
                i += 1
        if unode_g == lnode_g:
            ival_g = f32(1.0)
        return dict(out, lower=lnode_g, upper=unode_g, support=support,
                    rtax=rtax, ival=ival_g)

    def _band_factor(self, data, anchor_node):
        tax = self.tax
        seq = [data[0]] + sorted(data[1:], key=lambda t: float(t[0]))
        factor = f32(1.0)
        last = tax.depth[seq[0][1]]
        worst = {last: seq[0][0]}
        for score, node in seq[1:]:
            rank = tax.depth[tax.lca(node, anchor_node)]
            if rank < last:
                worst[rank] = score
                last = rank
            elif rank > last:
                for r in range(rank - 1, -1, -1):
                    ref = worst.get(r)
                    if ref:
                        factor = max(factor, f32(score / ref))
        return f32(np.sqrt(np.float64(factor)))

    # ------------------------------------------------------------ output
    def _gff3(self, p):
        lower, upper, s = p["lower"], p["upper"], int(p["support"])
        if lower != upper:
            tax_attr = (f"{lower}:{s}-{upper}" if s else upper)
        else:
            tax_attr = f"{upper}:{s}" if s else upper
        attrs = f"seqlen={p['qlen']};tax={tax_attr};rtax={p['rtax']}"
        if 0.0 <= float(p["ival"]) < 1.0:
            attrs += ";ival=" + "%.6g" % float(p["ival"])
        return (f"{p['qid']}\ttaxator-tk\tsequence_feature\t{p['begin']}\t"
                f"{p['end']}\t0\t.\t.\t{attrs}")

    def _parse(self, line):
        f = line.split("\t")
        attrs = dict(kv.split("=", 1) for kv in f[8].split(";"))
        parts = attrs["tax"].split("-")
        lower, s = parts[0].split(":") if ":" in parts[0] else (parts[0], 0)
        upper = parts[-1].split(":")[0]
        return dict(qid=f[0], qlen=int(attrs["seqlen"]), lower=lower,
                    upper=upper, support=int(s))

    def _bin(self, name, recs):
        tax = self.tax
        if len(recs) == 1:
            r = recs[0]
            return f"{name}\t{r['upper']}\t{r['support']}\t{r['qlen']}"

        def at(r, depth):  # a range's support at a depth
            return r["support"] & U16 if depth >= tax.depth[r["upper"]] else 0

        summed, length, seen = 0, 0, set()
        paths, direct = [], []
        for r in recs:
            dl = tax.depth[r["lower"]]
            summed = (summed + at(r, dl)) & U16
            if r["qid"] not in seen:
                seen.add(r["qid"])
                length += r["qlen"]
            paths.append(tax.path_up(r["lower"])[::-1])
            direct.append([at(r, d) for d in range(dl + 1)])
        total = [[max(v[d:]) for d in range(len(v))] for v in direct]
        thresh = max(int(float(f32(self.majority) * f32(summed))) & U16,
                     self.min_support & U16)
        live = list(range(len(recs)))
        pos = [0] * len(recs)

        def sums():
            return (sum(direct[k][pos[k]] for k in live) & U16,
                    sum(total[k][pos[k]] for k in live) & U16)

        walk, lower_i = [], -1
        d_sup, t_sup = sums()
        while live:
            node = paths[live[0]][pos[live[0]]]
            if d_sup >= thresh:
                lower_i = len(walk)
            walk.append([node, d_sup, t_sup, False])
            live = [k for k in live if pos[k] != len(direct[k]) - 1]
            for k in live:
                pos[k] += 1
            if len(live) >= 2:  # keep the branch of most total support
                acc, top, top_node = {}, 0.0, None
                for k in live:
                    nd = paths[k][pos[k]]
                    acc[nd] = acc.get(nd, 0.0) + total[k][pos[k]]
                    if acc[nd] > top:
                        top, top_node = acc[nd], nd
                if len(acc) > 1:
                    live = [k for k in live if paths[k][pos[k]] == top_node]
                    walk[-1][3] = True
            d_sup, t_sup = sums()
        if lower_i >= 0:
            upper_i = lower_i
            for j in range(lower_i, -1, -1):
                if walk[j][1] >= thresh:
                    upper_i = j
                    if walk[j][3]:
                        break
            node = walk[upper_i][0]
            sup = walk[lower_i][2] if upper_i == lower_i else walk[upper_i][2]
            return f"{name}\t{node}\t{sup}\t{length}"
        for j in range(len(walk) - 1, -1, -1):
            if walk[j][2] >= thresh:
                return f"{name}\t{walk[j][0]}\t{walk[j][2]}\t{length}"
        return f"{name}\t{walk[0][0]}\t{walk[0][2]}\t{length}"

"""Copy of taxtk/pipeline/summaries.py: the port keeps its own copy and imports nothing of taxtk.

Binning summary generation.

Python equivalents of the pipeline's shell/awk summary chain
(reference: extended/lib/common.sh:131-174):
  binning2taxpath   bioboxes body -> name-path TSV (taxknife -s path, sorted)
  taxpath2taxsummary  per-taxon-path accumulated support/length
  binning2vprofile  rank-of-assignment depth profile (sort | uniq -c)
  binning2summary   writes .vprofile / .taxpath.tsv / .taxsummary.tsv and a
                    self-contained HTML profile (Krona substitute)
  taxonomy_version  md5 hash over sorted "taxid\tparent" pairs
                    (reference: common.sh:176-184)
"""

from __future__ import annotations

import hashlib
import html
import os
from collections import Counter, OrderedDict
from typing import Dict, List, TextIO, Tuple

from ..constants import DEFAULT_RANKS
from ..taxonomy.flat import FlatTaxonomy
from ..utils.errors import TaxonNotFound


def iter_binning_rows(stream: TextIO):
    for raw in stream:
        line = raw.rstrip("\n")
        if not line or line.startswith(("@", "#")):
            continue
        fields = line.split("\t")
        if len(fields) >= 4:
            yield fields[0], fields[1], int(fields[2]), int(fields[3])


def _name_path(tax: FlatTaxonomy, taxid: str) -> str:
    try:
        node = tax.node(taxid)
    except TaxonNotFound:
        return ""
    parts = [
        tax.name_of(c)
        for c in tax.path_down(node)
        if tax.rank_of(c) in DEFAULT_RANKS
    ]
    return ";".join(parts)


def binning_to_taxpath(tax: FlatTaxonomy, rows) -> List[Tuple[str, str, int, int]]:
    out = [(seqid, _name_path(tax, taxid), support, length) for seqid, taxid, support, length in rows]
    # LC_COLLATE=C sort over the whole line (common.sh:136)
    return sorted(out, key=lambda t: (t[0], t[1]))


def taxpath_to_taxsummary(taxpath_rows) -> List[Tuple[str, int, int]]:
    acc: "OrderedDict[str, List[int]]" = OrderedDict()
    for _, path, support, length in taxpath_rows:
        if path not in acc:
            acc[path] = [0, 0]
        acc[path][0] += support
        acc[path][1] += length
    return sorted((p, s, l) for p, (s, l) in acc.items())


def binning_to_vprofile(tax: FlatTaxonomy, rows) -> List[Tuple[int, str]]:
    counts = Counter()
    for _, taxid, _, _ in rows:
        try:
            counts[tax.rank_of(tax.node(taxid))] += 1
        except TaxonNotFound:
            counts["unknown"] += 1
    return sorted(((n, rank) for rank, n in counts.items()), key=lambda t: t[1])


def taxonomy_version_hash(nodes_path: str) -> str:
    """md5 over sorted unique "taxid\tparent" pairs, skipping self-links
    (reference: common.sh:176-184)."""
    import gzip
    import io

    def openf(p):
        with open(p, "rb") as probe:
            if probe.read(2) == b"\x1f\x8b":
                return io.TextIOWrapper(gzip.open(p, "rb"))
        return open(p, "r")

    pairs = set()
    with openf(nodes_path) as fh:
        for line in fh:
            f = line.split("\t|\t")
            if len(f) >= 2 and f[0] != f[1]:
                pairs.add(f"{f[0]}\t{f[1]}")
    blob = "".join(p + "\n" for p in sorted(pairs))
    return hashlib.md5(blob.encode()).hexdigest()


def write_html_summary(taxsummary, out: TextIO, sample_name: str):
    """Self-contained interactive HTML profile (Krona-substitute: nested
    details/summary tree with support bars, zero external deps)."""
    tree: Dict = {}
    total = sum(s for _, s, _ in taxsummary) or 1
    for path, support, length in taxsummary:
        node = tree
        for part in (path.split(";") if path else ["(root)"]):
            entry = node.setdefault(
                part, {"_children": {}, "_support": 0, "_length": 0}
            )
            entry["_support"] += support
            entry["_length"] += length
            node = entry["_children"]

    def render(children: Dict, depth=0) -> str:
        rows = []
        for name, info in sorted(children.items(), key=lambda kv: -kv[1]["_support"]):
            pct = 100.0 * info["_support"] / total
            bar = (
                f'<span class="bar" style="width:{pct:.1f}%"></span>'
                f'<span class="lbl">{html.escape(name)}</span>'
                f'<span class="num">{info["_support"]} bp ({pct:.1f}%)</span>'
            )
            if info["_children"]:
                rows.append(
                    f"<details{' open' if depth < 2 else ''}><summary>{bar}</summary>"
                    f"{render(info['_children'], depth + 1)}</details>"
                )
            else:
                rows.append(f"<div class='leaf'>{bar}</div>")
        return "".join(rows)

    out.write(
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(sample_name)} taxonomic profile</title><style>"
        "body{font-family:sans-serif;margin:2em;max-width:70em}"
        "details{margin-left:1.2em}div.leaf{margin-left:2.4em}"
        "summary{cursor:pointer;position:relative;padding:2px}"
        ".bar{position:absolute;left:0;top:0;bottom:0;background:#cde4f7;z-index:-1;display:inline-block}"
        ".lbl{font-weight:500;margin-right:.6em}.num{color:#666;font-size:.85em}"
        "</style></head><body>"
        f"<h1>{html.escape(sample_name)}</h1>"
        f"<p>total assigned support: {total} positions</p>"
        f"{render(tree)}</body></html>\n"
    )


def write_krona_sunburst(taxsummary, out: TextIO, sample_name: str):
    """Self-contained Krona-STYLE interactive chart: a zoomable radial
    sunburst (annular sectors per taxonomy level, click a sector to
    re-root, click the center to zoom out, support/length dataset
    toggle, hover details) in one HTML file with inline SVG + vanilla
    JS — no external dependencies, no network.  Functional counterpart
    of the reference's KronaTools chart (reference:
    extended/bin/ktImportText + lib/KronaTools.pm); when the real
    ktImportText is installed, write_krona also renders the original."""
    import json as _json

    def _node():
        return {"n": "", "s": 0, "l": 0, "c": {}}

    root = _node()
    root["n"] = sample_name
    for path, support, length in taxsummary:
        node = root
        node["s"] += support
        node["l"] += length
        for part in (path.split(";") if path else []):
            nxt = node["c"].setdefault(part, _node())
            nxt["n"] = part
            nxt["s"] += support
            nxt["l"] += length
            node = nxt

    def _strip(n):
        return {
            "n": n["n"], "s": n["s"], "l": n["l"],
            "c": [_strip(v) for _, v in sorted(
                n["c"].items(), key=lambda kv: -kv[1]["s"])],
        }

    data = _json.dumps(_strip(root), separators=(",", ":"))
    title = html.escape(sample_name)
    out.write("""<!DOCTYPE html><html><head><meta charset='utf-8'>
<title>""" + title + """ — sunburst</title><style>
body{font-family:sans-serif;margin:1em;display:flex;gap:2em}
#chart svg{display:block}
path.sec{cursor:pointer;stroke:#fff;stroke-width:1}
path.sec:hover{opacity:.8}
#side{max-width:22em}
#crumb{color:#357;margin:.5em 0;min-height:1.2em;font-size:.9em}
#info{color:#333;font-size:.9em;white-space:pre-line}
button{margin-right:.5em}
circle.core{cursor:pointer;fill:#f5f7fa;stroke:#ccd}
text.ctr{font-size:12px;text-anchor:middle;pointer-events:none}
</style></head><body>
<div id='chart'></div>
<div id='side'><h2>""" + title + """</h2>
<div><button id='bySup'>by support</button><button id='byLen'>by length</button></div>
<div id='crumb'></div><div id='info'>click a sector to zoom in; click the center to zoom out</div></div>
<script>
const DATA=""" + data + """;
const W=640,R=W/2,RING=62,CORE=56;
let metric='s',zoomRoot=DATA,crumbs=[];
const svgNS='http://www.w3.org/2000/svg';
function colorOf(i,depth){const h=(i*57)%360;return 'hsl('+h+','+(65-depth*6)+'%,'+(52+depth*5)+'%)';}
function arcPath(a0,a1,r0,r1){
 if(a1-a0>=2*Math.PI-1e-6){a1=a0+2*Math.PI-1e-4;}
 const x=(a,r)=>R+r*Math.cos(a),y=(a,r)=>R+r*Math.sin(a);
 const big=(a1-a0)>Math.PI?1:0;
 return 'M'+x(a0,r0)+','+y(a0,r0)+' L'+x(a0,r1)+','+y(a0,r1)+
  ' A'+r1+','+r1+' 0 '+big+' 1 '+x(a1,r1)+','+y(a1,r1)+
  ' L'+x(a1,r0)+','+y(a1,r0)+
  ' A'+r0+','+r0+' 0 '+big+' 0 '+x(a0,r0)+' Z';}
function render(){
 const el=document.getElementById('chart');el.innerHTML='';
 const svg=document.createElementNS(svgNS,'svg');
 svg.setAttribute('width',W);svg.setAttribute('height',W);
 const total=zoomRoot[metric]||1;let ci=0;
 function walk(node,a0,a1,depth){
  if(depth>0){
   const p=document.createElementNS(svgNS,'path');
   p.setAttribute('d',arcPath(a0,a1,CORE+(depth-1)*RING,CORE+depth*RING));
   p.setAttribute('class','sec');p.setAttribute('fill',colorOf(ci++,depth));
   const pct=(100*node[metric]/total).toFixed(1);
   const t=document.createElementNS(svgNS,'title');
   t.textContent=node.n+'\\n'+node[metric]+(metric=='s'?' support':' bp')+' ('+pct+'%)';
   p.appendChild(t);
   p.addEventListener('click',()=>{crumbs.push(zoomRoot);zoomRoot=node;render();});
   p.addEventListener('mouseenter',()=>{document.getElementById('info').textContent=node.n+'\\n'+node.s+' support / '+node.l+' bp ('+pct+'%)';});
   svg.appendChild(p);
   if(a1-a0>0.25&&depth<5){
    const mid=(a0+a1)/2,r=CORE+(depth-0.5)*RING;
    const tx=document.createElementNS(svgNS,'text');
    tx.setAttribute('x',R+r*Math.cos(mid));tx.setAttribute('y',R+r*Math.sin(mid));
    tx.setAttribute('class','ctr');tx.textContent=node.n.length>14?node.n.slice(0,13)+'…':node.n;
    svg.appendChild(tx);}
  }
  let a=a0;
  for(const ch of node.c){
   const span=(a1-a0)*(ch[metric]/(node[metric]||1));
   if(span>0.002)walk(ch,a,a+span,depth+1);
   a+=span;}
 }
 walk(zoomRoot,-Math.PI/2,3*Math.PI/2,0);
 const core=document.createElementNS(svgNS,'circle');
 core.setAttribute('cx',R);core.setAttribute('cy',R);core.setAttribute('r',CORE-4);
 core.setAttribute('class','core');
 core.addEventListener('click',()=>{if(crumbs.length){zoomRoot=crumbs.pop();render();}});
 svg.appendChild(core);
 const label=document.createElementNS(svgNS,'text');
 label.setAttribute('x',R);label.setAttribute('y',R+4);label.setAttribute('class','ctr');
 label.textContent=zoomRoot.n.length>12?zoomRoot.n.slice(0,11)+'…':zoomRoot.n;
 svg.appendChild(label);
 el.appendChild(svg);
 document.getElementById('crumb').textContent=
  crumbs.map(c=>c.n).concat([zoomRoot.n]).join(' \\u203a ');
}
document.getElementById('bySup').addEventListener('click',()=>{metric='s';render();});
document.getElementById('byLen').addEventListener('click',()=>{metric='l';render();});
render();
</script></body></html>
""")


def taxsummary_to_krona_text(taxsummary) -> Tuple[List[str], List[str]]:
    """taxsummary rows -> the two Krona text datasets the reference feeds
    ktImportText (reference: extended/bin/taxsummary2krona:1-15): lines of
    `magnitude<TAB>name1<TAB>name2...`, magnitude = support (dataset 1) or
    length (dataset 2), path split on ';', sorted -k1,1nr."""
    support_rows = []
    data_rows = []
    for path, support, length in taxsummary:
        fields = "\t".join(path.split(";")) if path else ""
        support_rows.append((support, f"{support}\t{fields}"))
        data_rows.append((length, f"{length}\t{fields}"))
    support_rows.sort(key=lambda t: -t[0])
    data_rows.sort(key=lambda t: -t[0])
    return [r for _, r in support_rows], [r for _, r in data_rows]


def write_krona(taxsummary, sample_name: str, outdir: str) -> Dict[str, str]:
    """Write the Krona-consumable text datasets; when a real `ktImportText`
    is on PATH (gated, like the aligners), also render the Krona HTML."""
    import shutil
    import subprocess

    support_rows, data_rows = taxsummary_to_krona_text(taxsummary)
    p_sup = os.path.join(outdir, sample_name + ".krona.support.txt")
    p_dat = os.path.join(outdir, sample_name + ".krona.data.txt")
    with open(p_sup, "w") as fh:
        fh.write("".join(r + "\n" for r in support_rows))
    with open(p_dat, "w") as fh:
        fh.write("".join(r + "\n" for r in data_rows))
    paths = {"krona_support": p_sup, "krona_data": p_dat}
    # always render the built-in zoomable sunburst (no deps); the real
    # KronaTools chart is additionally rendered when installed
    p_sb = os.path.join(outdir, sample_name + ".sunburst.html")
    with open(p_sb, "w") as fh:
        write_krona_sunburst(taxsummary, fh, sample_name)
    paths["krona_sunburst"] = p_sb
    kt = shutil.which("ktImportText")
    if kt:
        p_html = os.path.join(outdir, sample_name + ".krona.html")
        subprocess.run(
            [kt, "-o", p_html, f"{p_sup},Support (bp)", f"{p_dat},Data (bp)"],
            check=True,
        )
        paths["krona_html"] = p_html
    return paths


def binning_to_summary(
    tax: FlatTaxonomy, binning_path: str, sample_name: str, outdir: str
) -> Dict[str, str]:
    """Generate .vprofile, .taxpath.tsv, .taxsummary.tsv, .taxsummary.html
    next to the binning file (reference: common.sh:161-174)."""
    with open(binning_path) as fh:
        rows = list(iter_binning_rows(fh))

    paths = {}
    vprofile = binning_to_vprofile(tax, rows)
    p = os.path.join(outdir, sample_name + ".vprofile")
    with open(p, "w") as fh:
        for n, rank in vprofile:
            fh.write(f"{n:7d} {rank}\n")
    paths["vprofile"] = p

    taxpath = binning_to_taxpath(tax, rows)
    p = os.path.join(outdir, sample_name + ".taxpath.tsv")
    with open(p, "w") as fh:
        for seqid, path, support, length in taxpath:
            fh.write(f"{seqid}\t{path}\t{support}\t{length}\n")
    paths["taxpath"] = p

    summary = taxpath_to_taxsummary(taxpath)
    p = os.path.join(outdir, sample_name + ".taxsummary.tsv")
    with open(p, "w") as fh:
        for path, support, length in summary:
            fh.write(f"{path}\t{support}\t{length}\n")
    paths["taxsummary"] = p

    p = os.path.join(outdir, sample_name + ".taxsummary.html")
    with open(p, "w") as fh:
        write_html_summary(summary, fh, sample_name)
    paths["html"] = p

    paths.update(write_krona(summary, sample_name, outdir))
    return paths

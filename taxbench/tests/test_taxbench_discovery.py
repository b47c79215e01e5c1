"""A later cell, traffic mix, per-layer metric and kernel roofline come in
as new files and new entries only: the harness finds each by its name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from tiny_mixes import PROTEIN_200
from taxbench.run import ROOT

PROBE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
from taxbench import run, workload
cell, config, mix, (e2e, layer) = run.cell_spec("dna-tiny")
files = workload.make(mix, os.path.join(sys.argv[1], "data"), 5)
rec = run.Recorder("toy_kernel")
reader = run.load_file(os.path.join(run.HERE, "metrics", "toy_kernel_roofline.py"), "m")
ctx = {"trace": {"intervals": [("toy_kernel_kernel(int)", 0.0, 2.0)]},
       "card": {"int_rate": 1.0},
       "rooflines": {"toy_kernel": {"calls": [{"n": 1.0}], "kernel": rec.spec.KERNEL,
                                    "bound_s": rec.spec.bound_s}}}
print(json.dumps({"config": config["name"], "generator": mix["generator"],
                  "contigs": files["query_size"] > 0,
                  "metrics": [m["name"] for m in e2e + layer],
                  "roofline": reader.read(ctx)}))
"""


PROTEIN_PROBE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
sys.path.append(sys.argv[2])  # the program, taxtk_torch, from the repository
from taxbench import run, witness
e2e, layer = run.cell_spec("protein-orf")[3]
res = run.run_cell("protein-orf", 2**31 + 11, 0.1, 0, device="cpu",
                   traffic=json.loads(sys.argv[1]), fault=witness.no_mirror)
print(json.dumps(dict(res, e2e=[m["name"] for m in e2e],
                      layer=[m["name"] for m in layer])))
"""
# the protein readers that are there: unit, better, source, layer
PROTEIN_LAYER = {
    "aligner_prep_ms_per_maa.protein": ("ms/Maa", "lower", "program_span",
                                        "aligner and entries"),
    "device_idle_pct.protein": ("%", "lower", "device_trace", "device"),
    "device_peak_mb.protein": ("MB", "lower", "program_counter", "device"),
    "protein_wavefront_roofline": ("%", "higher", "device_trace", "kernels"),
}


def _digest(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = hashlib.sha1(f.read()).digest()
    return out


def test_new_cell_mix_metric_roofline_are_files_only(tmp_path):
    tree = _copy_tree(tmp_path)
    before = _digest(tree / "taxbench")
    tb = tree / "taxbench"
    # a configuration, a traffic mix, a metric's reader and a roofline
    cfg = json.loads((tb / "configs" / "dna-blast.json").read_text())
    cfg["name"] = "dna-tiny-config"
    (tb / "configs" / "dna-tiny-config.json").write_text(json.dumps(cfg))
    (tb / "traffic" / "dna-tiny.json").write_text(json.dumps({
        "name": "dna-tiny", "generator": "dna_sample",
        "params": {"contigs": 2, "min_len": 1000, "max_len": 1200},
        "check": {"pairs": 1, "classes": [[1, 10**9]]}, "why": "a test"}))
    (tb / "metrics" / "toy_kernel_roofline.py").write_text(
        "from taxbench import readers\n\n\ndef read(ctx):\n"
        "    return readers.roofline_pct(ctx, 'toy_kernel')\n")
    (tb / "rooflines" / "toy_kernel.py").write_text(
        "MODULE = 'json'\nENTRY = 'dumps'\nKERNEL = 'toy_kernel_kernel'\n\n\n"
        "def record(*a, **kw):\n    return {'n': 1.0}\n\n\n"
        "def bound_s(call, card, launch):\n"
        "    return call['n'] / card['int_rate']\n")
    # entries in a BENCHMARK.json of the copy
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="dna-tiny-config",
                                 file="taxbench/configs/dna-tiny-config.json"))
    bench["workloads"].append({"name": "dna-tiny", "config": "dna-tiny-config",
                               "traffic": "dna-tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "toy_kernel_roofline", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "dna_mbp_per_hour",
                               "workloads": ["dna-tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "dna_mbp_per_hour":
            m["workloads"].append("dna-tiny")
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path)],
                         cwd=tree, capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == "dna-tiny-config"
    assert got["generator"] == "dna_sample" and got["contigs"]
    assert {"dna_mbp_per_hour", "setup_s",
            "toy_kernel_roofline"} <= set(got["metrics"])
    assert got["roofline"] == 50.0
    after = _digest(tb)
    assert {k: v for k, v in after.items() if k in before} == before


def _copy_tree(tmp_path):
    tree = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "taxbench"), tree / "taxbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tree)
    return tree


def test_protein_cell_by_entries_alone(tmp_path):
    """The protein deployment comes in as BENCHMARK.json entries alone, with
    the reader files that are there, and its run is correct once the
    program aligns each protein pair in the order asked (the witness's
    no_mirror stands in for that program)."""
    tree = _copy_tree(tmp_path)
    before = _digest(tree / "taxbench")
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    cfg = json.loads((tree / "taxbench" / "configs" /
                      "protein-blast.json").read_text())
    bench["configs"].append({
        "name": "protein-blast", "source": cfg["source"],
        "file": "taxbench/configs/protein-blast.json", "reduced": [],
        "why": "protein-space RPA on ORFs: the BLOSUM62 wavefront kernel"})
    bench["workloads"].append({
        "name": "protein-orf", "config": "protein-blast",
        "traffic": "protein-orf", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "protein_maa_per_hour", "unit": "Maa/h", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["protein-orf"]})
    for name, (unit, better, source, layer) in PROTEIN_LAYER.items():
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": "protein_maa_per_hour",
            "workloads": ["protein-orf"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", PROTEIN_PROBE, json.dumps(PROTEIN_200), ROOT],
        cwd=tree, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    checks = {k: c["value"] for k, c in got["checks"].items()}
    assert got["correct"], checks
    assert checks["pairs_compared"] > 0
    assert checks["gff3_lines_differing"] == checks["bins_differing"] == 0
    assert checks["pairs_differing"] == 0
    assert set(got["e2e"]) == {"protein_maa_per_hour", "setup_s"}
    assert set(got["metrics"]) == {"protein_maa_per_hour", "setup_s"}
    assert sorted(got["layer"]) == sorted(PROTEIN_LAYER)
    after = _digest(tree / "taxbench")
    assert {k: v for k, v in after.items() if k in before} == before

"""A later cell, traffic mix, per-layer metric and kernel roofline come in
as new files and new entries only: the harness finds each by its name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

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


def _digest(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = hashlib.sha1(f.read()).digest()
    return out


def test_new_cell_mix_metric_roofline_are_files_only(tmp_path):
    tree = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "taxbench"), tree / "taxbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tree)
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
        "def bound_s(call, card):\n    return call['n'] / card['int_rate']\n")
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

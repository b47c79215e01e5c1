"""What the harness and the reference load, by whole top-level names."""

import json
import os
import subprocess
import sys

from taxbench.run import ROOT

PROBE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import importlib
for name in sys.argv[1:]:
    importlib.import_module(name)
if "taxbench.run" in sys.argv[1:]:
    from taxbench import run
    import taxtk_torch.pipeline.workflows, taxtk_torch.engine.aligner  # what a run loads
mods = {n: getattr(m, "__file__", None) for n, m in list(sys.modules.items())}
print(json.dumps(mods))
"""


def _loaded(*names):
    out = subprocess.run([sys.executable, "-c", PROBE, *names], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax_nor_taxtk():
    mods = _loaded("taxbench.run", "taxbench.reference", "taxbench.control",
                   "taxbench.witness")
    tops = {n.split(".")[0] for n in mods}
    assert not tops & {"jax", "jaxlib", "flax", "taxtk"}
    bad = [f for f in mods.values() if f and (
        f.startswith(os.path.join(ROOT, "benchmarks") + os.sep)
        or f.startswith(os.path.join(ROOT, "tests") + os.sep))]
    assert not bad


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("taxbench.reference", "taxbench.ref_align")
    tops = {n.split(".")[0] for n in mods}
    assert not tops & {"jax", "jaxlib", "flax", "taxtk", "taxtk_torch"}

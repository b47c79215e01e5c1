"""taxtk_torch stands alone: no JAX and nothing of taxtk, and its CUDA
kernels build and agree with their plain versions on a card.

The last test needs an NVIDIA GPU and nvcc; it is marked `cuda` and skips
without a card (decided inside the test, never at import).  On a card it
fails loudly if a kernel does not build or disagrees.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|taxtk)\b|from\s+(jax|taxtk)\b)", re.MULTILINE)


def test_cli_import_loads_no_jax_and_no_taxtk():
    code = (
        "import sys\n"
        "import taxtk_torch.cli.taxator, taxtk_torch.engine.aligner\n"
        "import taxtk_torch.ops.myers_systolic, taxtk_torch.cli.binner\n"
        "import taxtk_torch.ops.protein_cuda\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'taxtk' or m.startswith('taxtk.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_parallel_import_loads_no_jax_and_no_taxtk():
    """The mesh, its engine merge and the multi-host layer, and the lazy
    exports of taxtk_torch.parallel."""
    code = (
        "import sys\n"
        "import taxtk_torch.parallel.mesh, taxtk_torch.parallel.engine_mesh\n"
        "import taxtk_torch.parallel.distributed\n"
        "from taxtk_torch.parallel import make_mesh, dryrun_step\n"
        "from taxtk_torch.parallel import distributed_classify_step\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'taxtk'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_bare_mesh_aligner_loads_no_jax_and_no_taxtk():
    """BatchAligner with a bare dp mesh, through its grid's cells."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from taxtk_torch.engine.aligner import BatchAligner\n"
        "from taxtk_torch.parallel.mesh import Mesh\n"
        "al = BatchAligner('dna', dna_backend='myers', device='cpu',\n"
        "                  mesh=Mesh([[torch.device('cpu')]] * 2))\n"
        "a = np.array([0, 1, 2, 3], np.uint8)\n"
        "out = al.align_pairs([(a, a[:3]), (a, a)])\n"
        "assert [float(r.distance) for r in out] == [1.0, 0.0], out\n"
        "assert al.stats().get('cell_pools'), al.stats()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'taxtk'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_jax_and_no_taxtk():
    files = sorted((ROOT / "taxtk_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    assert len(files) > 20
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in IMPORT_RE.finditer(f.read_text())
    ]
    assert offenders == []
    # the scan itself catches what it should
    assert IMPORT_RE.search("x = 1\nfrom taxtk.ops import oracle\n")
    assert IMPORT_RE.search("    import jax.numpy as jnp\n")
    assert not IMPORT_RE.search("from taxtk_torch.ops import host\n")


@pytest.mark.cuda
def test_kernels_build_and_match_plain_on_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from taxtk_torch.ops import cuda_build, myers_cuda, myers_systolic

    cuda_build.build(["myers_short", "myers_systolic"])  # raises on failure
    rng = np.random.default_rng(0)
    B = 300
    al = rng.integers(0, 3000, B).astype(np.int32)
    bl = rng.integers(0, 3000, B).astype(np.int32)
    ac = rng.integers(0, 5, (B, 3000)).astype(np.uint8)
    bc = rng.integers(0, 5, (B, 3000)).astype(np.uint8)
    short = np.minimum(al, bl) <= 2048
    args, _ = myers_cuda.short_inputs(ac[short], bc[short], al[short],
                                      bl[short], "cuda")
    n = myers_cuda.myers_short.launches
    assert torch.equal(myers_cuda.myers_short(*args),
                       myers_cuda.myers_short_plain(*args))
    assert myers_cuda.myers_short.launches == n + 1
    long_ = np.minimum(al, bl) > 1500
    args, _ = myers_systolic.systolic_inputs(ac[long_], bc[long_], al[long_],
                                             bl[long_], "cuda")
    assert torch.equal(myers_systolic.myers_systolic(*args),
                       myers_systolic.myers_systolic_plain(*args))

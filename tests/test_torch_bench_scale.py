"""bench_torch.py's scale families against taxtk on the CPU at small sizes.

  * the config5 runner (bench_torch.bench_scale on device="cpu": the
    default aligner's kernels run their plain versions) against taxtk's
    run_binning_workflow with the host C++ aligner (`native`) on
    benchmarks/bench_config5.make_workload, at 3% and 50% multi-candidate
    sets (the second with its gate cut to a prefix of the stream);
  * the port's copy of bench_stream_scale.synthesize against the original:
    every file byte-identical, the refpack's .fai included;
  * the config4_stream runner against taxtk's workflow on that workload;
  * the timed run's Kernel 1 record only counts (no events, no spin), and
    a wrong Kernel 1 path fails the gate.

Every output file is compared byte for byte (the alignments archive
decompressed: gzip stamps its header with the time).  The families run at
1M and 10k contigs on the card only (bench_torch.py exits without one).
"""

import gzip
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import bench_config5  # noqa: E402
import bench_stream_scale  # noqa: E402
import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402

import taxtk.pipeline.workflows as jax_wf  # noqa: E402
from taxtk.engine.aligner import BatchAligner as JaxAligner  # noqa: E402


def _taxtk_outputs(refpack, query_fa, aln, outdir):
    """taxtk's workflow with the host C++ aligner; its outputs' bytes."""
    jax_wf.run_binning_workflow(
        refpack, query_fa, outdir, alignments_file=aln,
        aligner=JaxAligner("dna", dna_backend="native"))
    return bench_torch.outdir_bytes(outdir)


def _tree_bytes(root):
    """Every file under root by relative path, .gz files decompressed."""
    found = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            opener = gzip.open if name.endswith(".gz") else open
            with opener(path, "rb") as f:
                found[os.path.relpath(path, root)] = f.read()
    return found


def _check_keys(result, family):
    """The runner's keys are the family's share of chip_smoke.BENCH_KEYS."""
    assert set(result) == {f"{family}_{k}" for k in chip_smoke.SCALE_KEYS}
    for k in chip_smoke.SCALE_KEYS:
        if family in bench_torch.FAMILIES:
            assert f"{family}_{k}" in chip_smoke.BENCH_KEYS


@pytest.mark.parametrize("family, frac, gate", [
    ("config5", 0.03, 400), ("config5_dense", 0.5, 150)])
def test_config5_runner_matches_taxtk(tmp_path, family, frac, gate):
    assert bench_torch.SCALE[family]["multi_frac"] == frac
    port = str(tmp_path / "port")
    got = bench_torch.bench_scale(family, device="cpu", contigs=400,
                                  gate=gate, workdir=port)
    refpack, query_fa, aln, total, _ = bench_config5.make_workload(
        str(tmp_path / "taxtk"), 400, frac)
    want = _taxtk_outputs(refpack, query_fa, aln, str(tmp_path / "out"))
    assert bench_torch.outdir_bytes(os.path.join(port, "timed_out")) == want
    assert len(want) == got[f"{family}_gate_files"] == 10
    _check_keys(got, family)
    assert got[f"{family}_contigs"] == 400
    assert got[f"{family}_gate_contigs"] == gate
    assert got[f"{family}_query_mbp"] == round(total / 1e6, 3)
    assert got[f"{family}_binned"] == 400
    assert got[f"{family}_launches"] == {}  # the CPU runs plain versions
    assert got[f"{family}_gate_launches"] == {}
    assert got[f"{family}_gate_kernel1_ms_sum"] is None
    assert got[f"{family}_gate_vs_native"] > 0
    ppl = got[f"{family}_pairs_per_launch"]
    assert ppl["calls"] > 0 and 0 < ppl["min"] <= ppl["median"] <= ppl["max"]
    assert got[f"{family}_pool"]["misses"] > 0
    assert set(got[f"{family}_stage_s"]) == {"engine", "binner", "summaries",
                                             "rest"}
    assert got[f"{family}_pairs"] > 0 and got[f"{family}_host_long_pairs"] == 0


def test_synthesize_copy_matches_bench_stream_scale(tmp_path):
    want = bench_stream_scale.synthesize(str(tmp_path / "a"), 40)
    got = bench_torch.synthesize(str(tmp_path / "b"), 40)
    assert got[3] == want[3] > 0
    assert [os.path.relpath(p, str(tmp_path / "b")) for p in got[:3]] == [
        os.path.relpath(p, str(tmp_path / "a")) for p in want[:3]]
    a, b = _tree_bytes(str(tmp_path / "a")), _tree_bytes(str(tmp_path / "b"))
    assert "refpack/refdata.fna.fai" in a and len(a) == 7
    assert b == a


def test_config4_stream_runner_matches_taxtk(tmp_path):
    port = str(tmp_path / "port")
    got = bench_torch.bench_scale("config4_stream", device="cpu", contigs=60,
                                  workdir=port)
    refpack, qfile, alnfile, total = bench_stream_scale.synthesize(
        str(tmp_path / "taxtk"), 60)
    want = _taxtk_outputs(refpack, qfile, alnfile, str(tmp_path / "out"))
    assert bench_torch.outdir_bytes(os.path.join(port, "timed_out")) == want
    _check_keys(got, "config4_stream")
    assert got["config4_stream_gate_contigs"] == 60
    assert got["config4_stream_query_mbp"] == round(total / 1e6, 3)
    assert got["config4_stream_binned"] == 60
    assert got["config4_stream_pairs"] > 0


def test_scale_gate_fails_on_a_wrong_distance(tmp_path, monkeypatch):
    """A Kernel 1 path that returns wrong distances fails the gate (on the
    CPU the default aligner runs Kernel 1's plain version)."""
    import torch

    from taxtk_torch.ops import myers_cuda

    real = myers_cuda.myers_short_plain

    def wrong(*args):  # distances that do not depend on the pairs
        out = real(*args)
        return torch.arange(out.numel(), dtype=out.dtype) * 7 % 50

    monkeypatch.setattr(myers_cuda, "myers_short_plain", wrong)
    with pytest.raises(AssertionError, match="differ from the native"):
        bench_torch.bench_scale("config5_dense", device="cpu", contigs=200,
                                gate=200, workdir=str(tmp_path))


def test_timed_run_record_only_counts(monkeypatch):
    """The timed run's Kernel 1 record counts entry calls and their real
    pairs (less trailing 1 x 1 dummy rows) and leaves the C entry alone;
    the gate's record wraps it to time each launch."""
    import numpy as np

    from taxtk_torch.ops import myers_cuda

    seen = []
    monkeypatch.setattr(myers_cuda, "short_inputs",
                        lambda *a, **k: seen.append(a) or "staged")
    lib = myers_cuda._lib
    a_len = np.array([150, 1, 400, 1, 1], np.int32)
    b_len = np.array([300, 7, 900, 1, 1], np.int32)
    rec = bench_torch.LaunchRecord(myers_cuda, "short_inputs",
                                   ("K", "W", "bits"), timed=False)
    with rec.active():
        assert myers_cuda._lib is lib
        assert myers_cuda.short_inputs(None, None, a_len, b_len) == "staged"
    assert rec.calls == [dict(pairs=5, real=3)] and not rec.events
    assert len(seen) == 1
    timed = bench_torch.LaunchRecord(myers_cuda, "short_inputs",
                                     ("K", "W", "bits"))
    with timed.active():
        assert myers_cuda._lib is not lib
        myers_cuda.short_inputs(None, None, a_len[:2], b_len[:2])
    assert myers_cuda._lib is lib
    assert timed.calls[0]["real"] == 2 and timed.calls[0]["cells"] == 45007
    assert bench_torch._real_pairs(np.ones(3), np.ones(3)) == 0

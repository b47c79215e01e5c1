"""bench_torch.py, the port's bench, against bench.py and
benchmarks/bench_e2e.py on the CPU at small sizes.

  * `run_once` against bench_e2e.run_once (taxtk, JAX on the CPU): the
    same GFF3, pairs, DP cells and query bp, on the nucleotide workload
    with the port's `myers` backend (taxtk's XLA `myers` with its long
    threshold at the port's 2048 bp, so both count the same cells) and with
    `native`, on a long-contig miniature whose pairs take the systolic and
    host C++ routes, and on the protein workload with the plain wavefront;
  * the summary arithmetic against bench.py's _summarize_e2e;
  * the kernel family's baseline check on the plain short-pair Myers;
  * the script without a card: a non-zero exit and no metric line.

The families themselves run on the card only (chip_smoke.py's `bench`
phase runs the script there).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import bench  # noqa: E402  (bench.py: json, time and numpy at import)
import bench_e2e  # noqa: E402
import bench_torch  # noqa: E402
from bench_e2e import make_workload, make_workload_protein  # noqa: E402

import taxtk.engine.aligner as jax_aligner_mod  # noqa: E402
from taxtk.constants import DEFAULT_RANKS  # noqa: E402
from taxtk_torch.engine import aligner as torch_aligner_mod  # noqa: E402
from taxtk_torch.ops.seqpool import reset_shared_pools  # noqa: E402

RANKS = list(DEFAULT_RANKS)


def _with_attrs(monkeypatch, module, **attrs):
    """Patch module.BatchAligner with a subclass that sets `attrs` on every
    aligner it builds (both run_once functions import it at call time)."""
    base = module.BatchAligner

    class Aligner(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            for k, v in attrs.items():
                setattr(self, k, v)

    monkeypatch.setattr(module, "BatchAligner", Aligner)


def _same_run(got, want):
    assert got["gff3"] == want["gff3"]
    assert got["gff3"].startswith("##gff-version 3\n")
    assert got["gff3"].count("\n") > 3
    for key in ("pairs", "cells", "total_qbp", "n_alignments", "gff_lines"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("backend", ["myers", "native"])
def test_run_once_matches_bench_e2e(tmp_path, monkeypatch, backend):
    paths = make_workload(str(tmp_path), 8, seed=7, min_len=1000,
                          max_len=3000)
    if backend == "myers":
        # the port sends patterns past 2048 bp to the systolic route, which
        # pads no pairs; taxtk's XLA myers sends them to its host C++ at
        # this threshold, which pads none either
        _with_attrs(monkeypatch, jax_aligner_mod, long_pattern_threshold=2048)
    want = bench_e2e.run_once(paths, RANKS, backend, keep_gff=True)
    reset_shared_pools()
    got = bench_torch.run_once(paths, RANKS, backend, keep_gff=True,
                               device="cpu")
    _same_run(got, want)
    if backend == "native":
        assert got["host_long_pairs"] == got["pairs"] > 0
        assert got["h2d_mb"] == 0
    else:
        assert got["host_long_pairs"] == 0
        assert got["pool"]["bytes_shipped"] == got["h2d_mb"] * 1e6 > 0


def test_run_once_long_routes_match_bench_e2e(tmp_path, monkeypatch):
    """Contigs of 2.1-5 kbp with the long route's pattern cap lowered to
    3,500 bp: patterns of 2,049-3,500 bp take the systolic route (its plain
    version), longer ones the host C++ on the aligner's thread, beside the
    short buckets."""
    paths = make_workload(str(tmp_path), 3, seed=5, min_len=2100,
                          max_len=5000)
    routes = {"systolic": 0}
    real = torch_aligner_mod.batched_edit_distance_systolic

    def counted(*a, **kw):
        routes["systolic"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(torch_aligner_mod, "batched_edit_distance_systolic",
                        counted)
    _with_attrs(monkeypatch, torch_aligner_mod, tpu_long_pattern_cap=3500)
    _with_attrs(monkeypatch, jax_aligner_mod, long_pattern_threshold=2048)
    want = bench_e2e.run_once(paths, RANKS, "myers", keep_gff=True)
    reset_shared_pools()
    got = bench_torch.run_once(paths, RANKS, "myers", keep_gff=True,
                               device="cpu")
    _same_run(got, want)
    assert routes["systolic"] > 0
    assert got["host_long_pairs"] > 0
    assert "host_long" in got["aligner"]
    assert "host_long_wait" in got["aligner"]


def test_run_once_protein_matches_bench_e2e(tmp_path):
    paths = make_workload_protein(str(tmp_path), 40, seed=7)
    want = bench_e2e.run_once(paths, RANKS, protein=True,
                              protein_backend="wavefront", keep_gff=True)
    got = bench_torch.run_once(paths, RANKS, protein=True,
                               protein_backend="wavefront", keep_gff=True,
                               device="cpu")
    _same_run(got, want)
    assert got["h2d_mb"] == 0  # the plain wavefront has no pool


def _fixed_runs(n, protein=False):
    """n run dicts as run_once returns them, with fixed, distinct times."""
    rng = np.random.RandomState(n)
    runs = []
    for i in range(n):
        al = {"stage_batch": 0.01 * i, "device": 0.2 + 0.01 * i,
              "device_wait": 0.05 * i, "collect": 0.003}
        if not protein:
            al["host_long"] = 0.02 * i
        runs.append({
            "engine_s": float(rng.uniform(0.4, 1.6)),
            "total_qbp": 278_008 if protein else 3_129_327,
            "cells": 564_977_564 if protein else 314_251_355_278,
            "aligner": al,
            "metrics": {"replay": 0.1 + 0.02 * i, "fetch": 0.03,
                        "align": 0.4},
            "h2d_mb": 1.5 + i,
            "h2d_s": 0.02 * i,
        })
    return runs


@pytest.mark.parametrize("n, prefix, unit", [
    (7, "e2e", "mbp"), (5, "e2e_config4", "mbp"), (3, "e2e", "mbp"),
    (7, "protein_e2e", "maa")])
def test_summary_matches_bench_py(n, prefix, unit):
    """bench_torch's copy of _summarize_e2e and of the breakdown: bench.py's
    fields and values, less the H2D seconds it meters and the port does
    not (h2d_mb comes from the pool's bytes_shipped in both run dicts)."""
    runs = _fixed_runs(n, protein=unit == "maa")
    want = bench._summarize_e2e(list(runs), prefix, unit=unit)
    got = bench_torch.summarize_e2e(list(runs), prefix, unit=unit)
    assert want.pop(f"{prefix}_h2d_s") is not None
    assert got == want
    med = bench_torch._median_run(runs)
    assert got[f"{prefix}_engine_s"] == round(med["engine_s"], 2)


def test_kernel_family_baseline_check_on_plain_myers():
    """The kernel family at a tiny shape on the CPU: the wrapper runs the
    plain short-pair Myers, whose distances must equal the host C++ Myers
    on one core (the family raises otherwise)."""
    from taxtk_torch import native
    from taxtk_torch.ops import myers_cuda

    out = bench_torch.bench_kernel("cpu", seed=3, B=40, L=160, sets=2,
                                   rounds=2, nrep=3, base_pairs=16)
    assert out["metric"] == "rpa_dna_alignment_throughput_cpu"
    assert out["shape"] == "40x160"
    assert out["roofline_pct"] is None
    assert out["vs_baseline"] >= 0 and out["baseline_gcups"] > 0
    assert "protocol" in out and out["iqr_pct"] >= 0
    # the check the family makes, and that it would catch a wrong distance
    rng = np.random.RandomState(3)
    a = rng.randint(0, 4, (40, 160)).astype(np.uint8)
    b = rng.randint(0, 4, (40, 160)).astype(np.uint8)
    lens = np.full(40, 160, np.int32)
    args, post = myers_cuda.short_inputs(a, b, lens, lens, "cpu")
    got = post(myers_cuda.myers_short(*args).numpy())
    want = native.myers_batch([(a[i], b[i]) for i in range(40)], n_threads=1)
    assert np.array_equal(got, want)
    assert not np.array_equal(got + (np.arange(40) == 7), want)


def test_script_without_a_card_exits_nonzero_and_prints_no_metric():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script would run the bench")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr
    assert not any(ln.lstrip().startswith("{")
                   for ln in (r.stdout + r.stderr).splitlines())


def test_families_and_keys_follow_bench_py():
    """The families run in bench.py's order, one process each, then the
    scale families (config5_dense only when named), each with its own
    timeout; chip_smoke.py's bench phase requires every key of the default
    scale families; and the run_once dict carries every key of
    bench_e2e.run_once's."""
    import chip_smoke

    assert bench_torch.FAMILIES == ("kernel", "e2e", "config4",
                                    "protein_kernel", "protein_e2e",
                                    "config5", "config4_stream")
    assert bench_torch.OPT_IN == ("config5_dense",)
    assert set(bench_torch.SCALE) == {"config5", "config5_dense",
                                      "config4_stream"}
    assert set(bench_torch.FAMILY_TIMEOUT_S) == set(
        bench_torch.FAMILIES + bench_torch.OPT_IN)
    assert bench_torch.SCALE["config5"]["contigs"] == 1_000_000
    assert bench_torch.SCALE["config5_dense"]["contigs"] == 1_000_000
    assert bench_torch.SCALE["config4_stream"]["contigs"] == 10_000
    assert chip_smoke.SCALE_FAMILIES == tuple(
        f for f in bench_torch.FAMILIES if f in bench_torch.SCALE)
    for fam in chip_smoke.SCALE_FAMILIES:
        for key in ("wall_s", "mbp_per_hour", "gate_native_wall_s",
                    "gate_vs_native", "binned",
                    "peak_rss_mb", "peak_mem_mb", "stage_s", "aligner_s",
                    "launches", "pairs_per_launch", "pool", "protocol"):
            assert f"{fam}_{key}" in chip_smoke.BENCH_KEYS, (fam, key)
    assert not any(k.startswith("config5_dense")
                   for k in chip_smoke.BENCH_KEYS)
    assert (bench_torch.B, bench_torch.L) == (bench.B, bench.L)
    assert (bench_torch.SETS, bench_torch.ROUNDS, bench_torch.NREP) == (
        bench.SETS, bench.ROUNDS, bench.NREP)
    src = open(os.path.join(ROOT, "benchmarks", "bench_e2e.py")).read()
    body = src.split("def run_once", 1)[1].split("\ndef ", 1)[0]
    keys = {ln.strip().split('"')[1] for ln in body.splitlines()
            if ln.strip().startswith('"') and '":' in ln}
    port = open(os.path.join(ROOT, "bench_torch.py")).read()
    port_body = port.split("def run_once", 1)[1].split("\ndef ", 1)[0]
    for k in keys:
        assert f'"{k}":' in port_body, k

"""taxtk_torch's multi-host layer against taxtk's, on the CPU.

`shard_of`, `host_shard` and `merge_gff3_parts` are held against taxtk's
on the same inputs, and a real multi-process run — 2 and 4 processes
joining a gloo group through `initialize()`, each classifying its host
shard with the port's engine — merges to the GFF3 of a single-process
run of either package.  The worker is this file itself:

    python tests/test_torch_distributed.py --worker DIR

It reads only the files the parent laid out in DIR, imports only
taxtk_torch, and checks that no jax or taxtk module was loaded before it
writes its part.  Also here: concurrent processes building the port's
host C++ libraries from a fresh copy of their sources all load them.
"""

import os
import random
import shutil
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = ["superkingdom", "phylum", "class", "order", "family", "genus",
         "species"]


def _classify(workdir, process_id, num_processes):
    """The port's engine on this process's host shard of the workload in
    workdir (the parent's layout); returns the GFF3 text."""
    import io

    from taxtk_torch.engine.executor import RpaEngine
    from taxtk_torch.engine.recordsets import iter_record_sets
    from taxtk_torch.formats.alignments import parse_alignment_line
    from taxtk_torch.formats.mapping import load_seqid_taxid_mapping
    from taxtk_torch.parallel.distributed import host_shard
    from taxtk_torch.refpack.store import IndexedFastaStore, InMemoryFastaStore
    from taxtk_torch.taxonomy.flat import load_taxonomy_from_environment

    os.environ["TAXATORTK_TAXONOMY_NCBI"] = workdir
    tax = load_taxonomy_from_environment(RANKS).prune_to_marked_ranks(RANKS)
    mapping = load_seqid_taxid_mapping(os.path.join(workdir, "mapping.tax"))
    records = []
    with open(os.path.join(workdir, "alignments.tsv")) as f:
        for line in f:
            r = parse_alignment_line(line.rstrip("\n"))
            r.reference_node = tax.node(mapping[r.reference_identifier])
            records.append(r)
    rsets = iter_record_sets(iter(records))
    mine = host_shard(rsets, process_id, num_processes)
    out = io.StringIO()
    RpaEngine(tax, InMemoryFastaStore(os.path.join(workdir, "query.fna")),
              IndexedFastaStore(os.path.join(workdir, "refdata.fna")),
              device="cpu").run(mine, out)
    return out.getvalue()


def _worker(workdir):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from taxtk_torch.parallel.distributed import initialize

    torch.set_num_threads(1)
    pid = initialize()  # TAXTK_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID
    n = int(os.environ["TAXTK_NUM_PROCESSES"])
    if dist.get_world_size() != n or dist.get_rank() != pid:
        raise SystemExit(f"rank {dist.get_rank()} of {dist.get_world_size()}"
                         f", want {pid} of {n}")
    gff3 = _classify(workdir, pid, n)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "taxtk"))
    if bad:
        raise SystemExit(f"the worker imported {bad[:5]}")
    with open(os.path.join(workdir, f"part.{pid}.gff3"), "w") as f:
        f.write(gff3)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.exit(_worker(sys.argv[2]))


import pytest  # noqa: E402

from taxtk.parallel import distributed as jax_dist  # noqa: E402
from taxtk_torch.parallel import distributed as torch_dist  # noqa: E402


class _Rec:
    def __init__(self, qid):
        self.query_identifier = qid


def test_shard_of_and_host_shard_match_taxtk():
    rng = random.Random(3)
    ids = [f"contig_{rng.randrange(10**9)}_{i}" for i in range(1000)]
    rsets = [[_Rec(q)] for q in ids]
    for n in (1, 2, 3, 4, 7):
        assert [torch_dist.shard_of(q, n) for q in ids] == \
            [jax_dist.shard_of(q, n) for q in ids]
        for p in range(n):
            got = list(torch_dist.host_shard(iter(rsets), p, n))
            want = list(jax_dist.host_shard(iter(rsets), p, n))
            assert [id(r) for r in got] == [id(r) for r in want]
    parts = [list(torch_dist.host_shard(iter(rsets), p, 4)) for p in range(4)]
    assert sum(map(len, parts)) == len(rsets)


def test_initialize_without_coordinator_is_single_process(monkeypatch):
    monkeypatch.delenv("TAXTK_COORDINATOR", raising=False)
    assert torch_dist.initialize() == 0


@pytest.mark.parametrize("chunk_lines", [200_000, 64])
def test_merge_gff3_parts_matches_taxtk(tmp_path, monkeypatch, chunk_lines):
    """Byte-equal to taxtk's merge, headers, blank lines and a last line
    without its newline included; at chunk_lines = 64 through the
    external sort's spilled runs."""
    rng = random.Random(chunk_lines)
    paths = []
    for p in range(4):
        lines = ["##gff-version 3"]
        for i in range(300):
            qid = f"contig_{rng.randrange(500):04d}"
            lines.append(f"{qid}\ttaxtk\tsequence_feature\t{rng.randrange(1, 99)}"
                         f"\t{rng.randrange(100, 999)}\t0\t.\t.\t"
                         f"seqlen=1;tax={rng.randrange(9)}")
            if i % 97 == 0:
                lines.append("")
        f = tmp_path / f"part.{p}.gff3"
        f.write_text("\n".join(lines))  # the last line has no newline
        paths.append(str(f))
    from taxtk_torch.pipeline import workflows

    spills = []
    real = workflows._MergeSortWriter._spill

    def counted(self):
        spills.append(len(self.buf))
        return real(self)

    monkeypatch.setattr(workflows._MergeSortWriter, "_spill", counted)
    got, want = tmp_path / "got.gff3", tmp_path / "want.gff3"
    torch_dist.merge_gff3_parts(paths, str(got), chunk_lines=chunk_lines)
    jax_dist.merge_gff3_parts(paths, str(want), chunk_lines=chunk_lines)
    assert got.read_bytes() == want.read_bytes()
    assert got.read_text().count("\n") == 1 + 4 * 300
    if chunk_lines == 64:
        assert len(spills) >= 1200 // 64 and max(spills) <= 64


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """_mini_refpack's workload laid out for the workers, and the GFF3 of
    single-process runs of taxtk and of the port on it."""
    from test_refpack_shard import _mini_refpack, _run

    from taxtk.refpack.store import IndexedFastaStore as JaxIndexed
    from taxtk.refpack.store import InMemoryFastaStore as JaxInMemory
    from taxtk_torch import native
    from taxtk_torch.native import replay
    from taxtk_torch.refpack.store import IndexedFastaStore

    d = tmp_path_factory.mktemp("dist")
    tax, fa, mp, qf, rows, mapping = _mini_refpack(d, n_queries=12)
    with open(d / "alignments.tsv", "w") as f:
        f.write("\n".join(rows) + "\n")
    # the port's .fai and host C++ libraries, once, before any worker
    IndexedFastaStore(fa)
    assert native.load() is not None and replay.load() is not None
    taxtk = _run(tax, JaxInMemory(qf), JaxIndexed(fa), rows, mapping)
    port = _classify(str(d), 0, 1)
    return str(d), taxtk, port


@pytest.mark.parametrize("nprocs", [2, 4])
def test_gloo_processes_merge_to_the_single_run(workload, tmp_path, nprocs):
    d, taxtk_gff3, port_gff3 = workload
    assert port_gff3.count("\n") > 3
    port = _free_port()
    procs = []
    for pid in range(nprocs):
        env = {**os.environ, "TAXTK_COORDINATOR": f"127.0.0.1:{port}",
               "TAXTK_NUM_PROCESSES": str(nprocs),
               "TAXTK_PROCESS_ID": str(pid), "OMP_NUM_THREADS": "1"}
        wd = tmp_path / f"w{pid}"
        shutil.copytree(d, wd)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(wd)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    merged = tmp_path / "merged.gff3"
    torch_dist.merge_gff3_parts(
        [str(tmp_path / f"w{p}" / f"part.{p}.gff3") for p in range(nprocs)],
        str(merged))
    for single in (taxtk_gff3, port_gff3):
        one = tmp_path / "single.gff3"
        one.write_text(single)
        want = tmp_path / "single.merged.gff3"
        torch_dist.merge_gff3_parts([str(one)], str(want))
        assert merged.read_bytes() == want.read_bytes()


_LOAD = """
import sys
sys.path.insert(0, sys.argv[1])
import native
from native import faidx, replay
libs = (native.load(), faidx.load(), replay.load())
assert all(lib is not None for lib in libs), libs
import numpy as np
pair = (np.frombuffer(b"ACGT", np.uint8), np.frombuffer(b"AGT", np.uint8))
assert native.myers_batch([pair])[0] == 1
"""


def test_concurrent_host_builds_all_load(tmp_path):
    """Processes that build the host C++ libraries from one fresh copy of
    their sources at the same time all load them: each build writes a
    temporary file and moves it into place, so none can load another's
    half-written library."""
    src = os.path.join(ROOT, "taxtk_torch", "native")
    pkg = tmp_path / "native"
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns("*.so",
                                                            "__pycache__"))
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(tmp_path)],
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    built = sorted(f for f in os.listdir(pkg) if f.endswith(".so"))
    assert built == ["libtaxtk_io.so", "libtaxtk_native.so",
                     "libtaxtk_replay.so"]
    assert not [f for f in os.listdir(pkg) if f.endswith(".tmp")]

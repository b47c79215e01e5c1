"""Port of taxtk/parallel/distributed.py: multi-host runtime and
host-sharded classification.

The reference scales across machines by splitting the input FASTA and
concatenating GFF3 (reference: README.md FAQ#9-10).  Here the same
data-parallel contract is first-class:

  * `initialize()` joins a torch.distributed process group (coordinator
    address, process count and id from the environment or arguments);
  * `host_shard()` deterministically assigns record sets to processes by a
    stable hash of the query identifier — every host parses the stream it
    has and classifies only its shard, so inputs can be pre-split (exactly
    the reference's workflow) or identical on all hosts;
  * outputs are written per host (sample.gff3.<proc>) and merged with
    `merge_gff3_parts`, byte-equal to a single-host run after the
    pipeline's `sort -k1,1`.

The group uses the gloo backend: the engine exchanges nothing across
hosts, so the group only fixes each process's rank and the world size,
and gloo (unlike NCCL) lets two ranks share one card.  Within each host,
the device grid (mesh.py) handles dp x tp.
"""

from __future__ import annotations

import os
import zlib
from typing import Iterable, Iterator, Optional


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the distributed runtime; returns this host's process index.
    No-ops (returns 0) when running single-process.  The coordinator is
    `host:port` (TAXTK_COORDINATOR); TAXTK_NUM_PROCESSES and
    TAXTK_PROCESS_ID give the world size and this process's rank."""
    coordinator_address = coordinator_address or os.environ.get("TAXTK_COORDINATOR")
    if coordinator_address is None:
        return 0
    num_processes = num_processes or int(os.environ.get("TAXTK_NUM_PROCESSES", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("TAXTK_PROCESS_ID", "0"))
    )
    import torch.distributed as dist

    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    return process_id


def shard_of(query_identifier: str, num_shards: int) -> int:
    """Stable, platform-independent shard assignment."""
    return zlib.crc32(query_identifier.encode()) % num_shards


def host_shard(
    recordsets: Iterable[list], process_id: int, num_processes: int
) -> Iterator[list]:
    """Keep only this host's record sets (by query identifier hash)."""
    if num_processes <= 1:
        yield from recordsets
        return
    for rset in recordsets:
        if shard_of(rset[0].query_identifier, num_processes) == process_id:
            yield rset


def merge_gff3_parts(part_paths, out_path, chunk_lines: int = 200_000) -> None:
    """Merge per-host GFF3 parts, keeping one header, sorted by query id
    with `LC_ALL=C sort -k1,1` semantics — the reference's documented merge
    (FAQ#9 + binning-blast.bash:113, which is an external sort for exactly
    this reason).  Bounded memory: lines stream through the pipeline's
    external merge sort (sorted tempfile runs + k-way heap merge), never
    holding more than `chunk_lines` in memory, so the multi-host merge
    honors the same config-5-scale contract as the single-host path."""
    import tempfile

    from ..pipeline.workflows import _MergeSortWriter

    with open(out_path, "w") as fh, \
            tempfile.TemporaryDirectory(prefix="taxtk-merge-") as tmpdir:
        fh.write("##gff-version 3\n")
        w = _MergeSortWriter(fh, tmpdir, chunk_lines=chunk_lines)
        for p in part_paths:
            with open(p) as src:
                for line in src:
                    if not line.startswith("#") and line.strip():
                        w.write(line if line.endswith("\n") else line + "\n")
        w.finish()

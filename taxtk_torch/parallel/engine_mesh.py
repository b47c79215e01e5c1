"""Port of taxtk/parallel/engine_mesh.py: the collective pass-0 merge of
the dp x tp mesh RPA engine.

The division of labour is taxtk's:

1. **Alignment rounds** need no collectives — every pair's distance is
   disjoint — so each grid cell runs the single-device dispatch on its
   own pairs (``BatchAligner._dispatch_mesh``, engine/aligner.py), which
   routes each pair to the tp column owning its reference sequence
   (``refpack_shard_of``) and to a dp row by a stable hash of its text.

2. **Pass-0 merge** — the reference reduces pass-0 candidates
   sequentially: the best candidate under the (distance asc, similarity
   desc, score desc, input order asc) tie-break
   (reference: taxonpredictionmodelsequence.hh:542-546), the LCA over
   co-optimal references (:553-562 → ``rtax``), the LCA over all
   reference nodes and the max support (:547-549).  Here the per-record
   tables live on the grid (records on their refpack shard's tp column,
   split over dp within a column) and each reduction is a segment
   reduction per cell (``scatter_reduce``, the counterpart of
   ``jax.ops.segment_min/max``) followed by an all-reduce over every cell
   (parallel/mesh.py::all_reduce, the counterpart of a shard_map
   pmin/pmax over ("tp", "dp")).  The host replay reads these merged
   values.

One process drives every cell, as in taxtk: torch.distributed's
process-per-rank model would replay the whole engine on every rank, NCCL
cannot put two ranks on one card, and taxtk's mesh is one process.
taxtk's ``_merge_cache`` of jitted steps has no counterpart: nothing here
compiles.

All reductions are exact (float32 equality on the values the host would
compare; edit distances are integers), so the engine's GFF3 is
byte-identical to the single-device run.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .mesh import Mesh, all_reduce, _Paths

FLT_MAX = np.float32(np.finfo(np.float32).max)
_BIG_I32 = np.int32(1 << 30)
_I32 = torch.iinfo(torch.int32)


def _pow2ceil(x: int, minimum: int = 1) -> int:
    n = minimum
    while n < x:
        n <<= 1
    return n


def _identity(op: str, dtype) -> float:
    """jax.ops.segment_min/max's value of an empty segment."""
    if dtype == torch.float32:
        return float("inf") if op == "amin" else float("-inf")
    return _I32.max if op == "amin" else _I32.min


def _segment(op: str, values: torch.Tensor, seg: torch.Tensor,
             n: int) -> torch.Tensor:
    """Segment min or max ("amin" / "amax") of values [r] or [r, D] over
    seg [r] into n segments."""
    out = torch.full((n,) + tuple(values.shape[1:]),
                     _identity(op, values.dtype), dtype=values.dtype,
                     device=values.device)
    index = seg if values.dim() == 1 else seg[:, None].expand_as(values)
    return out.scatter_reduce(0, index, values, op, include_self=True)


class MeshEngineBackend:
    """Holds the mesh and the taxonomy path matrix (one copy per device of
    the grid) and runs the pass-0 merge."""

    def __init__(self, mesh: Mesh, path_matrix: np.ndarray):
        self.mesh = mesh
        self.dp = int(mesh.shape["dp"])
        self.tp = int(mesh.shape["tp"])
        self._paths = _Paths(path_matrix)

    def pass0_merge(
        self, per_shard_rows: Sequence[List[tuple]], T: int
    ) -> Dict[str, np.ndarray]:
        """per_shard_rows[t] = rows (seg, dist, sim, score, slot, node) of
        the candidate records living on tp shard t; seg in [0, T).
        Returns per-task arrays (sliced to T): best_dist/best_sim/best_score,
        best_slot, rtax, lca_allnodes, support."""
        tp, dp = self.tp, self.dp
        if len(per_shard_rows) != tp:
            raise ValueError(f"{len(per_shard_rows)} shards for tp={tp}")
        Tp = _pow2ceil(max(T, 1))
        Rp = _pow2ceil(max(max((len(r) for r in per_shard_rows), default=1),
                           1))
        Rp = max(Rp, dp)
        if Rp % dp:
            Rp = -(-Rp // dp) * dp

        dist = np.full((tp, Rp), FLT_MAX, np.float32)
        sim = np.full((tp, Rp), -1.0, np.float32)
        score = np.full((tp, Rp), -FLT_MAX, np.float32)
        slot = np.full((tp, Rp), _BIG_I32, np.int32)
        node = np.zeros((tp, Rp), np.int32)
        task = np.full((tp, Rp), Tp, np.int32)  # padding -> dummy segment
        for t, rows in enumerate(per_shard_rows):
            for j, (seg, d, s, sc, sl, nd) in enumerate(rows):
                dist[t, j] = d
                sim[t, j] = s
                score[t, j] = sc
                slot[t, j] = sl
                node[t, j] = nd
                task[t, j] = seg

        # cell (r, t) holds piece r of shard t's rows (taxtk's P("tp", "dp"))
        piece = Rp // dp
        cells = []
        for r, t, dev in self.mesh.cells():
            cols = slice(r * piece, (r + 1) * piece)
            cells.append({
                name: torch.from_numpy(
                    np.ascontiguousarray(arr[t, cols])).to(dev)
                for name, arr in (("dist", dist), ("sim", sim),
                                  ("score", score), ("slot", slot),
                                  ("node", node), ("seg", task))})
        outs = _merge(cells, self._paths, Tp)
        d, s, sc, sl, rtax, alln, sup = (o.cpu().numpy()[:T] for o in outs)
        return dict(
            best_dist=d,
            best_sim=s,
            best_score=sc,
            best_slot=sl,
            rtax=rtax,
            lca_allnodes=alln,
            support=sup,
        )


def _merge(cells, paths: _Paths, Tp: int):
    """The staged reductions over every cell; returns the seven [Tp + 1]
    results on the first cell's device (segment Tp collects padding)."""
    T1 = Tp + 1
    imin, imax = torch.minimum, torch.maximum
    neg = -float(FLT_MAX)

    def reduce(op, per_cell):
        """Segment-reduce each cell's values, all-reduce over the cells;
        the result on each cell's device."""
        parts = [_segment(op, v, x["seg"], T1) for x, v in zip(cells,
                                                                per_cell)]
        return all_reduce(parts, imin if op == "amin" else imax)

    def at_seg(full, x):
        return full[x["seg"].long()]

    # staged lexicographic tie-break (dist asc, sim desc, score desc,
    # slot asc) — reference taxonpredictionmodelsequence.hh:542-546
    d_best = reduce("amin", [x["dist"] for x in cells])
    m1 = [x["dist"] == at_seg(b, x) for x, b in zip(cells, d_best)]
    s_best = reduce("amax", [torch.where(m, x["sim"], -1.0)
                             for x, m in zip(cells, m1)])
    m2 = [m & (x["sim"] == at_seg(b, x))
          for x, m, b in zip(cells, m1, s_best)]
    sc_best = reduce("amax", [torch.where(m, x["score"], neg)
                              for x, m in zip(cells, m2)])
    m3 = [m & (x["score"] == at_seg(b, x))
          for x, m, b in zip(cells, m2, sc_best)]
    slot_best = reduce("amin", [torch.where(m, x["slot"], int(_BIG_I32))
                                for x, m in zip(cells, m3)])

    p = [paths.on(x["node"].device)[x["node"].long()] for x in cells]

    def lca_over(masks):
        pmin = reduce("amin", [torch.where(m[:, None], pc, int(_BIG_I32))
                               for m, pc in zip(masks, p)])[0]
        pmax = reduce("amax", [torch.where(m[:, None], pc, -1)
                               for m, pc in zip(masks, p)])[0]
        agree = (pmin == pmax) & (pmin >= 0)
        depth = torch.clamp(
            torch.cumprod(agree.to(torch.int32), 1).sum(1) - 1, min=0)
        return pmin.gather(1, depth[:, None])[:, 0]

    rtax = lca_over(m3)  # LCA over co-optimal refs (:553-562)
    valid = [x["seg"] < Tp for x in cells]
    allnodes = lca_over(valid)  # LCA over all reference nodes (:548)
    support = reduce("amax", [  # max int-truncated similarity (:547)
        torch.where(v, torch.floor(x["sim"]).to(torch.int32), -1)
        for x, v in zip(cells, valid)])
    return (d_best[0], s_best[0], sc_best[0], slot_best[0], rtax, allnodes,
            support[0])

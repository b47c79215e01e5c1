"""Port of taxtk/parallel/mesh.py: the dp x tp device grid and the
multi-device classification step, on PyTorch.

taxtk shards the engine over a `jax.sharding.Mesh` with two axes:

  dp  (query/data parallel)   — record-set batches split over the rows;
  tp  (refpack parallel)      — candidate segments split over the columns
                                (each column holds part of the refpack),
                                their per-column reductions merged before
                                placement.

Here a `Mesh` is a [dp, tp] grid of `torch.device`, and one process drives
every cell (single-controller, as taxtk's mesh is).  A grid may name one
device more than once: the CPU tests use [cpu] * 8, the counterpart of
taxtk's 8 virtual CPU devices, and one card can rehearse a grid of
cuda:0 cells.  Each of taxtk's shard_map collectives (`pmin`/`pmax` over an
axis) becomes `all_reduce`: the cells' partials are reduced on the first
cell's device and the result is copied back to each cell's device.

The merge implements the reference's sequential reductions:
  * best-candidate selection with the (distance asc, similarity desc, slot
    asc) tie-break (taxonpredictionmodelsequence.hh:542-546) as staged
    min/max reductions;
  * LCA over candidate taxa as min/max over ancestor-path columns — the
    LCA of a set is the deepest depth at which min(path) == max(path).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.dna_wavefront import batched_edit_distance_wavefront

_BIG = 1 << 30


class Mesh:
    """A [dp, tp] grid of devices: `devices[r][c]` is cell (r, c)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        tp = len(self.devices[0]) if self.devices else 0
        if not tp or any(len(row) != tp for row in self.devices):
            raise ValueError("a mesh needs a non-empty rectangular grid")
        self.shape = {"dp": len(self.devices), "tp": tp}

    def cells(self):
        """(r, c, device) of every cell, row by row."""
        return [(r, c, d) for r, row in enumerate(self.devices)
                for c, d in enumerate(row)]


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              devices=None) -> Mesh:
    """A mesh over the first n_devices of `devices` (default: every
    visible CUDA device, cuda:0 ... cuda:{k-1}).  tp defaults to taxtk's
    rule: 2 when n is even and at least 4, else 1."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"a mesh of {n} devices needs {n}; "
                         f"{len(devs)} given")
    devs = devs[:n]
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // tp
    if dp * tp != n:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    return Mesh([devs[r * tp:(r + 1) * tp] for r in range(dp)])


def all_reduce(parts: List[torch.Tensor], op) -> List[torch.Tensor]:
    """The reduction by `op` (torch.minimum or torch.maximum) of the
    cells' partials `parts`, computed on the first part's device and
    returned as one copy on each part's device: the counterpart of a
    shard_map pmin/pmax over the cells' axis.  Exact for min and max."""
    home = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(home))
    return [acc if p.device == home else acc.to(p.device) for p in parts]


def _pairwise_distances(queries, refs, q_len, r_len, device):
    """queries [b, L], refs [b, s, L] uint8 numpy, lengths int32 -> int32
    distances [b, s] on `device`: the min-plus wavefront (row 6's CUDA
    kernel on a card, its plain version on the CPU)."""
    b, s, L = refs.shape
    a = np.repeat(queries, s, axis=0)
    al = np.repeat(q_len, s, axis=0)
    dist, _ = batched_edit_distance_wavefront(
        a, refs.reshape(b * s, L), al, r_len.reshape(b * s), device=device,
        lazy="device")
    return dist.reshape(b, s)


class _Paths:
    """The taxonomy path matrix, one copy per device of the grid."""

    def __init__(self, path_matrix):
        self.host = torch.from_numpy(np.asarray(path_matrix, np.int32))
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = self.host.to(device)
        return t


def _lca_of(pmin: torch.Tensor, pmax: torch.Tensor) -> torch.Tensor:
    """Per row, the path entry at the deepest depth where the set's min
    and max paths agree (numpy's wrap of index -1, as jnp's
    take_along_axis does)."""
    agree = (pmin == pmax) & (pmin >= 0)
    depth = torch.cumprod(agree.to(torch.int32), 1).sum(1) - 1
    depth = torch.remainder(depth, pmin.shape[1])
    return pmin.gather(1, depth[:, None])[:, 0].to(torch.int32)


def distributed_classify_step(mesh: Mesh, path_matrix: np.ndarray):
    """The multi-device classification step.  Returns step(queries, q_len,
    refs, r_len, r_node, r_ident) on global numpy arrays:

      queries  [B, L]    uint8 codes, rows split over dp
      q_len    [B]       int32
      refs     [B, S, L] uint8 codes, rows over dp, slots over tp
      r_len    [B, S]    int32
      r_node   [B, S]    int32 taxon indices
      r_ident  [B, S]    int32 search identities

    Per query: best distance, best (global) candidate slot, and the LCA
    over candidates within the best distance, as int32 numpy [B] — each
    cell computes its local reductions on its device and the rows of a dp
    row merge across its tp cells (all_reduce)."""
    paths = _Paths(path_matrix)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    imin, imax = torch.minimum, torch.maximum

    def step(queries, q_len, refs, r_len, r_node, r_ident):
        B, S, L = refs.shape
        if B % dp or S % tp:
            raise ValueError(f"[{B}, {S}] does not split over {mesh.shape}")
        b, s = B // dp, S // tp
        outs = []
        for r, row in enumerate(mesh.devices):
            rows = slice(r * b, (r + 1) * b)
            cells = []
            for c, dev in enumerate(row):
                cols = slice(c * s, (c + 1) * s)
                dist = _pairwise_distances(
                    queries[rows], refs[rows, cols], q_len[rows],
                    r_len[rows, cols], dev)
                cells.append(dict(
                    dist=dist,
                    ident=torch.from_numpy(
                        np.ascontiguousarray(r_ident[rows, cols])).to(dev),
                    node=torch.from_numpy(
                        np.ascontiguousarray(r_node[rows, cols])).to(dev),
                    slot=(torch.arange(s, dtype=torch.int32, device=dev)
                          + c * s).expand(b, s)))
            best_dist = all_reduce([x["dist"].amin(1) for x in cells], imin)
            m1 = [x["dist"] == bd[:, None]
                  for x, bd in zip(cells, best_dist)]
            best_ident = all_reduce(
                [torch.where(m, x["ident"], -1).amax(1)
                 for x, m in zip(cells, m1)], imax)
            best_slot = all_reduce(
                [torch.where(m & (x["ident"] == bi[:, None]), x["slot"],
                             _BIG).amin(1)
                 for x, m, bi in zip(cells, m1, best_ident)], imin)
            # LCA over candidates with dist <= best_dist (co-optimal set)
            pmin, pmax = [], []
            for x, bd in zip(cells, best_dist):
                cand = paths.on(x["dist"].device)[x["node"].long()]
                mask = (x["dist"] <= bd[:, None])[..., None]
                pmin.append(torch.where(mask, cand, _BIG).amin(1))
                pmax.append(torch.where(mask, cand, -1).amax(1))
            lca = _lca_of(all_reduce(pmin, imin)[0],
                          all_reduce(pmax, imax)[0])
            outs.append([t.cpu().numpy().astype(np.int32) for t in
                         (best_dist[0], best_slot[0], lca)])
        return tuple(np.concatenate(col) for col in zip(*outs))

    return step


def dryrun_step(mesh: Mesh, path_matrix: np.ndarray, B=None, S=None, L=32):
    """Run one small distributed classification step on the given mesh,
    with taxtk's data (RandomState(0), the same draws in the same order).
    Returns (best_dist, best_slot, lca, inputs)."""
    dp = mesh.shape["dp"]
    tp = mesh.shape["tp"]
    B = B or dp * 2
    S = S or tp * 2
    rng = np.random.RandomState(0)
    queries = rng.randint(0, 4, (B, L)).astype(np.uint8)
    q_len = np.full(B, L, np.int32)
    refs = rng.randint(0, 4, (B, S, L)).astype(np.uint8)
    r_len = np.full((B, S), L, np.int32)
    n_nodes = path_matrix.shape[0]
    r_node = rng.randint(0, n_nodes, (B, S)).astype(np.int32)
    r_ident = rng.randint(1, L, (B, S)).astype(np.int32)
    step = distributed_classify_step(mesh, path_matrix)
    best_dist, best_slot, lca = step(queries, q_len, refs, r_len, r_node,
                                     r_ident)
    return (best_dist, best_slot, lca,
            dict(queries=queries, q_len=q_len, refs=refs, r_len=r_len,
                 r_node=r_node, r_ident=r_ident))

"""On a card: the reference's CUDA-graph edit distances equal its eager
CPU ones."""

import numpy as np
import pytest

from taxbench import ref_align


@pytest.mark.cuda
def test_graph_edit_distances_equal_eager():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(40):
        a = rng.integers(0, 4, int(rng.integers(1, 5000)))
        b = np.concatenate([a, rng.integers(0, 4, 800)])[
            : int(rng.integers(1, 5000))].copy()
        mut = rng.random(len(b)) < 0.15
        b[mut] = rng.integers(0, 4, mut.sum())
        pairs.append((a, b))
    assert (ref_align.edit_distances(pairs, "cuda")
            == ref_align.edit_distances(pairs, "cpu")).all()

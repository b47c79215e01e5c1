"""The comparison fails what it has to fail: the control (the reference's
values through bfloat16) and faults planted under the timed path."""

import contextlib
from unittest import mock

import numpy as np
import pytest

from tiny_mixes import TINY
from taxbench import control, run


@pytest.mark.parametrize("cell", list(TINY))
def test_control_is_not_correct(cell):
    res = control.readings(cell, 2**31 + 11, 0.1, "cpu", traffic=TINY[cell])
    got = {k: c["value"] for k, c in res["checks"].items()}
    assert not res["correct"]
    assert got["pairs_compared"] > 0
    assert got["pairs_differing"] > 0


@contextlib.contextmanager
def _altered_answer(**_):
    """One realigned distance of each round, off by one where the aligner
    produces it."""
    from taxtk_torch.engine.aligner import BatchAligner
    from taxtk_torch.models.rpa import AlignValue

    real = BatchAligner.align_pairs

    def align_pairs(self, pairs, shard_ids=None, deferred=False):
        finish = real(self, pairs, shard_ids=shard_ids, deferred=True)

        def altered():
            vals = finish()
            v = vals[0]
            vals[0] = AlignValue(v.distance + np.float32(1), v.similarity)
            return vals
        return altered if deferred else altered()

    with mock.patch.object(BatchAligner, "align_pairs", align_pairs):
        yield


@contextlib.contextmanager
def _half_left_out(**_):
    """Every other record set never reaches the engine."""
    from taxtk_torch.pipeline import workflows

    real = workflows.iter_record_sets

    def every_other(*a, **kw):
        for k, rs in enumerate(real(*a, **kw)):
            if k % 2 == 0:
                yield rs

    with mock.patch.object(workflows, "iter_record_sets", every_other):
        yield


@contextlib.contextmanager
def _state_unchanged(**_):
    """Each round hands back its first pair's value for every pair."""
    from taxtk_torch.engine.aligner import BatchAligner

    real = BatchAligner.align_pairs

    def align_pairs(self, pairs, shard_ids=None, deferred=False):
        finish = real(self, pairs, shard_ids=shard_ids, deferred=True)

        def stale():
            vals = finish()
            return [vals[0]] * len(vals)
        return stale if deferred else stale()

    with mock.patch.object(BatchAligner, "align_pairs", align_pairs):
        yield


@pytest.mark.parametrize("fault", [_altered_answer, _half_left_out,
                                   _state_unchanged])
def test_planted_fault_is_not_correct(fault):
    res = run.run_cell("dna-long", 2**31 + 5, 0.1, 0, device="cpu",
                       traffic=TINY["dna-long"], fault=fault)
    assert not res["correct"], res["checks"]

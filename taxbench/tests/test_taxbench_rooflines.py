"""The rooflines' bounds against counts made by hand."""

import numpy as np
import pytest

from taxbench import bounds


def test_myers_bound_hand_count():
    rate = 1e12
    # two pairs and one trailing 1 x 1 dummy row; 2-bit codes
    a_len = np.array([100, 3000, 1])
    b_len = np.array([1000, 2000, 1])
    ops = 13 * (1000 * 4 + 3000 * 63)  # n x ceil(m / 32) words
    nbytes = (250 + 750) + (4 + 63) * 5 * 4 + 2 * 5 * 4
    assert bounds.myers_bound_s(a_len, b_len, 2, rate) == pytest.approx(
        max(ops / rate, nbytes / bounds.MEM_RATE), rel=1e-12)


def test_myers_bound_bytes_bound_at_a_slow_memory():
    a_len, b_len = np.array([32]), np.array([32])
    ops = 13 * 32 * 1
    nbytes = 8 + 20 + 20
    assert bounds.myers_bound_s(a_len, b_len, 2, 1e30) == pytest.approx(
        nbytes / bounds.MEM_RATE)
    assert ops / 1e30 < nbytes / bounds.MEM_RATE


@pytest.mark.parametrize("M, N, per_cell", [(256, 256, 6.5),
                                            (2048, 2048, 9)])
def test_protein_bound_hand_count(M, N, per_cell):
    rate = 1e12
    a_len = np.array([200, 120, 1, 1])
    b_len = np.array([210, 100, 1, 1])
    ops = per_cell * (200 * 210 + 120 * 100)
    assert bounds.swar_fits(M, N) == (per_cell == 6.5)
    assert bounds.protein_bound_s(a_len, b_len, M, N, rate) == (
        pytest.approx(ops / rate, rel=1e-12))

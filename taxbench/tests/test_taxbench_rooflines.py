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


def test_template_args_of_a_launch():
    assert bounds.template_args(
        "void myers_systolic_kernel<2, 3>(signed char const*, int)") == (2, 3)
    assert bounds.template_args("myers_short_kernel<64, 2, 4>") == (64, 2, 4)
    with pytest.raises(ValueError):
        bounds.template_args("myers_short_kernel(int)")


@pytest.mark.parametrize("kernel, names, bits", [
    ("myers_systolic", ["myers_systolic_kernel<2, 3>(int)",
                        "myers_systolic_kernel<4, 2>(int)"], (2, 4)),
    ("myers_short", ["myers_short_kernel<64, 2, 4>(int)",
                     "myers_short_kernel<16, 1, 2>(int)"], (4, 2)),
])
def test_roofline_takes_bits_from_each_launch(kernel, names, bits):
    """The k-th launch in the trace is the k-th entry call; each call's
    bound counts the bits its launch's template names."""
    from taxbench import readers, run

    spec = run.Recorder(kernel).spec
    calls = [spec.record(None, None, [100, 1], [3000, 1]),
             spec.record(None, None, [5000], [7000])]
    rate = 1e30  # the bytes bound the calls, and they count the bits
    ctx = {"trace": {"intervals": [("other", 0.0, 9.0),
                                   (names[0], 1.0, 1.5),
                                   (names[1], 2.0, 4.0)]},
           "card": {"int_rate": rate},
           "rooflines": {kernel: {"calls": calls, "kernel": spec.KERNEL,
                                  "bound_s": spec.bound_s}}}
    want = (bounds.myers_bound_s([100], [3000], bits[0], rate)
            + bounds.myers_bound_s([5000], [7000], bits[1], rate))
    assert readers.roofline_pct(ctx, kernel) == pytest.approx(
        100.0 * want / 2.5, rel=1e-12)
    assert want != (bounds.myers_bound_s([100], [3000], bits[1], rate)
                    + bounds.myers_bound_s([5000], [7000], bits[0], rate))

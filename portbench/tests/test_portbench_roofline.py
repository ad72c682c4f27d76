"""The outer stage's counts, pinned at NANOGrav 15-year's Pm = 1,876."""

import pytest

from portbench import roofline


def test_outer_counts_at_pm_1876():
    n = 67 * 28
    assert n == 1876
    assert roofline.gwb_outer_flops(67, 28) == pytest.approx(
        1876 ** 3 / 3 + 2 * 1876 ** 2)
    assert roofline.gwb_outer_flops(67, 28) == pytest.approx(
        2_207_821_877.3333335, rel=1e-12)
    assert roofline.gwb_outer_bytes(67, 28) == 8 * (67 * 784 + 1876 + 4489
                                                    + 3)
    # flop-bound: 32.95 us a point at 67 TFLOP/s
    least = roofline.gwb_outer_least_s(67, 28, 1)
    assert least == pytest.approx(2_207_821_877.3333335 / 67e12, rel=1e-12)
    assert roofline.gwb_outer_least_s(67, 28, 8) == pytest.approx(8 * least)


def test_peaks_are_the_data_sheet():
    assert roofline.PEAKS == {"f64_tensor_flops": 67e12,
                              "f64_flops": 34e12,
                              "hbm_bytes_per_s": 3.35e12}

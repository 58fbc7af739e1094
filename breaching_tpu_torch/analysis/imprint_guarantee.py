"""Expected recovery of imprint attacks (counterpart of
``breaching_tpu/analysis/imprint_guarantee.py``; reference imprint_guarantee.py:4-28):
with n data points hashed into k bins of equal mass, a data point is recovered exactly
when it is alone in its bin."""

from __future__ import annotations


def probability_of_recovery(num_data_points: int, num_bins: int) -> float:
    """P(a given data point is alone in its bin) = (1 - 1/k)^(n-1)."""
    if num_bins <= 0:
        return 0.0
    return (1.0 - 1.0 / num_bins) ** (num_data_points - 1)


def expected_number_of_recovered_points(num_data_points: int, num_bins: int) -> float:
    """E[data points alone in their bin] = n (1 - 1/k)^(n-1)."""
    return num_data_points * probability_of_recovery(num_data_points, num_bins)


def expected_number_of_breached_bins(num_data_points: int, num_bins: int) -> float:
    """E[bins that hold a data point] = k (1 - (1 - 1/k)^n)."""
    if num_bins <= 0:
        return 0.0
    return num_bins * (1.0 - (1.0 - 1.0 / num_bins) ** num_data_points)

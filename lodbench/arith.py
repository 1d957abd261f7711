"""The arithmetic the metric readers share."""
from __future__ import annotations

import math

# NVIDIA H100 SXM (80 GB HBM3): the data sheet's memory bandwidth, at the
# card's full power limit of 700 W
HBM_BYTES_PER_S = 3.35e12


def rate(amount: float, seconds: float) -> float:
    """Work a second over a window."""
    return amount / seconds


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def idle_pct(busy_s: float, window_s: float) -> float:
    """The share of a window in which the device ran nothing (%)."""
    return 100.0 * (1.0 - busy_s / window_s)


def splat_bytes(drawn_samples: int, pixels: int) -> int:
    """The bytes a frame's raster work needs, whatever draws it: each drawn
    sample's 16 B (position words and colour) read once, each pixel's 8 B
    (depth and colour) written once."""
    return 16 * drawn_samples + 8 * pixels


def roofline_pct(nbytes: int, device_s: float) -> float:
    """The least time the bytes take at the card's bandwidth, as a share of
    the measured device time (%)."""
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / device_s

"""Lidar scan CSV parsing.

Port of :func:`icp_tpu.io.scan_csv.parse_lidar_scan_array` (after
``common/parse_scan.cpp:18-50``), in plain Python and numpy: each line is
``x,y``; unparsable rows and rows with a non-finite coordinate (lidar
no-returns) are dropped.
"""

from __future__ import annotations

import math

import numpy as np


def parse_lidar_scan_array(path: str) -> np.ndarray:
    """Parse a scan CSV into an ``(n, 2)`` float64 array of finite points."""
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            x_str, _, y_str = line.partition(",")
            try:
                x = float(x_str)
                y = float(y_str)
            except ValueError:
                continue
            if not (math.isfinite(x) and math.isfinite(y)):
                continue  # ``parse_scan.cpp:37-39`` (and NaN)
            rows.append((x, y))
    return np.asarray(rows, dtype=np.float64).reshape(-1, 2)

"""Polar lidar sweep (.conf) ingestion, the rosbag-extraction format.

Port of :mod:`icp_tpu.io.scan_conf`.  The reference's
``script/rosbag_extract.py:111-119`` exports LaserScan sweeps as
``key = value`` files: ``angle_min/angle_max/angle_increment/length/
range_min/range_max``, then ``i = range_i`` lines.  A sweep becomes the
Cartesian points ``(r_i cos(angle_min + i*increment), r_i sin(...))`` of its
finite, in-range returns, in angular order.
"""

from __future__ import annotations

import numpy as np

from ..cloud import PointCloud, from_points


def parse_sweep_conf(path: str) -> dict:
    """Parse a sweep conf file into its header fields and a ``ranges`` array
    (+inf where a return is missing)."""
    header: dict[str, float] = {}
    ranges: dict[int, float] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip()
            if key.isdigit():
                ranges[int(key)] = float(value)
            else:
                header[key] = float(value)
    length = int(header.get("length", len(ranges)))
    r = np.full(length, np.inf)
    for i, v in ranges.items():
        if 0 <= i < length:
            r[i] = v
    return {**header, "ranges": r}


def sweep_to_points(sweep: dict) -> np.ndarray:
    """A parsed sweep's valid returns as an ``(n, 2)`` float64 array."""
    r = sweep["ranges"]
    n = len(r)
    inc = sweep.get(
        "angle_increment",
        (sweep["angle_max"] - sweep["angle_min"]) / max(n - 1, 1),
    )
    angles = sweep["angle_min"] + inc * np.arange(n)
    valid = np.isfinite(r)
    if "range_min" in sweep:
        valid &= r >= sweep["range_min"]
    if "range_max" in sweep:
        valid &= r <= sweep["range_max"]
    r = r[valid]
    angles = angles[valid]
    return np.stack([r * np.cos(angles), r * np.sin(angles)], axis=-1)


def parse_sweep(
    path: str, capacity: int | str | None = None, dtype=None, device="cuda"
) -> PointCloud:
    """Read a .conf sweep into a padded cloud, angular order kept (which
    ``feature_aware``'s window features need).  On the card unless
    ``device="cpu"``; ``capacity`` and ``dtype`` as in
    :func:`~icp_tpu_torch.cloud.from_points`."""
    points = sweep_to_points(parse_sweep_conf(path))
    return from_points(points, capacity=capacity, dtype=dtype, device=device)

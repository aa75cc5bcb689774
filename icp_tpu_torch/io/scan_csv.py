"""Lidar scan CSV parsing.

Port of :mod:`icp_tpu.io.scan_csv` (after ``common/parse_scan.cpp:18-50``):
each line is ``x,y``; unparsable rows and rows with a non-finite coordinate
(lidar no-returns) are dropped.  As in the JAX package, the native C++
loader (``native/``, through :mod:`icp_tpu_torch.utils.native`) parses
when the library is built: one file in :func:`parse_lidar_scan_array`, many
on threads in :func:`parse_lidar_scan_batch` with an int ``capacity``.
Without the library, or when it reports an error, the Python parser runs
and gives the same arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cloud import PointCloud, bucket_capacity, from_points, round_up
from ..geometry import default_dtype
from ..utils.native import native_lib


def parse_lidar_scan_array(path: str) -> np.ndarray:
    """Parse a scan CSV into an ``(n, 2)`` float64 array of finite points."""
    lib = native_lib()
    if lib is not None:
        pts = lib.parse_scan_csv(path)
        if pts is not None:
            return pts
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


def parse_lidar_scan(
    path: str, capacity: int | str | None = None, dtype=None, device="cuda"
) -> PointCloud:
    """Parse a scan CSV into a padded cloud, on the card unless
    ``device="cpu"``; ``capacity`` and ``dtype`` as in
    :func:`~icp_tpu_torch.cloud.from_points`."""
    points = parse_lidar_scan_array(path)
    return from_points(points, capacity=capacity, dtype=dtype, device=device)


def parse_lidar_scan_batch(
    paths, capacity: int | str | None = None, dtype=None, device="cuda"
) -> PointCloud:
    """Load many scan CSVs into one batched padded cloud ``(T, N, 2)``.

    ``capacity=None`` pads to the largest scan rounded up to a multiple of 8,
    ``"bucket"`` to the power-of-two bucket of the largest scan
    (:func:`~icp_tpu_torch.cloud.bucket_capacity`), an int to itself (a scan
    that does not fit raises).  With an int ``capacity`` the native loader
    parses the files on threads when it is built.  On the card unless
    ``device="cpu"``; ``dtype`` defaults to float64 on the CPU and float32
    elsewhere.
    """
    paths = list(paths)
    if not paths:
        raise ValueError("parse_lidar_scan_batch: empty path list")
    dtype = default_dtype(device) if dtype is None else dtype
    got = None
    if capacity is not None and capacity != "bucket":
        lib = native_lib()
        if lib is not None:
            got = lib.parse_scan_batch(paths, capacity)
    if got is None:
        arrays = [parse_lidar_scan_array(p) for p in paths]
        largest = max(len(a) for a in arrays)
        if capacity == "bucket":
            capacity = bucket_capacity(largest)
        elif capacity is None:
            capacity = max(round_up(largest, 8), 8)
        out = np.zeros((len(arrays), capacity, 2))
        counts = np.zeros(len(arrays), dtype=np.int32)
        for i, a in enumerate(arrays):
            if len(a) > capacity:
                raise ValueError(f"{paths[i]}: {len(a)} points exceed capacity {capacity}")
            out[i, : len(a)] = a
            counts[i] = len(a)
    else:
        out, counts = got
    return PointCloud(
        torch.tensor(out, dtype=dtype, device=device),
        torch.tensor(counts, dtype=torch.int32, device=device),
    )

"""Masked, padded point-cloud container.

Port of :mod:`icp_tpu.cloud`.  A cloud is a fixed-capacity ``(..., N, D)``
tensor with its valid points packed at the front and a per-lane ``count``;
the boolean mask is derived from the count and padding slots hold zeros.
Front packing matters to methods whose windows assume angular point order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .geometry import default_dtype


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def bucket_capacity(n: int, min_capacity: int = 64) -> int:
    """Smallest power-of-two capacity >= ``n`` (floored at ``min_capacity``)."""
    cap = max(int(min_capacity), 1)
    n = int(n)
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-capacity point cloud: ``points (..., N, D)``, ``count (...,)`` int32."""

    points: torch.Tensor  # (..., N, D)
    count: torch.Tensor  # (...,) int32, number of valid (front-packed) points

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def dim(self) -> int:
        return self.points.shape[-1]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.points.shape[:-2])

    @property
    def dtype(self) -> torch.dtype:
        return self.points.dtype

    @property
    def mask(self) -> torch.Tensor:
        """Boolean validity mask ``(..., N)`` derived from ``count``."""
        idx = torch.arange(self.capacity, dtype=torch.int32, device=self.points.device)
        return idx < self.count[..., None]


def from_points(
    points,
    capacity: int | str | None = None,
    dtype: torch.dtype | None = None,
    device="cuda",
    pad_multiple: int = 8,
) -> PointCloud:
    """Build a cloud from an ``(N, D)`` array, padding to ``capacity``.

    Non-finite rows are dropped first (the reference's inf filter,
    ``common/parse_scan.cpp:37-39``).  ``capacity`` defaults to ``N`` rounded
    up to ``pad_multiple``; ``"bucket"`` pads to the next power of two.
    The cloud lands on the card unless ``device="cpu"`` is passed; ``dtype``
    defaults to float64 on the CPU and float32 elsewhere.
    """
    dtype = default_dtype(device) if dtype is None else dtype
    pts = torch.tensor(np.asarray(points), dtype=dtype, device=device)
    if pts.dim() != 2:
        raise ValueError("from_points expects an (N, D) array; build batches with stack")
    pts = pts[torch.isfinite(pts).all(dim=-1)]
    n = pts.shape[0]
    if capacity == "bucket":
        cap = bucket_capacity(n)
    elif capacity is not None:
        cap = int(capacity)
    else:
        cap = max(round_up(n, pad_multiple), pad_multiple)
    if n > cap:
        raise ValueError(f"{n} points exceed capacity {cap}")
    padded = torch.zeros((cap, pts.shape[1]), dtype=dtype, device=device)
    padded[:n] = pts
    return PointCloud(padded, torch.tensor(n, dtype=torch.int32, device=device))


def stack(clouds: list[PointCloud]) -> PointCloud:
    """Stack clouds into one batched cloud along a new axis 0 (padding to the
    largest capacity)."""
    cap = max(c.capacity for c in clouds)
    clouds = [pad_to(c, cap) for c in clouds]
    return PointCloud(
        torch.stack([c.points for c in clouds]), torch.stack([c.count for c in clouds])
    )


def pad_to(cloud: PointCloud, capacity: int) -> PointCloud:
    """Grow a cloud's padded capacity (no-op if already at capacity)."""
    if cloud.capacity == capacity:
        return cloud
    if cloud.capacity > capacity:
        raise ValueError(f"cannot shrink capacity {cloud.capacity} -> {capacity}")
    pad = torch.nn.functional.pad(cloud.points, (0, 0, 0, capacity - cloud.capacity))
    return PointCloud(pad, cloud.count)


def to_numpy(cloud: PointCloud) -> np.ndarray:
    """The valid points of an unbatched cloud as an ``(n, D)`` array."""
    if cloud.batch_shape:
        raise ValueError("to_numpy expects an unbatched cloud")
    n = int(cloud.count)
    return cloud.points[:n].cpu().numpy()

"""Point-cloud preprocessing filters.

Port of :mod:`icp_tpu.ops.filters`.  Filters keep the cloud's fixed
capacity and its front-packed validity: removed points are compacted out
and the count drops.
"""

from __future__ import annotations

import torch

from ..cloud import PointCloud
from .nn import pairwise_sq_dists


def remove_statistical_outliers(
    cloud: PointCloud, k: int = 8, std_ratio: float = 2.0
) -> PointCloud:
    """Statistical outlier removal (the PCL filter): drop the points whose
    mean distance to their k nearest neighbours exceeds ``mean + std_ratio *
    std`` of that distance over the cloud.

    The survivors are compacted to the front in their original order (a
    stable sort on the drop flag) and the rest of the capacity is zeroed.
    A cloud of ``count <= k`` points has only ``count - 1`` real neighbours
    per point; the slots beyond hold masked sentinels and stay out of the
    statistics.  Batched over leading dims.
    """
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    points, mask = cloud.points, cloud.mask
    capacity = points.shape[-2]
    if capacity < 2:
        return cloud  # no neighbours to reason about
    k = min(k, capacity - 1)
    d2 = pairwise_sq_dists(points, points)
    d2 = d2.masked_fill(~mask[..., None, :], torch.finfo(points.dtype).max)
    # The k + 1 smallest include the point itself (distance 0); drop it.
    # Only the values are used, so the order among ties does not matter.
    nearest = torch.topk(d2, k + 1, dim=-1, largest=False, sorted=True).values
    knn_d = torch.sqrt(torch.clamp(nearest[..., 1:], min=0.0))  # (..., N, k)
    n_neighbors = torch.clamp(cloud.count - 1, min=0)
    slot_valid = torch.arange(k, device=points.device) < n_neighbors[..., None, None]
    denom = torch.clamp(n_neighbors, min=1).to(points.dtype)
    mean_d = torch.where(slot_valid, knn_d, 0.0).sum(-1) / denom[..., None]

    w = mask.to(points.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    mu = (mean_d * w).sum(-1) / n
    var = (((mean_d - mu[..., None]) ** 2) * w).sum(-1) / n
    thresh = mu + std_ratio * torch.sqrt(var)

    keep = mask & (mean_d <= thresh[..., None])
    order = torch.sort((~keep).to(torch.int32), dim=-1, stable=True).indices
    packed = torch.take_along_dim(points, order[..., None], -2)
    count = keep.sum(-1).to(torch.int32)
    slots = torch.arange(capacity, device=points.device) < count[..., None]
    return PointCloud(torch.where(slots[..., None], packed, 0.0), count)

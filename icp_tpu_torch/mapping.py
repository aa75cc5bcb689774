"""Local-map maintenance and scan-to-map odometry.

Port of :mod:`icp_tpu.mapping`.  Scan-to-scan chaining accumulates drift
with every step; :func:`scan_to_map_odometry` registers each scan against a
local map aggregated from recent keyframes instead.  The map is a
fixed-capacity world-frame cloud, kept either on the host
(:class:`LocalMap`, numpy) or, with ``device_map=True``, on the scan's
device at fixed shapes (:func:`merge_map_device`).

:func:`voxel_downsample` keeps one point per occupied voxel, the centroid
of its members (the standard grid filter); :func:`voxel_downsample_device`
is the same filter at fixed shapes on tensors.

Method choice: the map always holds regions the current scan does not
see; hard-overlap methods (``trimmed``) can be dragged toward them, and
``robust`` (Welsch) down-weights them.  But in a long corridor, seeded from
the previous pose a sweep behind, ``robust`` can stall: the few points
that constrain the motion along the corridor are the ones its weights
drop.  On ``ex_data/seq1`` (about 0.4 m between sweeps) robust stalls from
sweep ~33 on, in float64 as in float32, while trimmed tracks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import geometry
from .cloud import PointCloud, from_points
from .driver import DriverConfig, converge
from .methods.base import Method


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Centroid-per-voxel grid filter ``(n, D) -> (n', D)`` on the host,
    voxels in ascending cell order (x-major)."""
    pts = np.asarray(points)
    if len(pts) == 0:
        return pts
    keys = np.floor(pts / voxel_size).astype(np.int64)
    order = np.lexsort(keys.T[::-1])
    keys_sorted = keys[order]
    pts_sorted = pts[order]
    new_cell = np.any(np.diff(keys_sorted, axis=0) != 0, axis=1)
    starts = np.concatenate([[0], np.nonzero(new_cell)[0] + 1])
    ends = np.concatenate([starts[1:], [len(pts_sorted)]])
    sums = np.add.reduceat(pts_sorted, starts, axis=0)
    counts = (ends - starts)[:, None].astype(pts.dtype)
    return (sums / counts).astype(pts.dtype)


#: Per-axis bound of the device filter's voxel coordinates: cells are
#: clamped to ``[-2^14, 2^14)`` (at a 0.1 m voxel, a map of ±1.6 km), so
#: a 3D cell packs into 45 bits of one int64 sort key.
_CELL_BOUND = 1 << 14
_INT32_MAX = 2**31 - 1


def voxel_downsample_device(points, mask, voxel_size: float, capacity: int):
    """Centroid-per-voxel filter at fixed shapes, on the points' device.

    ``points (N, D)`` with validity ``mask (N,)`` -> ``(out (capacity, D),
    count)``: the first ``count`` rows are the voxel centroids in ascending
    cell order (the order of :func:`voxel_downsample`), the rest zeros.
    The JAX package's ``lexsort`` on two int32 keys becomes one stable sort
    of the int64 ``(key_hi << 32) | key_lo``, the same order; invalid points
    take ``INT32_MAX`` in both halves and sort last.  Segments start where
    the key changes; the sums are ``index_add_`` (on CUDA its atomic adds
    may reorder the sums within a voxel; cells and counts are exact).

    Cells beyond :data:`_CELL_BOUND` voxels from the origin merge with the
    boundary cell.  If more than ``capacity`` cells are occupied, the
    trailing cells in key order are dropped and ``count`` is ``capacity``.
    """
    n, d = points.shape
    cells = torch.clamp(torch.floor(points / voxel_size), -_CELL_BOUND, _CELL_BOUND - 1)
    cells = cells.to(torch.int64) + _CELL_BOUND
    if d == 2:
        key_hi, key_lo = cells[:, 0], cells[:, 1]
    else:
        key_hi, key_lo = (cells[:, 0] << 15) | cells[:, 1], cells[:, 2]
    key = torch.where(mask, (key_hi << 32) | key_lo, (_INT32_MAX << 32) | _INT32_MAX)
    key_s, order = torch.sort(key, stable=True)
    pts_s = points[order]
    valid_s = mask[order]
    first = torch.ones(n, dtype=torch.bool, device=points.device)
    first[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum(first, 0) - 1  # dense segment ids in sorted order
    w = valid_s.to(points.dtype)
    sums = torch.zeros((n, d), dtype=points.dtype, device=points.device)
    sums.index_add_(0, seg, pts_s * w[:, None])
    cnts = torch.zeros(n, dtype=points.dtype, device=points.device).index_add_(0, seg, w)
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]
    count = torch.clamp((first & valid_s).sum().to(torch.int32), max=capacity)
    if capacity <= n:
        out = centroids[:capacity]
    else:
        out = torch.cat([centroids, centroids.new_zeros((capacity - n, d))])
    slots = torch.arange(capacity, device=points.device) < count
    return torch.where(slots[:, None], out, 0.0), count


def merge_map_device(map_points, map_count, scan_points, scan_mask, voxel_size: float,
                     capacity: int, center):
    """Fixed-shape :meth:`LocalMap.merged_with` on the map's device: concat,
    voxel filter, and (on overflow) keep the ``capacity`` cells nearest
    ``center``.

    ``map_points (capacity, D)`` (the first ``map_count`` valid) and scan
    points ``(N, D)`` with ``scan_mask`` -> ``(new_map (capacity, D),
    new_count)``.  The cells are ordered by distance to ``center`` (the JAX
    package's ``top_k``; here a stable sort, so equal distances keep their
    cell order, as ``top_k`` does), with or without overflow; valid rows
    stay in front, so the result feeds ``PointCloud(points, count)``.
    """
    n_total = map_points.shape[0] + scan_points.shape[0]
    all_pts = torch.cat([map_points, scan_points])
    slots = torch.arange(map_points.shape[0], device=map_points.device)
    all_mask = torch.cat([slots < map_count, scan_mask])
    cells, k = voxel_downsample_device(all_pts, all_mask, voxel_size, n_total)
    valid = torch.arange(n_total, device=cells.device) < k
    d2 = torch.sum((cells - center) ** 2, dim=-1).masked_fill(~valid, float("inf"))
    idx = torch.sort(d2, stable=True).indices[:capacity]
    new_count = torch.clamp(k, max=capacity)
    keep = torch.arange(capacity, device=cells.device) < new_count
    return torch.where(keep[:, None], cells[idx], 0.0), new_count


@dataclasses.dataclass
class LocalMap:
    """World-frame aggregated map of bounded size, on the host."""

    voxel_size: float
    capacity: int
    points: np.ndarray  # (n, D) world frame

    def merged_with(self, scan_world: np.ndarray) -> "LocalMap":
        merged = np.concatenate([self.points, scan_world]) if len(self.points) else scan_world
        merged = voxel_downsample(merged, self.voxel_size)
        if len(merged) > self.capacity:
            # Keep the points nearest the newest scan's centroid.
            center = scan_world.mean(axis=0)
            d = np.linalg.norm(merged - center, axis=1)
            merged = merged[np.argsort(d, kind="stable")[: self.capacity]]
        return LocalMap(self.voxel_size, self.capacity, merged)


def _scan_center(scan: PointCloud) -> torch.Tensor:
    """Mean of the scan's valid points."""
    total = torch.where(scan.mask[:, None], scan.points, 0.0).sum(0)
    return total / torch.clamp(scan.count, min=1)


def _valid_numpy(points: torch.Tensor, count) -> np.ndarray:
    return points[: int(count)].cpu().numpy()


def scan_to_map_odometry(
    scans,
    method: Method,
    config: DriverConfig,
    voxel_size: float = 0.1,
    map_capacity: int = 8192,
    keyframe_translation: float = 0.5,
    keyframe_angle: float = 0.1,
    metrics=None,
    device_map: bool = False,
):
    """Online scan-to-map odometry over an iterable of unbatched clouds;
    yields ``(pose, is_keyframe, result)`` per scan (the first: identity,
    True, None).

    Each scan registers scan -> map, seeded from the previous scan's pose
    (fresher than the keyframe's); the map is in the world frame, so the
    result is the world pose.  A keyframe folds its world-frame points into
    the map.  ``device_map=False`` keeps the map on the host
    (:class:`LocalMap`) and pads it to ``map_capacity`` for each
    registration; ``device_map=True`` keeps it on the scan's device and
    merges with :func:`merge_map_device` (the same map up to the order of
    within-voxel sums and of cells at equal distance).

    Methods with ``precompute`` derive the map's data (normals, surfel
    covariances, NDT maps) once per map revision, not once per scan, and
    the scan's only when the method uses the source's
    (``precompute_source``).
    """
    reuse_aux = method.precompute is not None and method.with_precomputed is not None
    map_aux = None
    local_map: LocalMap | None = None
    dev_map_pts = dev_map_count = None
    kf_pose = prev_pose = None

    def merge_on_device(map_pts, map_count, pose, scan, center):
        return merge_map_device(map_pts, map_count, geometry.apply(pose, scan.points),
                                scan.mask, voxel_size, map_capacity, center)

    for t, scan in enumerate(scans):
        if kf_pose is None:
            dim, device = scan.dim, scan.points.device
            kf_pose = prev_pose = geometry.identity(dim, dtype=scan.dtype, device=device)
            if device_map:
                empty = torch.zeros((map_capacity, dim), dtype=scan.dtype, device=device)
                dev_map_pts, dev_map_count = merge_on_device(
                    empty, torch.zeros((), dtype=torch.int32, device=device), kf_pose, scan,
                    _scan_center(scan))
            else:
                pts = _valid_numpy(scan.points, scan.count)
                # Through merged_with, so the first map respects map_capacity too.
                local_map = LocalMap(voxel_size, map_capacity,
                                     np.zeros((0, dim), dtype=pts.dtype)).merged_with(pts)
            yield kf_pose, True, None
            continue

        if device_map:
            map_cloud = PointCloud(dev_map_pts, dev_map_count)
        else:
            map_cloud = from_points(local_map.points, capacity=map_capacity, dtype=scan.dtype,
                                    device=scan.points.device)
        m = method
        if reuse_aux:
            if map_aux is None:  # the first registration against this map revision
                map_aux = method.precompute(map_cloud)
            src_aux = method.precompute(scan) if method.precompute_source else None
            m = method.with_precomputed(src_aux, map_aux)
        result, _ = converge(m, scan, map_cloud, prev_pose, config)
        pose = prev_pose = result.transform

        delta_t = float(torch.linalg.vector_norm(pose.translation - kf_pose.translation))
        delta_a = abs(float(geometry.rotation_angle(
            torch.matmul(pose.rotation, kf_pose.rotation.transpose(-1, -2)))))
        is_kf = delta_t > keyframe_translation or delta_a > keyframe_angle
        if metrics is not None:
            metrics.log("scan_to_map_step", scan=t, iterations=int(result.iteration_count),
                        cost=float(result.cost), keyframe=is_kf,
                        map_points=int(dev_map_count) if device_map else len(local_map.points))
        if is_kf:
            if device_map:
                world_center = geometry.apply(pose, _scan_center(scan)[None])[0]
                dev_map_pts, dev_map_count = merge_on_device(
                    dev_map_pts, dev_map_count, pose, scan, world_center)
            else:
                world = geometry.apply(pose, scan.points)
                local_map = local_map.merged_with(_valid_numpy(world, scan.count))
            map_aux = None  # the map changed: re-derive its data on the next scan
            kf_pose = pose
        yield pose, is_kf, result

"""Scan Context place-recognition descriptors.

Port of :mod:`icp_tpu.ops.descriptor` (Kim & Kim, IROS 2018).  The
pose-radius loop search trusts the drifted trajectory; these descriptors
match scan appearance instead:

* :func:`scan_context` — one ``(rings, sectors)`` polar grid per scan: 3D
  scans keep each bin's max height (empty bins 0), 2D scans splat their
  occupancy bilinearly over the two nearest sectors.  The binning is a
  ``scatter_reduce_("amax")`` / ``scatter_add_`` into the flat grid.
* :func:`ring_key` — the rotation-invariant per-ring mean.
* :func:`descriptor_query` / :func:`descriptor_distances` — the mean
  column-wise cosine distance, minimized over the ``sectors`` column shifts
  (a yaw hypothesis each): one ``(Q, R·S) x (R·S, K)`` matmul per shift,
  folded by a strict ``<``, so equal distances keep the lowest shift.
* :func:`find_loop_candidates_descriptor` and its incremental form — the
  pairs under a distance threshold, by ascending distance, equal distances
  in row-major pair order (a stable sort of the masked distance matrix).
* :func:`yaw_seeds` — registration seeds from the shifts' yaw estimates.

Not ported: the incremental search's power-of-two padding of both axes,
which only let XLA reuse compiled executables.
"""

from __future__ import annotations

import math

import torch

from ..geometry import RigidTransform

DEFAULT_RINGS = 20
DEFAULT_SECTORS = 60


def _norm(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """``sqrt(sum(x²))`` along ``dim``: ``jnp.linalg.norm``'s own reduction."""
    return torch.sqrt((x * x).sum(dim, keepdim=keepdim))


def scan_context(
    points: torch.Tensor,
    mask: torch.Tensor,
    rings: int = DEFAULT_RINGS,
    sectors: int = DEFAULT_SECTORS,
    max_radius: float | None = None,
    center: str = "origin",
) -> torch.Tensor:
    """Scan Context descriptor of ``points (..., N, D)`` with ``mask
    (..., N)`` -> ``(..., rings, sectors)``.

    ``max_radius`` fixes the radial extent (points beyond it are dropped)
    and must be one constant across every scan that will be compared: pass
    the sensor range.  ``center``: ``"origin"`` (sensor-frame scans, the
    original convention) or ``"centroid"`` (clouds with no sensor frame).
    """
    if max_radius is None:
        raise ValueError(
            "scan_context needs an explicit max_radius (common across all "
            "scans that will be compared)"
        )
    if center not in ("origin", "centroid"):
        raise ValueError(f"center must be 'origin' or 'centroid', got {center!r}")
    batch = points.shape[:-2]
    n, dim = points.shape[-2:]
    pts = points.reshape(-1, n, dim)
    msk = mask.reshape(-1, n)
    b = pts.shape[0]
    dtype, device = pts.dtype, pts.device
    if center == "centroid":
        total = msk.sum(-1, keepdim=True).clamp(min=1)
        c = torch.where(msk[..., None], pts, torch.zeros((), dtype=dtype, device=device)
                        ).sum(-2) / total
        rel = pts - c[:, None, :]
    else:  # sensor frame: the scanner is the origin
        rel = pts
    xy = rel[..., :2]
    r = _norm(xy, -1)
    theta = torch.atan2(xy[..., 1], xy[..., 0])  # [-pi, pi]
    ring = torch.floor(r / max_radius * rings).to(torch.int64)
    in_range = msk & (ring < rings)
    ring = ring.clamp(0, rings - 1)
    nbins = rings * sectors
    if dim == 3:
        # The original Scan Context: the bin's max height, hard-binned.
        sector = torch.floor((theta + math.pi) / (2 * math.pi) * sectors).to(torch.int64)
        sector = sector.clamp(0, sectors - 1)  # theta == +pi lands on S
        bin_id = ring * sectors + sector
        height = torch.where(in_range, rel[..., 2],
                             torch.full((), -math.inf, dtype=dtype, device=device))
        cell = torch.full((b, nbins), -math.inf, dtype=dtype, device=device)
        cell.scatter_reduce_(1, bin_id, height, reduce="amax", include_self=True)
        occupied = torch.zeros((b, nbins), dtype=dtype, device=device)
        occupied.scatter_add_(1, bin_id, in_range.to(dtype))
        cell = torch.where(occupied > 0, cell, torch.zeros((), dtype=dtype, device=device))
        return cell.reshape(*batch, rings, sectors)
    # 2D has no height: occupancy mass, splatted over the two adjacent
    # sectors so that a fractional-sector rotation moves the descriptor
    # smoothly (hard binning flips whole columns of a thin 2D scan).
    sector_f = (theta + math.pi) / (2 * math.pi) * sectors - 0.5
    s0 = torch.floor(sector_f)
    w1 = sector_f - s0
    s0i = torch.remainder(s0.to(torch.int64), sectors)
    s1i = torch.remainder(s0i + 1, sectors)
    wf = in_range.to(dtype)
    cnt = torch.zeros((b, nbins), dtype=dtype, device=device)
    cnt.scatter_add_(1, torch.cat([ring * sectors + s0i, ring * sectors + s1i], dim=-1),
                     torch.cat([wf * (1.0 - w1), wf * w1], dim=-1))
    return cnt.reshape(*batch, rings, sectors)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant ring key ``(..., rings)``: the per-ring mean over
    sectors (a yaw rotation permutes sectors within each ring)."""
    return desc.mean(-1)


def descriptor_query(queries: torch.Tensor, db: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan Context distance of every query against every database entry.

    ``queries (Q, R, S)`` vs ``db (K, R, S)`` -> ``(dist (Q, K), shift (Q, K)
    int32)``: ``dist[q, k]`` is the min-over-shifts mean column-wise cosine
    distance between query q and entry k rolled by ``shift[q, k]`` sectors,
    the yaw hypothesis aligning scan k to scan q (``yaw ~ 2 pi shift / S``).
    Equal distances keep the lowest shift.
    """
    sectors = queries.shape[-1]

    def unitize(d):
        norms = _norm(d, -2, keepdim=True)  # column norms
        return d / torch.clamp(norms, min=torch.finfo(d.dtype).tiny)

    uq = unitize(queries).reshape(queries.shape[0], -1)
    uk = unitize(db)
    best = torch.full((queries.shape[0], db.shape[0]), math.inf, dtype=queries.dtype,
                      device=queries.device)
    arg = torch.zeros(best.shape, dtype=torch.int32, device=queries.device)
    for s in range(sectors):
        rolled = torch.roll(uk, -s, dims=-1).reshape(db.shape[0], -1)
        # Mean cosine distance over all S columns; an empty column's unit
        # vector is 0, so it contributes the full distance 1.
        d = 1.0 - torch.matmul(uq, rolled.T) / sectors
        better = d < best
        best = torch.where(better, d, best)
        arg = torch.where(better, torch.full_like(arg, s), arg)
    return best, arg


def descriptor_distances(descs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All-pairs Scan Context distance over ``descs (T, R, S)``."""
    return descriptor_query(descs, descs)


def _ranked(masked: torch.Tensor, shift: torch.Tensor, k: int, sectors: int, dtype):
    """The ``k`` smallest entries of ``masked`` (stable: ties in row-major
    order), kept where finite: ``(rows, cols, yaw)`` with the yaw wrapped
    to ``(-pi, pi]``."""
    cols = masked.shape[1]
    vals, order = torch.sort(masked.reshape(-1), stable=True)
    order, valid = order[:k], torch.isfinite(vals[:k])
    order = order[valid]
    yaw = shift.reshape(-1)[order].to(dtype) * (2 * math.pi / sectors)
    yaw = torch.where(yaw > math.pi, yaw - 2 * math.pi, yaw)
    return order // cols, order % cols, yaw


def find_loop_candidates_descriptor(
    descs: torch.Tensor,
    max_distance: float,
    min_separation: int = 10,
    max_candidates: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate loop pairs by descriptor similarity: ``(pairs (K, 2) int32,
    yaw (K,))`` with ``dist < max_distance`` and ``j - i >= min_separation``,
    by ascending distance.  ``yaw`` is scan j's rotation relative to scan i
    (feed it to :func:`yaw_seeds`)."""
    t = descs.shape[0]
    dist, shift = descriptor_distances(descs)
    idx = torch.arange(t, device=descs.device)
    ok = (dist < max_distance) & ((idx[None, :] - idx[:, None]) >= min_separation)
    masked = torch.where(ok, dist, torch.full_like(dist, math.inf))
    k = min(max_candidates if max_candidates is not None else t * t, t * t)
    i, j, yaw = _ranked(masked, shift, k, descs.shape[-1], descs.dtype)
    return torch.stack([i, j], dim=-1).to(torch.int32), yaw


def find_loop_candidates_descriptor_incremental(
    descs: torch.Tensor,
    new_start: int,
    max_distance: float,
    min_separation: int = 10,
    max_candidates: int | None = None,
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`find_loop_candidates_descriptor` restricted to pairs whose newer
    member is a keyframe ``>= new_start``: only the new block is scored
    against the whole database (descriptors are immutable, so older pairs
    were scored before).  The same ``(pairs, yaw)`` contract and order as
    filtering the all-pairs result.

    ``exclude`` (bool ``(T', T'')``, indexed from 0): pairs dropped before
    the ``max_candidates`` truncation, so the budget goes to fresh pairs.
    """
    t = descs.shape[0]
    if not 0 <= new_start <= t:
        raise ValueError(f"new_start must be in [0, {t}], got {new_start}")
    device = descs.device
    if new_start == t:
        return (torch.zeros((0, 2), dtype=torch.int32, device=device),
                torch.zeros((0,), dtype=descs.dtype, device=device))
    # Query axis = the database (i), so the shift convention matches the
    # all-pairs search.
    dist, shift = descriptor_query(descs, descs[new_start:])  # (t, n_new)
    gi = torch.arange(t, device=device)[:, None]
    gj = new_start + torch.arange(t - new_start, device=device)[None, :]
    ok = (dist < max_distance) & ((gj - gi) >= min_separation)
    if exclude is not None:
        ex = torch.zeros((t, t), dtype=torch.bool, device=device)
        a, b = min(exclude.shape[0], t), min(exclude.shape[1], t)
        ex[:a, :b] = exclude[:a, :b].to(device)
        ok = ok & ~ex[:, new_start:]
    masked = torch.where(ok, dist, torch.full_like(dist, math.inf))
    k = min(max_candidates if max_candidates is not None else masked.numel(), masked.numel())
    i, j, yaw = _ranked(masked, shift, k, descs.shape[-1], descs.dtype)
    return torch.stack([i, new_start + j], dim=-1).to(torch.int32), yaw


def yaw_seeds(clouds, pairs: torch.Tensor, yaw: torch.Tensor) -> RigidTransform:
    """Registration seeds from descriptor yaw estimates: for each pair ``(i,
    j)``, ``T = (R(-yaw), c_i - R(-yaw) c_j)`` about the (2D plane / 3D z)
    axis around the scan centroids ``c``, taking frame-j points into frame
    i.  A ``(K,)``-batched transform for ``register_loop_closures(guesses=)``."""
    pts, msk = clouds.points, clouds.mask
    dim = pts.shape[-1]
    total = msk.sum(-1, keepdim=True).clamp(min=1)
    centers = torch.where(msk[..., None], pts, torch.zeros((), dtype=pts.dtype,
                                                           device=pts.device)).sum(-2) / total
    pairs = pairs.to(pts.device).long()
    i, j = pairs[:, 0], pairs[:, 1]
    # ``yaw`` is scan j's rotation relative to scan i; the seed applies its
    # inverse to bring j back.
    yaw = -yaw.to(pts.device)
    c, s = torch.cos(yaw), torch.sin(yaw)
    if dim == 2:
        rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    else:
        z, o = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                           torch.stack([z, z, o], -1)], -2)  # yaw about z
    ci, cj = centers[i], centers[j]
    trans = ci - torch.matmul(rot, cj[..., None])[..., 0]
    return RigidTransform(rot.to(pts.dtype), trans.to(pts.dtype))

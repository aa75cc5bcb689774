"""2D ``feature_aware`` ICP.

Port of :mod:`icp_tpu.methods.feature_aware`, after
``lib/icp/impl/feature_aware.cpp``.  Trimmed ICP whose correspondences
minimize a blend of the max-normalized point distance and the
max-normalized **feature** distance (``feature_aware.cpp:128-148``), then the
same trim and rigid fit.

Features (``feature_aware.cpp:151-177``): scans are ordered by bearing; for
point ``i`` with centroid range ``r_i``, the vector stacks ``r_j - r_i`` over
``symmetric_neighbors`` points on each side.  Left entries are
front-compacted (for ``i < sn`` the ``i`` available differences fill slots
``0..i-1``), right entries fill slots ``sn..`` and are zero past the scan
end.  They are computed once, in ``init``, from the source at its guess pose
and from the target, as is the normalized ``(N, M)`` feature-distance matrix,
which every iterate reuses (the state carries it unchanged, so the driver's
per-lane freeze never copies it).

Both normalizations divide by the matrix maximum only when it exceeds 1e-6
(``feature_aware.cpp:24,54-57,130-133``).  The point distances are
Euclidean (``feature_aware.h:40-46``).

The blended argmin is dense ``(N, M)`` plain torch, as in the JAX package,
which computes it outside any kernel: at B = 256 and N = M = 1024 in
float32, each ``(B, N, M)`` tensor is 1 GiB.  Under a points group's row
split (:func:`icp_tpu_torch.ops.nn.row_split`) each rank blends its block of
rows, the point-distance maximum is reduced over the group before the
normalization, and the matches are gathered back.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import geometry
from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform, masked_centroid
from ..ops.nn import pairwise_sq_dists, row_split
from ..ops.rigid_fit import fit_rigid_indexed
from .base import Method
from .trimmed import trim_weights

DEFAULT_OVERLAP_RATE = 0.9  # ``feature_aware.cpp:21``
DEFAULT_FEATURE_WEIGHT = 0.7  # ``feature_aware.cpp:22``
DEFAULT_SYMMETRIC_NEIGHBORS = 10  # ``feature_aware.cpp:23``
MIN_NORM_THRESHOLD = 1e-6  # ``feature_aware.cpp:24``


@dataclasses.dataclass(frozen=True)
class FeatureAwareState:
    transform: RigidTransform
    source: PointCloud
    target: PointCloud
    feature_dists: torch.Tensor  # (..., N, M) normalized feature distances, fixed
    match_idx: torch.Tensor  # (..., N) int32
    match_cost: torch.Tensor  # (..., N) blended cost (+inf on padding)


def compute_features(
    points: torch.Tensor, mask: torch.Tensor, count: torch.Tensor, sn: int
) -> torch.Tensor:
    """Per-point feature vectors ``(..., N, 2*sn)`` of a front-packed cloud.

    Slot ``s < sn`` holds ``r_j - r_i`` for ``j = max(0, i - sn) + s`` when
    ``j < i``; slot ``s >= sn`` holds it for ``j = i + 1 + (s - sn)`` when
    ``j < n``; zeros elsewhere.
    """
    n_pad = points.shape[-2]
    dev = points.device
    centroid = masked_centroid(points, mask)
    r = torch.linalg.vector_norm(points - centroid[..., None, :], dim=-1)
    r = r.masked_fill(~mask, 0.0)

    i_idx = torch.arange(n_pad, device=dev)[:, None]  # (N, 1)
    s_idx = torch.arange(2 * sn, device=dev)[None, :]  # (1, 2sn)
    left_j = torch.clamp(i_idx - sn, min=0) + s_idx
    right_j = i_idx + 1 + (s_idx - sn)
    is_left = s_idx < sn
    j_idx = torch.where(is_left, left_j, right_j)  # (N, 2sn)
    n_valid = count[..., None, None]
    valid = torch.where(is_left, left_j < i_idx, right_j < n_valid)
    valid = valid & (i_idx < n_valid) & (j_idx >= 0) & (j_idx < n_pad)
    r_j = r[..., torch.clamp(j_idx, 0, n_pad - 1)]  # (..., N, 2sn)
    return (r_j - r[..., :, None]) * valid.to(points.dtype)


def pairwise_euclid(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(..., N, K) x (..., M, K) -> (..., N, M)`` Euclidean distances by the
    ``|a|^2 - 2ab + |b|^2`` matmul, clamped at 0 before the sqrt.  TF32 is
    off (the package turns it off on import), so the matmul is full float32."""
    aa = (a * a).sum(-1)
    bb = (b * b).sum(-1)
    ab = torch.matmul(a, b.transpose(-1, -2))
    sq = aa[..., :, None] + bb[..., None, :] - 2.0 * ab
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _normalize_by_max(dists: torch.Tensor, valid: torch.Tensor, reduce_max=None) -> torch.Tensor:
    """Divide by the maximum over valid entries when it exceeds 1e-6
    (``feature_aware.cpp:53-57,130-133``).  ``reduce_max`` takes the
    maximum of a row block over the other blocks' ranks (a row split)."""
    mx = dists.masked_fill(~valid, -float("inf")).amax(dim=(-2, -1), keepdim=True)
    if reduce_max is not None:
        mx = reduce_max(mx)
    one = torch.ones((), dtype=dists.dtype, device=dists.device)
    scale = torch.where(mx > MIN_NORM_THRESHOLD, 1.0 / torch.where(mx > 0, mx, one), one)
    return dists * scale


def _valid_matrix(src: PointCloud, tgt: PointCloud) -> torch.Tensor:
    return src.mask[..., :, None] & tgt.mask[..., None, :]


def create(config: Config) -> Method:
    overlap_rate = config.get("overlap_rate", DEFAULT_OVERLAP_RATE)
    feature_weight = config.get("feature_weight", DEFAULT_FEATURE_WEIGHT)
    symmetric_neighbors = config.get("symmetric_neighbors", DEFAULT_SYMMETRIC_NEIGHBORS)
    neighbor_weight = 1.0 - feature_weight  # ``feature_aware.cpp:29``

    def _match_rows(a_rows, fd_rows, smask_rows, tgt: PointCloud, reduce_max=None):
        valid = smask_rows[..., :, None] & tgt.mask[..., None, :]
        dists = _normalize_by_max(torch.sqrt(pairwise_sq_dists(a_rows, tgt.points)), valid,
                                  reduce_max)
        blended = neighbor_weight * dists + feature_weight * fd_rows
        blended = blended.masked_fill(~valid, float("inf"))
        # torch.min, like jnp.argmin, takes the first of equal minima.
        cost, idx = torch.min(blended, dim=-1)
        return idx.to(torch.int32), cost.masked_fill(~smask_rows, float("inf"))

    def _compute_matches(a_current, feature_dists, src: PointCloud, tgt: PointCloud):
        split = row_split()
        if split is None:
            return _match_rows(a_current, feature_dists, src.mask, tgt)
        # A points group's row split: this rank's rows, the global maximum
        # over every rank's rows, then the rows gathered back.
        row = a_current.dim() - 2
        n = a_current.shape[row]
        idx, cost = _match_rows(split.take(a_current, row), split.take(feature_dists, row),
                                split.take(src.mask, row), tgt, split.max)
        return split.join(idx, row, n), split.join(cost, row, n)

    def init(
        source: PointCloud, target: PointCloud, guess: RigidTransform
    ) -> FeatureAwareState:
        a_current = geometry.apply(guess, source.points)
        a_feats = compute_features(a_current, source.mask, source.count, symmetric_neighbors)
        b_feats = compute_features(target.points, target.mask, target.count, symmetric_neighbors)
        fdists = _normalize_by_max(pairwise_euclid(a_feats, b_feats), _valid_matrix(source, target))
        idx, cost = _compute_matches(a_current, fdists, source, target)
        return FeatureAwareState(guess, source, target, fdists, idx, cost)

    def iterate(state: FeatureAwareState) -> FeatureAwareState:
        src, tgt = state.source, state.target
        a_current = geometry.apply(state.transform, src.points)
        idx, cost = _compute_matches(a_current, state.feature_dists, src, tgt)
        weights = trim_weights(cost, src.count, overlap_rate, src.dtype)
        step = fit_rigid_indexed(a_current, tgt.points, idx, weights)
        return dataclasses.replace(
            state,
            transform=geometry.compose(step, state.transform),
            match_idx=idx,
            match_cost=cost,
        )

    def cost(state: FeatureAwareState) -> torch.Tensor:
        finite = state.match_cost.masked_fill(~state.source.mask, 0.0)
        n = torch.clamp(state.source.count.to(finite.dtype), min=1.0)
        return torch.sqrt(finite.sum(-1) / n)

    return Method(name="feature_aware", dim=2, init=init, iterate=iterate, cost=cost)

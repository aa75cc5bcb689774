"""Coarse global alignment: an initial guess from far outside ICP's basin.

Port of :mod:`icp_tpu.ops.coarse`.  ICP is a local optimizer: from the
identity it recovers rotations up to ~15-20 degrees.  These ops supply a
global initial guess that seeds ``converge``:

* 2D: the rotation from the circular cross-correlation of the two clouds'
  centroid-bearing histograms (soft-binned, L1-normalized), refined to a
  sub-bin angle by a parabola, plus the centroid shift;
* 3D: the principal axes of the two clouds' covariances give 4 proper
  candidate rotations; each is scored by its mean squared NN distance in one
  batched 1-NN pass, and the best one wins.

The histograms are two ``scatter_add_`` calls (the JAX package's one-hot
einsum, without the one-hot in memory); the correlation is an rFFT.  In
float32 on the card, cuFFT's rounding can move the ``argmax`` to a
neighbouring bin where two shifts score alike; the parabola keeps the angle
close, and the ICP that follows refines it.  The 3D scoring pass is the
1-NN kernel's K2 wrapper (its plain version on the CPU).
"""

from __future__ import annotations

import math

import torch

from .. import geometry
from ..cloud import PointCloud
from ..geometry import RigidTransform
from .pallas_nn import nearest_neighbors_pallas
from .rigid_fit import _jacobi_eigh_sym


def bearing_histogram(points: torch.Tensor, mask: torch.Tensor, bins: int) -> torch.Tensor:
    """Histogram ``(..., bins)`` of point bearings about the masked centroid.

    Each point's weight is split linearly between its two neighbouring bins,
    so the correlation objective is smooth; rows are L1-normalized.
    """
    centroid = geometry.masked_centroid(points, mask)
    rel = points - centroid[..., None, :]
    theta = torch.atan2(rel[..., 1], rel[..., 0])  # (-pi, pi]
    pos = (theta + math.pi) / (2 * math.pi) * bins  # [0, bins]
    lo = torch.floor(pos)
    frac = pos - lo
    lo_idx = torch.remainder(lo.to(torch.int64), bins)
    hi_idx = torch.remainder(lo_idx + 1, bins)
    w = mask.to(points.dtype)
    zeros = torch.zeros((*points.shape[:-2], bins), dtype=points.dtype, device=points.device)
    hist = (zeros.scatter_add(-1, lo_idx, w * (1.0 - frac))
            + zeros.scatter_add(-1, hi_idx, w * frac))
    total = hist.sum(-1, keepdim=True)
    return hist / torch.clamp(total, min=torch.finfo(points.dtype).tiny)


def rotation_from_histograms(h_a: torch.Tensor, h_b: torch.Tensor) -> torch.Tensor:
    """Angle (radians) of the rotation that best aligns histogram ``h_a`` to
    ``h_b``: the circular cross-correlation over all bin shifts by real FFT,
    its first maximum refined by a parabola through the neighbouring shifts."""
    bins = h_a.shape[-1]
    corr = torch.fft.irfft(
        torch.conj(torch.fft.rfft(h_a, dim=-1)) * torch.fft.rfft(h_b, dim=-1), n=bins, dim=-1)
    # torch.argmax, like jnp.argmax, takes the first of equal maxima.
    best = torch.argmax(corr, dim=-1, keepdim=True)
    c0 = torch.take_along_dim(corr, torch.remainder(best - 1, bins), -1)[..., 0]
    c1 = torch.take_along_dim(corr, best, -1)[..., 0]
    c2 = torch.take_along_dim(corr, torch.remainder(best + 1, bins), -1)[..., 0]
    denom = c0 - 2 * c1 + c2
    curved = torch.abs(denom) > 1e-12
    offset = torch.where(curved, 0.5 * (c0 - c2) / torch.where(curved, denom, 1.0), 0.0)
    shift = best[..., 0].to(h_a.dtype) + offset
    return shift * (2 * math.pi / bins)


def _rotate(rotation: torch.Tensor, vector: torch.Tensor) -> torch.Tensor:
    return torch.matmul(rotation, vector[..., None])[..., 0]


def coarse_align_2d(source: PointCloud, target: PointCloud, bins: int = 180) -> RigidTransform:
    """Global SE(2) guess ``T`` with ``T(source) ~ target``: the histogram
    rotation and the centroid shift.  Batched over leading dims."""
    h_a = bearing_histogram(source.points, source.mask, bins)
    h_b = bearing_histogram(target.points, target.mask, bins)
    rot = geometry.from_angle_2d(rotation_from_histograms(h_a, h_b)).rotation
    ca = geometry.masked_centroid(source.points, source.mask)
    cb = geometry.masked_centroid(target.points, target.mask)
    return RigidTransform(rot, cb - _rotate(rot, ca))


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of ``(..., 3, 3)`` matrices by cofactors."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _eigbasis(cloud: PointCloud) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked centroid and the right-handed eigenbasis (columns, ascending
    eigenvalues) of the cloud's scatter matrix."""
    points, mask = cloud.points, cloud.mask
    c = geometry.masked_centroid(points, mask)
    centered = (points - c[..., None, :]) * mask.to(points.dtype)[..., None]
    cov = torch.matmul(centered.transpose(-1, -2), centered)
    vals, vecs = _jacobi_eigh_sym(cov)
    order = torch.argsort(vals, dim=-1, stable=True)
    vecs = torch.take_along_dim(vecs, order[..., None, :].expand(vecs.shape), -1)
    flip = torch.where(_det3(vecs) < 0, -1.0, 1.0).to(points.dtype)
    vecs = torch.cat([vecs[..., :, :1] * flip[..., None, None], vecs[..., :, 1:]], dim=-1)
    return c, vecs


# Sign patterns with product +1: the 4 axis-consistent proper rotations.
_SIGNS = ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1))


def coarse_align_3d(source: PointCloud, target: PointCloud) -> RigidTransform:
    """Global SE(3) guess by principal-axes alignment.

    With the eigenbases ``V_a``, ``V_b`` of the two clouds' covariances, the
    candidates are ``R = V_b S V_a^T`` for the 4 sign matrices ``S`` of
    determinant +1, each with ``t = c_b - R c_a``; the one with the least
    mean squared NN distance of the moved source wins (the first on ties).
    Needs anisotropic structure: a sphere scores every candidate alike.
    Batched over leading dims.
    """
    ca, va = _eigbasis(source)
    cb, vb = _eigbasis(target)
    signs = torch.tensor(_SIGNS, dtype=source.dtype, device=source.points.device)
    lead = source.batch_shape
    # (4, ..., 3, 3): V_b diag(s) V_a^T for each sign pattern s.
    sv = vb[None] * signs.reshape(4, *(1,) * len(lead), 1, 3)
    rot = torch.matmul(sv, va.transpose(-1, -2)[None])
    trans = cb[None] - _rotate(rot, ca[None])
    n, m = source.capacity, target.capacity
    moved = geometry.apply(RigidTransform(rot, trans), source.points[None])
    sq, _ = nearest_neighbors_pallas(
        moved.reshape(-1, n, 3).contiguous(),
        target.points.expand(4, *lead, m, 3).reshape(-1, m, 3).contiguous(),
        target.mask.expand(4, *lead, m).reshape(-1, m).contiguous(),
    )
    sq = torch.where(source.mask[None], sq.reshape(4, *lead, n), 0.0)
    count = torch.clamp(source.mask.sum(-1).to(sq.dtype), min=1.0)
    scores = torch.movedim(sq.sum(-1) / count, 0, -1)  # (..., 4)
    best = torch.argmin(scores, dim=-1)  # the first of equal minima
    pick = best[None, ..., None]
    r = torch.take_along_dim(rot, pick[..., None].expand(1, *lead, 3, 3), 0)[0]
    t = torch.take_along_dim(trans, pick.expand(1, *lead, 3), 0)[0]
    return RigidTransform(r, t)

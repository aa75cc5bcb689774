"""Weighted rigid-transform estimation (Kabsch / Umeyama, point-to-point).

Port of :mod:`icp_tpu.ops.rigid_fit`: in 2D the closed form
``theta = atan2(H01 - H10, H00 + H11)`` (the det-fixed 2x2 SVD of the
reference, ``lib/icp/impl/trimmed.cpp:75-87``), in 3D ``R = V U^T`` from an
SVD with the reference's reflection fix.  Weights generalize the reference's
selections: full weights for vanilla, 0/1 trim weights for trimmed.

Not ported: the JAX package's one-hot matmul branch of
:func:`fit_rigid_indexed`, which existed to avoid the TPU's dynamic gather,
and the 3D quaternion (Jacobi) solver, which waits for the 3D methods.
"""

from __future__ import annotations

import torch

from ..geometry import RigidTransform, weighted_centroid


def cross_covariance(
    source: torch.Tensor, target: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted centred cross-covariance ``H = sum_i w_i (a_i - ā)(b_i - b̄)^T``.

    Returns ``(H, source_centroid, target_centroid)``.
    """
    ca = weighted_centroid(source, weights)
    cb = weighted_centroid(target, weights)
    a_c = source - ca[..., None, :]
    b_c = target - cb[..., None, :]
    h = torch.matmul((a_c * weights[..., None]).transpose(-1, -2), b_c)
    return h, ca, cb


def rotation_from_covariance_2d(h: torch.Tensor) -> torch.Tensor:
    """Optimal proper rotation for a 2x2 cross-covariance, closed form.

    ``argmax_R trace(R H)`` over SO(2) is at ``atan2(H01 - H10, H00 + H11)``;
    a zero matrix gives the identity.
    """
    sin_num = h[..., 0, 1] - h[..., 1, 0]
    cos_num = h[..., 0, 0] + h[..., 1, 1]
    norm = torch.sqrt(sin_num * sin_num + cos_num * cos_num)
    safe = norm > 0
    one = torch.ones((), dtype=h.dtype, device=h.device)
    inv = torch.where(safe, 1.0 / torch.where(safe, norm, one), one)
    c = torch.where(safe, cos_num * inv, one)
    s = torch.where(safe, sin_num * inv, torch.zeros_like(one))
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def rotation_from_covariance_3d_svd(h: torch.Tensor) -> torch.Tensor:
    """``R = V U^T`` with the reference's reflection fix (flip V's last column)."""
    u, _, vt = torch.linalg.svd(h, full_matrices=True)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(v, ut))
    flip = torch.where(det < 0, -1.0, 1.0).to(h.dtype)
    v_fixed = torch.cat([v[..., :, :-1], v[..., :, -1:] * flip[..., None, None]], dim=-1)
    return torch.matmul(v_fixed, ut)


def _rotation_from_h(h: torch.Tensor) -> torch.Tensor:
    """2D closed form, 3D SVD (the only 3D solver ported so far)."""
    dim = h.shape[-1]
    if dim == 2:
        return rotation_from_covariance_2d(h)
    if dim == 3:
        return rotation_from_covariance_3d_svd(h)
    raise ValueError(f"unsupported dimension {dim}")


def fit_rigid(
    source: torch.Tensor,
    target: torch.Tensor,
    weights: torch.Tensor,
) -> RigidTransform:
    """Weighted least-squares rigid transform taking ``source`` onto ``target``:
    ``min sum_i w_i |R a_i + t - b_i|^2`` over proper rotations, with
    ``t = b̄ - R ā``."""
    h, ca, cb = cross_covariance(source, target, weights)
    r = _rotation_from_h(h)
    t = cb - torch.matmul(r, ca[..., None])[..., 0]
    return RigidTransform(r, t)


def fit_rigid_indexed(
    source: torch.Tensor,
    target_points: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
) -> RigidTransform:
    """``fit_rigid(source, target_points[indices], weights)`` by an exact gather."""
    dim = target_points.shape[-1]
    gather = indices.long()[..., None].expand(*indices.shape, dim)
    matched = torch.take_along_dim(target_points, gather, dim=-2)
    return fit_rigid(source, matched, weights)

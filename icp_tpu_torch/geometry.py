"""Rigid-body transforms and point-cloud geometry on tensors.

Port of :mod:`icp_tpu.geometry`.  Points are rows ``(..., N, D)``; a
:class:`RigidTransform` holds a rotation ``(..., D, D)`` and a translation
``(..., D)`` with any leading batch dims.

Device policy: the entry points that make tensors (:func:`identity`,
:func:`from_angle_2d` from a number, and ``cloud.from_points`` and the
``convert`` constructors) put them on the card unless the caller passes
``device="cpu"``; without a card they raise.

Dtype policy: float64 on the CPU (parity with the JAX package), float32 on
CUDA (the main path).  Pose contractions need full float32 precision: with
reduced precision, composed rotations drift off SO(D) and converged poses
move by centimetres.  The package therefore turns TF32 off when it is
imported (``icp_tpu_torch/__init__.py``).
"""

from __future__ import annotations

import dataclasses

import torch


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU, float32 on an accelerator."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


@dataclasses.dataclass(frozen=True)
class RigidTransform:
    """An SE(D) transform ``x -> R @ x + t``."""

    rotation: torch.Tensor  # (..., D, D)
    translation: torch.Tensor  # (..., D)

    @property
    def dim(self) -> int:
        return self.rotation.shape[-1]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.translation.shape[:-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.rotation.dtype

    def __matmul__(self, other: "RigidTransform") -> "RigidTransform":
        return compose(self, other)


def identity(
    dim: int, batch_shape: tuple[int, ...] = (), dtype=None, device="cuda"
) -> RigidTransform:
    """The identity transform with the given batch shape."""
    dtype = default_dtype(device) if dtype is None else dtype
    rot = torch.eye(dim, dtype=dtype, device=device).expand(*batch_shape, dim, dim).contiguous()
    trans = torch.zeros((*batch_shape, dim), dtype=dtype, device=device)
    return RigidTransform(rot, trans)


def compose(outer: RigidTransform, inner: RigidTransform) -> RigidTransform:
    """``outer ∘ inner``, apply ``inner`` first: ``R = Ro Ri``, ``t = Ro ti + to``."""
    rot = torch.matmul(outer.rotation, inner.rotation)
    trans = torch.matmul(outer.rotation, inner.translation[..., None])[..., 0] + outer.translation
    return RigidTransform(rot, trans)


def apply(transform: RigidTransform, points: torch.Tensor) -> torch.Tensor:
    """Apply a transform to points ``(..., N, D) -> (..., N, D)``: ``p R^T + t``."""
    return (
        torch.matmul(points, transform.rotation.transpose(-1, -2))
        + transform.translation[..., None, :]
    )


def inverse(transform: RigidTransform) -> RigidTransform:
    """Inverse transform: ``R^T, -R^T t``."""
    rot_t = transform.rotation.transpose(-1, -2)
    trans = -torch.matmul(rot_t, transform.translation[..., None])[..., 0]
    return RigidTransform(rot_t.contiguous(), trans)


def project_rotation(rotation: torch.Tensor) -> torch.Tensor:
    """Nearest SO(D) matrix in Frobenius norm (batched SVD polar factor).

    Long compose chains drift off the rotation manifold, in float32 as a
    multiplicative scale loss that :func:`inverse` (a transpose) never
    cancels.  The det-sign convention of the rigid fit keeps the result a
    proper rotation: when ``det(U Vᵀ) < 0`` the last column of ``U`` flips.
    """
    u, _, vt = torch.linalg.svd(rotation)
    det = torch.linalg.det(torch.matmul(u, vt))
    sign = torch.where(det < 0, -1.0, 1.0).to(u.dtype)
    u = torch.cat([u[..., :, :-1], u[..., :, -1:] * sign[..., None, None]], dim=-1)
    return torch.matmul(u, vt)


def renormalize(transform: RigidTransform) -> RigidTransform:
    """Re-project a transform's rotation onto SO(D) (:func:`project_rotation`);
    the translation passes through."""
    return RigidTransform(project_rotation(transform.rotation), transform.translation)


def from_angle_2d(angle, translation=None, *, device="cuda") -> RigidTransform:
    """SE(2) transform from an angle (radians) and an optional translation.

    ``angle`` is a tensor (its dtype and device are kept, ``device`` is not
    read) or a number (then a tensor on ``device`` in its default dtype).
    """
    if not isinstance(angle, torch.Tensor):
        angle = torch.tensor(angle, dtype=default_dtype(device), device=device)
    c, s = torch.cos(angle), torch.sin(angle)
    rot = torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)
    if translation is None:
        trans = torch.zeros((*angle.shape, 2), dtype=rot.dtype, device=rot.device)
    else:
        trans = torch.as_tensor(translation, dtype=rot.dtype, device=rot.device)
    return RigidTransform(rot, trans)


def rotation_angle_2d(rotation: torch.Tensor) -> torch.Tensor:
    """Smallest signed angle of a 2D rotation, ``atan2(R10, R00)``."""
    return torch.atan2(rotation[..., 1, 0], rotation[..., 0, 0])


def rotation_angle_3d(rotation: torch.Tensor) -> torch.Tensor:
    """Axis-angle magnitude of a 3D rotation in ``[0, pi]``, as
    ``atan2(|skew(R)|, (trace - 1) / 2)`` (full precision at tiny angles)."""
    trace = rotation.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_angle = (trace - 1.0) / 2.0
    skew = 0.5 * torch.stack(
        [
            rotation[..., 2, 1] - rotation[..., 1, 2],
            rotation[..., 0, 2] - rotation[..., 2, 0],
            rotation[..., 1, 0] - rotation[..., 0, 1],
        ],
        dim=-1,
    )
    sin_angle = torch.linalg.vector_norm(skew, dim=-1)
    return torch.atan2(sin_angle, cos_angle)


def rotation_angle(rotation: torch.Tensor) -> torch.Tensor:
    """Dispatch to the 2D or 3D rotation angle by trailing shape."""
    dim = rotation.shape[-1]
    if dim == 2:
        return rotation_angle_2d(rotation)
    if dim == 3:
        return rotation_angle_3d(rotation)
    raise ValueError(f"unsupported dimension {dim}")


def masked_centroid(points: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mask-weighted centroid ``(..., N, D) -> (..., D)``; an empty mask gives 0."""
    if mask is None:
        return points.mean(dim=-2)
    w = mask.to(points.dtype)
    total = w.sum(-1)
    sums = torch.matmul(w[..., None, :], points)[..., 0, :]
    return sums / torch.clamp(total, min=1.0)[..., None]


def weighted_centroid(points: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Centroid under real weights ``(..., N)``; all-zero weights give the origin."""
    total = weights.sum(-1)
    sums = torch.matmul(weights[..., None, :], points)[..., 0, :]
    tiny = torch.finfo(points.dtype).tiny
    return sums / torch.clamp(total, min=tiny)[..., None]

"""SE(2)/SE(3) tangent-space maps (exp/log).

Port of :mod:`icp_tpu.lie`.  Everything is batched and branch-free: the
small-angle Taylor branches are selected with ``torch.where``, and every
branch is finite for every input, so nothing NaNs under autograd either.

Conventions: tangent vectors are ``(..., 3)`` for SE(2) as ``(rho_x, rho_y,
theta)`` and ``(..., 6)`` for SE(3) as ``(rho, omega)``; ``exp``
right-composes into group elements ``x -> R x + t``.
"""

from __future__ import annotations

import torch

from .geometry import RigidTransform


def _small_cut(dtype) -> float:
    """Small-angle cut-off of the Taylor branches: ``eps ** 0.25`` (the
    Sophus rule), ~1.9e-2 in float32 and ~1.2e-4 in float64.  Below it,
    ``(1 - cos t) / t**2``-style expressions lose more than half their bits
    to cancellation."""
    return float(torch.finfo(dtype).eps) ** 0.25


def _general_cut(dtype) -> float:
    """Threshold on ``|sin(theta)|`` below which :func:`so3_log` leaves the
    general branch for the Taylor / near-pi ones."""
    return max(1e-6, float(torch.finfo(dtype).eps) ** 0.5)


def _safe_norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm plus ``tiny`` under the root: finite gradient at 0."""
    return torch.sqrt((v * v).sum(-1) + torch.finfo(v.dtype).tiny)


def _sinc(theta: torch.Tensor) -> torch.Tensor:
    """``sin(theta) / theta`` with its limit at 0."""
    small = torch.abs(theta) < _small_cut(theta.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def _cosc(theta: torch.Tensor) -> torch.Tensor:
    """``(1 - cos(theta)) / theta`` with its limit at 0."""
    small = torch.abs(theta) < _small_cut(theta.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, theta / 2.0, (1.0 - torch.cos(safe)) / safe)


def _half_cosc2(theta: torch.Tensor, small: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """``(1 - cos(theta)) / theta**2`` with its limit 1/2 at 0."""
    return torch.where(small, 0.5 - theta * theta / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))


def _mat2(a, b, c, d) -> torch.Tensor:
    """``[[a, b], [c, d]]`` of equally shaped tensors."""
    return torch.stack([torch.stack([a, b], dim=-1), torch.stack([c, d], dim=-1)], dim=-2)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(m, v[..., None])[..., 0]


def se2_exp(xi: torch.Tensor) -> RigidTransform:
    """Exponential map R^3 -> SE(2)."""
    rho, theta = xi[..., :2], xi[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    a, b = _sinc(theta), _cosc(theta)
    return RigidTransform(_mat2(c, -s, s, c), _matvec(_mat2(a, -b, b, a), rho))


def se2_log(transform: RigidTransform) -> torch.Tensor:
    """Log map SE(2) -> R^3 (theta in (-pi, pi])."""
    rot = transform.rotation
    theta = torch.atan2(rot[..., 1, 0], rot[..., 0, 0])
    a, b = _sinc(theta), _cosc(theta)
    # V^{-1} = 1/(a^2+b^2) * [[a, b], [-b, a]]
    vinv = _mat2(a, b, -b, a) / (a * a + b * b)[..., None, None]
    rho = _matvec(vinv, transform.translation)
    return torch.cat([rho, theta[..., None]], dim=-1)


def _hat3(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator ``(..., 3) -> (..., 3, 3)``."""
    o0, o1, o2 = omega[..., 0], omega[..., 1], omega[..., 2]
    z = torch.zeros_like(o0)
    return torch.stack(
        [
            torch.stack([z, -o2, o1], dim=-1),
            torch.stack([o2, z, -o0], dim=-1),
            torch.stack([-o1, o0, z], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: ``(..., 3) -> (..., 3, 3)``."""
    theta = _safe_norm(omega)
    k = _hat3(omega)
    k2 = torch.matmul(k, k)
    a = _sinc(theta)
    small = torch.abs(theta) < _small_cut(omega.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    b = _half_cosc2(theta, small, safe)
    return _eye3(k) + a[..., None, None] * k + b[..., None, None] * k2


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues ``(..., 3, 3) -> (..., 3)``, robust at theta -> 0.

    theta is ``atan2(|skew|, (trace - 1) / 2)``; near theta = pi the axis
    comes from the diagonal (accuracy ~sqrt(eps) there).
    """
    dtype = rot.dtype
    tiny = torch.finfo(dtype).tiny
    trace = rot.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    skew = 0.5 * torch.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sqrt((skew * skew).sum(-1) + tiny)  # == |sin(theta)|
    theta = torch.atan2(sin_theta, cos_theta)

    general = sin_theta > _general_cut(dtype)
    one = torch.ones_like(sin_theta)
    safe_sin = torch.where(general, sin_theta, one)
    factor = torch.where(general, theta / safe_sin, one)
    omega_general = skew * factor[..., None]

    diag = rot.diagonal(dim1=-2, dim2=-1)
    denom = torch.clamp(1.0 - cos_theta[..., None], min=_general_cut(dtype))
    axis_abs = torch.sqrt(torch.clamp((diag - cos_theta[..., None]) / denom, min=0.0) + tiny)
    sign = torch.where(skew >= 0, 1.0, -1.0).to(dtype)
    omega_pi = theta[..., None] * axis_abs * sign

    near_pi = (~general) & (cos_theta < 0.0)
    return torch.where(near_pi[..., None], omega_pi, omega_general)


def se3_exp(xi: torch.Tensor) -> RigidTransform:
    """Exponential map R^6 -> SE(3) with ``xi = (rho, omega)``."""
    rho, omega = xi[..., :3], xi[..., 3:]
    theta = _safe_norm(omega)
    k = _hat3(omega)
    k2 = torch.matmul(k, k)
    rot = so3_exp(omega)
    small = torch.abs(theta) < _small_cut(xi.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    b = _half_cosc2(theta, small, safe)
    c = torch.where(
        small, 1.0 / 6.0 - theta * theta / 120.0, (safe - torch.sin(safe)) / (safe**3)
    )
    v = _eye3(k) + b[..., None, None] * k + c[..., None, None] * k2
    return RigidTransform(rot, _matvec(v, rho))


def se3_log(transform: RigidTransform) -> torch.Tensor:
    """Log map SE(3) -> R^6."""
    omega = so3_log(transform.rotation)
    theta = _safe_norm(omega)
    k = _hat3(omega)
    k2 = torch.matmul(k, k)
    small = torch.abs(theta) < _small_cut(omega.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    # V^{-1} = I - K/2 + (1/theta^2)(1 - A/(2B)) K^2
    a = _sinc(theta)
    b = _half_cosc2(theta, small, safe)
    coef = torch.where(
        small, 1.0 / 12.0 + theta * theta / 720.0, (1.0 - a / (2.0 * b)) / (safe * safe)
    )
    vinv = _eye3(k) - 0.5 * k + coef[..., None, None] * k2
    rho = _matvec(vinv, transform.translation)
    return torch.cat([rho, omega], dim=-1)


def exp(xi: torch.Tensor, dim: int) -> RigidTransform:
    return se2_exp(xi) if dim == 2 else se3_exp(xi)


def log(transform: RigidTransform) -> torch.Tensor:
    return se2_log(transform) if transform.dim == 2 else se3_log(transform)


def dof(dim: int) -> int:
    return 3 if dim == 2 else 6

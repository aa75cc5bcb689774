"""Registration certainty: scan-matching information matrices.

Port of :mod:`icp_tpu.ops.covariance` (the point-to-line/plane form of
Censi, ICRA 2007).  A surface point constrains the pose along its normal
only, so the information is

    H = (1/sigma^2) * sum_i w_i * u_i u_i^T,   u_i = [ n_i , p_i x n_i ]

in the local frame of the :mod:`icp_tpu_torch.lie` right-perturbation (in
2D the scalar cross product).  ``sigma`` is the per-point range noise.
"""

from __future__ import annotations

import torch


def scan_matching_information(
    points: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor | None = None,
    sigma: float = 1.0,
) -> torch.Tensor:
    """Normal-projected Gauss-Newton information ``(..., dof, dof)`` of
    ``points (..., N, D)`` with unit ``normals`` and validity ``mask``."""
    from ..methods.point_to_plane import twist_rows

    w = (torch.ones(points.shape[:-1], dtype=points.dtype, device=points.device)
         if mask is None else mask.to(points.dtype))
    u = twist_rows(points, normals)  # (..., N, dof)
    h = torch.matmul((u * w[..., None]).transpose(-1, -2), u)
    return h / (sigma * sigma)


def cloud_information(cloud, k: int = 10, sigma: float = 1.0) -> torch.Tensor:
    """:func:`scan_matching_information` of a cloud, normals from the
    point-to-plane method's masked k-NN PCA, divided by the valid point
    count (a per-point trust shape)."""
    from ..methods.point_to_plane import estimate_normals

    normals = estimate_normals(cloud.points, cloud.mask, k)
    h = scan_matching_information(cloud.points, normals, cloud.mask, sigma)
    n = torch.clamp(cloud.count.to(h.dtype), min=1.0)
    return h / n[..., None, None]


def sqrt_information(information: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Whitener ``L^T`` with ``info + eps * mean(diag) * I = L L^T``.

    ``eps`` (relative to the mean diagonal) regularizes rank-deficient
    information.  ``cholesky_ex`` does not raise or sync; a matrix that is
    still not positive definite gives NaN in the factor's lower triangle
    (zeros above it), as JAX's Cholesky does.
    """
    dof = information.shape[-1]
    scale = information.diagonal(dim1=-2, dim2=-1).mean(-1, keepdim=True)
    reg = information + (eps * scale[..., None]) * torch.eye(
        dof, dtype=information.dtype, device=information.device)
    chol, info = torch.linalg.cholesky_ex(reg)
    chol = torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float("nan")).tril())
    return chol.transpose(-1, -2)

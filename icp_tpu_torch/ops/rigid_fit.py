"""Weighted rigid-transform estimation (Kabsch / Umeyama, point-to-point).

Port of :mod:`icp_tpu.ops.rigid_fit`: in 2D the closed form
``theta = atan2(H01 - H10, H00 + H11)`` (the det-fixed 2x2 SVD of the
reference, ``lib/icp/impl/trimmed.cpp:75-87``).  In 3D two solvers:
``"svd"``, ``R = V U^T`` from an SVD with the reference's reflection fix, and
``"quat"``, Horn's quaternion method, whose dominant eigenvector of a
symmetric 4x4 comes from a fixed-sweep cyclic Jacobi in plain elementwise
torch (no LAPACK).  ``"auto"`` picks ``svd`` in float64 and ``quat``
otherwise, as the JAX package does.  Weights generalize the reference's
selections: full weights for vanilla, 0/1 trim weights for trimmed, a
distance gate for 3D trimmed.

Not ported: the JAX package's one-hot matmul branch of
:func:`fit_rigid_indexed` (``gather="onehot"``), which existed to avoid the
TPU's dynamic gather; the port always gathers exactly.
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


def _jacobi_eigh_sym(a: torch.Tensor, sweeps: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of small symmetric matrices ``(..., n, n)`` by
    cyclic Jacobi: ``sweeps`` sweeps over the (p, q) pairs, each a Givens
    rotation by ``0.5 * atan2(2 a_pq, a_pp - a_qq)`` applied to the rows and
    columns of ``a`` and the columns of ``v``.

    Returns ``(eigenvalues (..., n), eigenvectors (..., n, n))``, the vectors
    in columns, unsorted.  Branch-free and fixed-length; every step is a
    separate small op, so one call launches about a thousand kernels on the
    card.
    """
    n = a.shape[-1]
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]
    for _ in range(sweeps):
        for p, q in pairs:
            theta = 0.5 * torch.atan2(2.0 * a[..., p, q], a[..., p, p] - a[..., q, q])
            c = torch.cos(theta)[..., None]
            s = torch.sin(theta)[..., None]
            ap, aq = a[..., p, :], a[..., q, :]
            a[..., p, :], a[..., q, :] = c * ap + s * aq, -s * ap + c * aq
            ap, aq = a[..., :, p], a[..., :, q]
            a[..., :, p], a[..., :, q] = c * ap + s * aq, -s * ap + c * aq
            vp, vq = v[..., :, p], v[..., :, q]
            v[..., :, p], v[..., :, q] = c * vp + s * vq, -s * vp + c * vq
    return a.diagonal(dim1=-2, dim2=-1), v


def rotation_from_covariance_3d_quat(h: torch.Tensor) -> torch.Tensor:
    """Horn's absolute orientation: the rotation of the unit quaternion that
    maximizes ``q^T K q``, i.e. the eigenvector of the largest eigenvalue of
    the symmetric 4x4 ``K`` built from ``H``.  Maximizes ``trace(R H)`` over
    SO(3), as the SVD path does."""
    hxx, hxy, hxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    hyx, hyy, hyz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    hzx, hzy, hzz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    tr = hxx + hyy + hzz
    k = torch.stack(
        [
            torch.stack([tr, hyz - hzy, hzx - hxz, hxy - hyx], dim=-1),
            torch.stack([hyz - hzy, hxx - hyy - hzz, hxy + hyx, hzx + hxz], dim=-1),
            torch.stack([hzx - hxz, hxy + hyx, hyy - hxx - hzz, hyz + hzy], dim=-1),
            torch.stack([hxy - hyx, hzx + hxz, hyz + hzy, hzz - hxx - hyy], dim=-1),
        ],
        dim=-2,
    )
    eigvals, eigvecs = _jacobi_eigh_sym(k)
    # torch.argmax, like jnp.argmax, takes the first of equal maxima.
    best = torch.argmax(eigvals, dim=-1)
    q = torch.take_along_dim(eigvecs, best[..., None, None].expand(*best.shape, 4, 1), dim=-1)
    q = q[..., 0]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def _rotation_from_h(h: torch.Tensor, solver: str = "auto") -> torch.Tensor:
    """2D closed form; in 3D ``solver`` ``"svd"``, ``"quat"`` or ``"auto"``
    (``svd`` in float64, ``quat`` otherwise)."""
    dim = h.shape[-1]
    if dim == 2:
        return rotation_from_covariance_2d(h)
    if dim == 3:
        if solver == "auto":
            solver = "svd" if h.dtype == torch.float64 else "quat"
        if solver == "svd":
            return rotation_from_covariance_3d_svd(h)
        if solver == "quat":
            return rotation_from_covariance_3d_quat(h)
        raise ValueError(f"unknown solver {solver!r}")
    raise ValueError(f"unsupported dimension {dim}")


def fit_rigid(
    source: torch.Tensor,
    target: torch.Tensor,
    weights: torch.Tensor,
    solver: str = "auto",
) -> RigidTransform:
    """Weighted least-squares rigid transform taking ``source`` onto ``target``:
    ``min sum_i w_i |R a_i + t - b_i|^2`` over proper rotations, with
    ``t = b̄ - R ā``.  ``solver`` picks the 3D rotation solver (see
    :func:`_rotation_from_h`)."""
    h, ca, cb = cross_covariance(source, target, weights)
    r = _rotation_from_h(h, solver)
    t = cb - torch.matmul(r, ca[..., None])[..., 0]
    return RigidTransform(r, t)


def fit_rigid_indexed(
    source: torch.Tensor,
    target_points: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
    solver: str = "auto",
) -> RigidTransform:
    """``fit_rigid(source, target_points[indices], weights)`` by an exact gather."""
    dim = target_points.shape[-1]
    gather = indices.long()[..., None].expand(*indices.shape, dim)
    matched = torch.take_along_dim(target_points, gather, dim=-2)
    return fit_rigid(source, matched, weights, solver)

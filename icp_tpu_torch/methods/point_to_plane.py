"""Point-to-plane ICP (Chen & Medioni 1992).

Port of :mod:`icp_tpu.methods.point_to_plane`.  Minimizes the distance of
the moved source points to the tangent plane of their nearest target point:

* Target normals are estimated once in ``init`` by masked k-NN PCA
  (:func:`neighborhood_moments`, then the smallest eigenvector from
  :func:`~icp_tpu_torch.ops.rigid_fit._jacobi_eigh_sym`).
* Each iteration matches with the 1-NN kernel (K2 on the card: indices
  only, the rows are gathered here), solves the linearized normal equations
  ``min_x sum_i w_i (J_i . x + r_i)^2`` with ``J_i = [n_i ; a_i x n_i]``
  (2D: ``[n_i ; cross2(a_i, n_i)]``), a ``(dof x dof)`` batched solve, and
  retracts with the exact SE(D) exponential (:mod:`icp_tpu_torch.lie`).

The solve is ``torch.linalg.solve_ex``: a singular system gives non-finite
values, as in JAX, with no host sync.

Config: ``normal_neighbors`` (int, default 10), ``max_distance`` (float,
optional gate), ``dim``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import geometry, lie
from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform
from ..ops.nn import pairwise_sq_dists
from ..ops.rigid_fit import _jacobi_eigh_sym
from ..ops.select import select_smallest_weights
from .base import Method, gather_rows, masked_rms, match

DEFAULT_NORMAL_NEIGHBORS = 10


def neighborhood_moments(points: torch.Tensor, mask: torch.Tensor, k: int,
                         selector: str = "auto"):
    """Masked k-NN neighbourhoods: ``(cov (..., M, D, D), count (..., M))``,
    ``cov`` the neighbourhood's weighted centred scatter (not divided).

    ``k`` is clamped to the capacity; masked slots carry weight 0.  Both
    selectors pick the same sets, ties toward the lower index:

    * ``"select"`` (the default): the 0/1 neighbourhood matrix from the
      radix k-smallest selection (:mod:`icp_tpu_torch.ops.select`), and the
      moments as batched matmuls of it with the points and their products
      (no ``(..., M, N, D)`` intermediate), in a frame centred on each
      lane's masked centroid.
    * ``"topk"``: a stable ascending sort of the distances, the first ``k``
      indices, a gather and the centred form, as ``lax.top_k`` in JAX.
    """
    k = min(k, points.shape[-2])
    dtype = points.dtype
    d2 = pairwise_sq_dists(points, points)
    big = torch.finfo(dtype).max
    d2 = d2.masked_fill(~mask[..., None, :], big)
    if selector == "auto":
        selector = "select"
    if selector == "select":
        keep = torch.full(d2.shape[:-1], k, dtype=torch.int32, device=points.device)
        w = select_smallest_weights(d2, keep, dtype) * mask[..., None, :].to(dtype)
        del d2
        sw = torch.clamp(w.sum(-1), min=1.0)
        # A translation leaves the scatter unchanged; the lane's centroid
        # keeps the products on the cloud's extent, not its distance from
        # the origin.
        p = points - geometry.masked_centroid(points, mask)[..., None, :]
        center = torch.matmul(w, p) / sw[..., None]
        outer = (p[..., :, None] * p[..., None, :]).flatten(-2)  # (..., N, D*D)
        second = torch.matmul(w, outer).unflatten(-1, (p.shape[-1],) * 2)
        ws = w.sum(-1)
        cov = (second - (2.0 * sw - ws)[..., None, None]
               * center[..., :, None] * center[..., None, :])
        return cov, sw
    if selector != "topk":
        raise ValueError(f"unknown selector {selector!r}")
    idx = torch.sort(d2, dim=-1, stable=True).indices[..., :k]  # (..., M, k)
    neigh = gather_rows(points, idx.flatten(-2)).unflatten(-2, idx.shape[-2:])  # (..., M, k, D)
    w = torch.take_along_dim(mask[..., None, :], idx, dim=-1).to(dtype)
    sw = torch.clamp(w.sum(-1), min=1.0)
    center = (neigh * w[..., None]).sum(-2) / sw[..., None]
    centered = neigh - center[..., None, :]
    cov = torch.matmul((centered * w[..., None]).transpose(-1, -2), centered)
    return cov, sw


def estimate_normals(points: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Unit normals ``(..., M, D)`` by masked k-NN PCA: the eigenvector of
    the smallest eigenvalue (the first of equal ones), unoriented."""
    cov, _ = neighborhood_moments(points, mask, k)
    eigvals, eigvecs = _jacobi_eigh_sym(cov)
    smallest = torch.argmin(eigvals, dim=-1)
    dim = points.shape[-1]
    normal = torch.take_along_dim(eigvecs, smallest[..., None, None].expand(
        *smallest.shape, dim, 1), dim=-1)[..., 0]
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    return normal / torch.clamp(norm, min=torch.finfo(points.dtype).tiny)


@dataclasses.dataclass(frozen=True)
class PointToPlaneState:
    transform: RigidTransform
    source: PointCloud
    target: PointCloud
    normals: torch.Tensor  # (..., M, D) target normals, fixed after init
    match_idx: torch.Tensor  # (..., N) int32
    match_cost: torch.Tensor  # (..., N) squared plane distance


def damped_solve(jtj: torch.Tensor, jtr: torch.Tensor) -> torch.Tensor:
    """``-(JtJ + 1e-9 tr(JtJ) I + 1e-20 I)^-1 Jtr``: the Gauss-Newton twist,
    with a tiny Tikhonov term for degenerate rows.  ``solve_ex`` reports
    singular systems in its info output instead of raising (no host sync)."""
    dof = jtj.shape[-1]
    eye = torch.eye(dof, dtype=jtj.dtype, device=jtj.device)
    trace = jtj.diagonal(dim1=-2, dim2=-1).sum(-1)
    damped = jtj + 1e-9 * trace[..., None, None] * eye + 1e-20 * eye
    return -torch.linalg.solve_ex(damped, jtr[..., None])[0][..., 0]


def solve_normal_equations(jac: torch.Tensor, r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Damped LS solve of ``min sum_i w_i (jac_i . x + r_i)^2`` -> twist.
    Shared by the point-to-plane and symmetric methods."""
    jw = jac * w[..., None]
    jtj = torch.matmul(jw.transpose(-1, -2), jac)
    jtr = torch.matmul(jw.transpose(-1, -2), r[..., None])[..., 0]
    return damped_solve(jtj, jtr)


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """2D scalar cross (``(..., N)``) or 3D vector cross (``(..., N, 3)``)."""
    if u.shape[-1] == 2:
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]
    return torch.linalg.cross(u, v, dim=-1)


def twist_rows(points: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """``[n ; p x n]`` per point: ``(..., N, dof)``."""
    c = cross(points, normals)
    return torch.cat([normals, c[..., None] if points.shape[-1] == 2 else c], dim=-1)


def _plane_sq(points, matched_b, matched_n, mask):
    r = ((points - matched_b) * matched_n).sum(-1)
    return (r * r).masked_fill(~mask, float("inf"))


def create(config: Config) -> Method:
    k = int(config.get("normal_neighbors", DEFAULT_NORMAL_NEIGHBORS))
    max_distance = config.get("max_distance", None)  # None = no gate; 0.0 is respected
    dim = int(config.get("dim", 3))

    def precompute(cloud: PointCloud) -> torch.Tensor:
        """Per-cloud unit normals (only the target's are consumed)."""
        return estimate_normals(cloud.points, cloud.mask, k)

    def _init_with(source, target, guess, normals) -> PointToPlaneState:
        a_cur = geometry.apply(guess, source.points)
        _, idx = match(a_cur, target)
        cost = _plane_sq(a_cur, gather_rows(target.points.expand_as(normals), idx),
                         gather_rows(normals, idx), source.mask)
        return PointToPlaneState(guess, source, target, normals, idx, cost)

    def init(source: PointCloud, target: PointCloud, guess: RigidTransform) -> PointToPlaneState:
        return _init_with(source, target, guess, precompute(target))

    def iterate(state: PointToPlaneState) -> PointToPlaneState:
        src, tgt = state.source, state.target
        a_cur = geometry.apply(state.transform, src.points)
        sq, idx = match(a_cur, tgt)
        w = src.mask.to(src.dtype)
        if max_distance is not None:
            w = w * (torch.sqrt(sq) <= max_distance).to(src.dtype)
        matched_b = gather_rows(tgt.points.expand_as(state.normals), idx)
        matched_n = gather_rows(state.normals, idx)
        r = ((a_cur - matched_b) * matched_n).sum(-1)
        xi = solve_normal_equations(twist_rows(a_cur, matched_n), r, w)
        new_transform = geometry.compose(lie.exp(xi, src.dim), state.transform)
        # Post-step residual under the same correspondences (a pre-step cost
        # would equal init's on iteration 1 and trip delta-cost criteria).
        a_new = geometry.apply(new_transform, src.points)
        return dataclasses.replace(
            state, transform=new_transform, match_idx=idx,
            match_cost=_plane_sq(a_new, matched_b, matched_n, src.mask),
        )

    def cost(state: PointToPlaneState) -> torch.Tensor:
        return masked_rms(state.match_cost, state.source)

    def with_precomputed(normals_a, normals_b) -> Method:
        # Only the target's normals participate in the objective.
        return Method(
            name="point_to_plane", dim=dim,
            init=lambda s, t, g: _init_with(s, t, g, normals_b),
            iterate=iterate, cost=cost, precompute=precompute,
        )

    return Method(
        name="point_to_plane", dim=dim, init=init, iterate=iterate, cost=cost,
        precompute=precompute, with_precomputed=with_precomputed,
        precompute_source=False,
    )

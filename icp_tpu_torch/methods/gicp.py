"""Generalized-ICP (plane-to-plane; Segal, Haehnel & Thrun, RSS 2009).

Port of :mod:`icp_tpu.methods.gicp`.  Every point carries a local
covariance, and the objective is the Mahalanobis distance under the
combined covariance of each correspondence:

    sum_i  d_i^T (C^b_i + R C^a_i R^T)^{-1} d_i,   d_i = R a_i + t - b_{j(i)}

* Surfel covariances for both clouds once in ``init``: masked k-NN PCA, the
  eigenvalues replaced by ``(eps, 1, ..., 1)`` (the smallest, first of equal
  ones, flattened to ``eps``).
* Each iteration: 1-NN (the kernel's K2 wrapper on the card), closed-form
  2x2 / 3x3 inverses of the combined covariances, one Gauss-Newton step on
  the SE(D) twist (``torch.linalg.solve_ex``: no host sync, non-finite on a
  singular system), exact retraction through :mod:`icp_tpu_torch.lie`.
* ``line_search`` (default on): per lane, the full, half and zero steps are
  scored by the gated mean Mahalanobis cost under the current
  correspondences and the best is kept (ties: full, then half).

Config: ``neighbors`` (int, default 20), ``cov_epsilon`` (float, default
1e-3), ``max_distance`` (float, optional gate), ``line_search`` (int/bool,
default 1), ``dim``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import geometry, lie
from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform
from ..ops.ndt import inverse_small_spd as _inv_spd  # the JAX package's gicp copy of it
from ..ops.rigid_fit import _jacobi_eigh_sym
from .base import Method, gather_rows, masked_rms, match
from .point_to_plane import damped_solve, neighborhood_moments

DEFAULT_NEIGHBORS = 20
DEFAULT_COV_EPSILON = 1e-3


def surfel_covariances(points: torch.Tensor, mask: torch.Tensor, k: int, eps: float
                       ) -> torch.Tensor:
    """GICP-regularized covariances ``(..., N, D, D)``: the neighbourhood
    covariance's eigenvectors with eigenvalues ``(eps, 1, ..., 1)``."""
    cov, sw = neighborhood_moments(points, mask, k)
    cov = cov / sw[..., None, None]
    eigvals, eigvecs = _jacobi_eigh_sym(cov)
    smallest = torch.argmin(eigvals, dim=-1)
    new_vals = torch.ones_like(eigvals)
    new_vals.scatter_(-1, smallest[..., None], eps)
    return torch.matmul(eigvecs * new_vals[..., None, :], eigvecs.transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class GicpState:
    transform: RigidTransform
    source: PointCloud
    target: PointCloud
    cov_a: torch.Tensor  # (..., N, D, D) source surfel covariances (source frame)
    cov_b: torch.Tensor  # (..., M, D, D) target surfel covariances
    match_idx: torch.Tensor  # (..., N) int32
    match_cost: torch.Tensor  # (..., N) Mahalanobis cost


def _jacobian_rows(a_cur: torch.Tensor, dim: int) -> torch.Tensor:
    """d(residual)/d(twist) ``(..., N, D, dof)`` for residual ``Ra + t - b``:
    ``[I, rot]`` with ``rot = (-a_y, a_x)`` in 2D and ``-[a]_x`` in 3D."""
    eye = torch.eye(dim, dtype=a_cur.dtype, device=a_cur.device).expand(
        *a_cur.shape[:-1], dim, dim)
    if dim == 2:
        rot_col = torch.stack([-a_cur[..., 1], a_cur[..., 0]], dim=-1)[..., None]
        return torch.cat([eye, rot_col], dim=-1)
    ax, ay, az = a_cur[..., 0], a_cur[..., 1], a_cur[..., 2]
    z = torch.zeros_like(ax)
    neg_hat = torch.stack(
        [
            torch.stack([z, az, -ay], dim=-1),
            torch.stack([-az, z, ax], dim=-1),
            torch.stack([ay, -ax, z], dim=-1),
        ],
        dim=-2,
    )
    return torch.cat([eye, neg_hat], dim=-1)


def mahalanobis(resid: torch.Tensor, w_mat: torch.Tensor) -> torch.Tensor:
    """``r^T W r`` per row: ``(..., D), (..., D, D) -> (...)``."""
    return (torch.matmul(w_mat, resid[..., None])[..., 0] * resid).sum(-1)


def gn_system(jac, w_mat, resid, w):
    """``(JtJ, Jtr)`` of ``sum_n w_n J_n^T W_n (J_n x + r_n)``: ``jac (..., N,
    D, dof)``, ``w_mat (..., N, D, D)``, ``resid (..., N, D)``, ``w (...,
    N)``, as two matmuls over the flattened ``(N, D)`` rows."""
    wj = torch.matmul(w_mat, jac) * w[..., None, None]
    wr = torch.matmul(w_mat, resid[..., None])[..., 0] * w[..., None]
    jt = jac.flatten(-3, -2).transpose(-1, -2)  # (..., dof, N*D)
    return torch.matmul(jt, wj.flatten(-3, -2)), torch.matmul(jt, wr.flatten(-2)[..., None])[..., 0]


def line_search(state_transform, xi, dim, post_cost):
    """Per-lane choice among the full, half and zero Gauss-Newton steps by
    ``post_cost(transform) -> (per-point cost, lane mean)``; ties go to the
    earlier candidate.  Returns ``(transform, per-point cost)``."""
    cands = [geometry.compose(lie.exp(xi, dim), state_transform),
             geometry.compose(lie.exp(0.5 * xi, dim), state_transform), state_transform]
    scored = [post_cost(t) for t in cands]
    best = torch.argmin(torch.stack([mean for _, mean in scored], dim=-1), dim=-1)

    def sel(values):
        out = values[2]
        for i in (1, 0):
            pick = (best == i).reshape(best.shape + (1,) * (out.dim() - best.dim()))
            out = torch.where(pick, values[i], out)
        return out

    return (RigidTransform(sel([t.rotation for t in cands]), sel([t.translation for t in cands])),
            sel([per for per, _ in scored]))


def create(config: Config) -> Method:
    k = int(config.get("neighbors", DEFAULT_NEIGHBORS))
    eps = float(config.get("cov_epsilon", DEFAULT_COV_EPSILON))
    max_distance = config.get("max_distance", None)  # None = no gate; 0.0 respected
    use_line_search = bool(config.get("line_search", 1))
    dim = int(config.get("dim", 3))

    def _residual_weights(a_cur, rot, cov_a, matched_b, matched_cb):
        """``(resid, inverse of C_b + R C_a R^T)``: the one source of the
        objective for the solve, the line search and the stored cost."""
        r = rot[..., None, :, :]
        rca = torch.matmul(torch.matmul(r, cov_a), r.transpose(-1, -2))
        return a_cur - matched_b, _inv_spd(matched_cb + rca)

    def _gather(target, cov_b, idx):
        return gather_rows(target.points.expand(cov_b.shape[:-1]), idx), gather_rows(cov_b, idx)

    def _gate(mask, sq, dtype):
        w = mask.to(dtype)
        if max_distance is not None:
            w = w * (torch.sqrt(sq) <= max_distance).to(dtype)
        return w

    def precompute(cloud: PointCloud) -> torch.Tensor:
        """Per-cloud surfel covariances (the init-dominating estimation)."""
        return surfel_covariances(cloud.points, cloud.mask, k, eps)

    def _init_with(source, target, guess, cov_a, cov_b) -> GicpState:
        a_cur = geometry.apply(guess, source.points)
        sq, idx = match(a_cur, target)
        matched_b, matched_cb = _gather(target, cov_b, idx)
        resid, w_mat = _residual_weights(a_cur, guess.rotation, cov_a, matched_b, matched_cb)
        mahal = mahalanobis(resid, w_mat) * _gate(source.mask, sq, source.dtype)
        return GicpState(guess, source, target, cov_a, cov_b, idx,
                         mahal.masked_fill(~source.mask, float("inf")))

    def init(source: PointCloud, target: PointCloud, guess: RigidTransform) -> GicpState:
        return _init_with(source, target, guess, precompute(source), precompute(target))

    def iterate(state: GicpState) -> GicpState:
        src, tgt = state.source, state.target
        a_cur = geometry.apply(state.transform, src.points)
        sq, idx = match(a_cur, tgt)
        w_valid = _gate(src.mask, sq, src.dtype)
        matched_b, matched_cb = _gather(tgt, state.cov_b, idx)
        resid, w_mat = _residual_weights(
            a_cur, state.transform.rotation, state.cov_a, matched_b, matched_cb)
        xi = damped_solve(*gn_system(_jacobian_rows(a_cur, src.dim), w_mat, resid, w_valid))
        n_gated = torch.clamp(w_valid.sum(-1), min=1.0)

        def post_cost(transform):
            """Gated per-point and mean Mahalanobis cost at ``transform``
            under the current correspondences."""
            r, w = _residual_weights(geometry.apply(transform, src.points), transform.rotation,
                                     state.cov_a, matched_b, matched_cb)
            mahal = mahalanobis(r, w) * w_valid
            return mahal, mahal.sum(-1) / n_gated

        if use_line_search:
            new_transform, mahal = line_search(state.transform, xi, src.dim, post_cost)
        else:
            # The post-step cost, so that iteration 1's differs from init's.
            new_transform = geometry.compose(lie.exp(xi, src.dim), state.transform)
            mahal, _ = post_cost(new_transform)
        return dataclasses.replace(
            state, transform=new_transform, match_idx=idx,
            match_cost=mahal.masked_fill(~src.mask, float("inf")),
        )

    def cost(state: GicpState) -> torch.Tensor:
        return masked_rms(state.match_cost, state.source)

    def with_precomputed(cov_a: torch.Tensor, cov_b: torch.Tensor) -> Method:
        return Method(
            name="gicp", dim=dim,
            init=lambda s, t, g: _init_with(s, t, g, cov_a, cov_b),
            iterate=iterate, cost=cost, precompute=precompute,
        )

    return Method(
        name="gicp", dim=dim, init=init, iterate=iterate, cost=cost,
        precompute=precompute, with_precomputed=with_precomputed,
    )

"""Symmetric-objective ICP (Rusinkiewicz 2019).

Port of :mod:`icp_tpu.methods.symmetric`.  Minimizes the symmetrized
point-to-plane residual

    sum_i w_i ( (R a_i + t - b_{j(i)}) . (R n^a_i + n^b_{j(i)}) )^2

with source normals ``n^a`` carried through the current rotation and target
normals ``n^b``, both estimated once in ``init`` by masked k-NN PCA.  The
Gauss-Newton rows are the full analytic Jacobian including the
normal-rotation term: with ``p = R a``, ``m = R n^a``, ``n = m + n^b`` and
``d = R a + t - b``, ``dr/dt = n`` and ``dr/domega = p x n + m x d``.  The
stored cost is the post-step residual with post-step-rotated normals.

The correspondence is the 1-NN kernel's K2 wrapper on the card.

Config: ``normal_neighbors`` (int, default 10), ``max_distance`` (float,
optional gate), ``dim`` (2 or 3).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import geometry, lie
from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform
from .base import Method, gather_rows, masked_rms, match
from .point_to_plane import (
    DEFAULT_NORMAL_NEIGHBORS,
    cross,
    estimate_normals,
    solve_normal_equations,
)


@dataclasses.dataclass(frozen=True)
class SymmetricState:
    transform: RigidTransform
    source: PointCloud
    target: PointCloud
    normals_a: torch.Tensor  # (..., N, D) source normals (source frame), fixed
    normals_b: torch.Tensor  # (..., M, D) target normals, fixed
    match_idx: torch.Tensor  # (..., N) int32
    match_cost: torch.Tensor  # (..., N) squared symmetric-plane residual


def _summed_normals(rot, normals_a, matched_nb):
    """``(m, n)``: rotated source normals, flipped per pair to agree with
    the unoriented ``n_b`` (else antiparallel pairs cancel), and their sum."""
    m = torch.matmul(normals_a, rot.transpose(-1, -2))
    sign = torch.sign((m * matched_nb).sum(-1))
    sign = torch.where(sign == 0, 1.0, sign)
    m = m * sign[..., None]
    return m, m + matched_nb


def _plane_cost(transform, src, matched_b, matched_nb, normals_a):
    a_pts = geometry.apply(transform, src.points)
    _, n_sum = _summed_normals(transform.rotation, normals_a, matched_nb)
    r = ((a_pts - matched_b) * n_sum).sum(-1)
    return (r * r).masked_fill(~src.mask, float("inf"))


def create(config: Config) -> Method:
    k = int(config.get("normal_neighbors", DEFAULT_NORMAL_NEIGHBORS))
    max_distance = config.get("max_distance", None)  # None = no gate
    dim = int(config.get("dim", 3))

    def _gather(target, normals_b, idx):
        return gather_rows(target.points.expand_as(normals_b), idx), gather_rows(normals_b, idx)

    def precompute(cloud: PointCloud) -> torch.Tensor:
        """Per-cloud unit normals (both clouds' take part)."""
        return estimate_normals(cloud.points, cloud.mask, k)

    def _init_with(source, target, guess, normals_a, normals_b) -> SymmetricState:
        a_cur = geometry.apply(guess, source.points)
        _, idx = match(a_cur, target)
        matched_b, matched_nb = _gather(target, normals_b, idx)
        cost = _plane_cost(guess, source, matched_b, matched_nb, normals_a)
        return SymmetricState(guess, source, target, normals_a, normals_b, idx, cost)

    def init(source: PointCloud, target: PointCloud, guess: RigidTransform) -> SymmetricState:
        return _init_with(source, target, guess, precompute(source), precompute(target))

    def iterate(state: SymmetricState) -> SymmetricState:
        src, tgt = state.source, state.target
        rot, trans = state.transform.rotation, state.transform.translation
        a_cur = geometry.apply(state.transform, src.points)
        sq, idx = match(a_cur, tgt)
        w = src.mask.to(src.dtype)
        if max_distance is not None:
            w = w * (torch.sqrt(sq) <= max_distance).to(src.dtype)

        matched_b, matched_nb = _gather(tgt, state.normals_b, idx)
        m, n_sum = _summed_normals(rot, state.normals_a, matched_nb)
        d = a_cur - matched_b
        p = a_cur - trans[..., None, :]  # R a (rotation-only part)
        r = (d * n_sum).sum(-1)
        rot_rows = cross(p, n_sum) + cross(m, d)
        jac = torch.cat([n_sum, rot_rows[..., None] if src.dim == 2 else rot_rows], dim=-1)
        xi = solve_normal_equations(jac, r, w)
        new_transform = geometry.compose(lie.exp(xi, src.dim), state.transform)
        # The objective at the returned transform, same correspondences.
        cost = _plane_cost(new_transform, src, matched_b, matched_nb, state.normals_a)
        return dataclasses.replace(state, transform=new_transform, match_idx=idx,
                                   match_cost=cost)

    def cost(state: SymmetricState) -> torch.Tensor:
        return masked_rms(state.match_cost, state.source)

    def with_precomputed(normals_a, normals_b) -> Method:
        return Method(
            name="symmetric", dim=dim,
            init=lambda s, t, g: _init_with(s, t, g, normals_a, normals_b),
            iterate=iterate, cost=cost, precompute=precompute,
        )

    return Method(
        name="symmetric", dim=dim, init=init, iterate=iterate, cost=cost,
        precompute=precompute, with_precomputed=with_precomputed,
    )

"""2D ``trimmed`` ICP (Chetverikov et al., Trimmed ICP).

Port of :mod:`icp_tpu.methods.trimmed`, after ``lib/icp/impl/trimmed.cpp``:
each iteration matches every transformed source point to its nearest target
(squared distances, ``trimmed.cpp:95-109``), keeps the
``max(1, floor(overlap_rate * n))`` cheapest matches (``trimmed.cpp:55-58``)
as 0/1 weights, and fits a rigid step to the kept subset.

The correspondence is the CUDA kernel on the card: ``init`` takes
``(sq, idx)`` from :func:`~icp_tpu_torch.ops.pallas_nn.nearest_neighbors_pallas`
(K2), and ``iterate`` takes the matched coordinates as well from
:func:`~icp_tpu_torch.ops.fused_nn.fused_nearest_neighbors` (K1), so the fit
needs no gather.  The carried coordinates are exact copies of target rows,
so in float64 this is the arithmetic of the JAX package's gather path.

``cost`` is the RMS of the untrimmed squared distances of all n matches.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import geometry
from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform
from ..ops.fused_nn import fused_nearest_neighbors
from ..ops.pallas_nn import nearest_neighbors_pallas
from ..ops.rigid_fit import fit_rigid
from ..ops.select import select_smallest_weights
from .base import Method, lane_targets, masked_rms

DEFAULT_OVERLAP_RATE = 0.9  # ``trimmed.cpp:28``


@dataclasses.dataclass(frozen=True)
class TrimmedState:
    transform: RigidTransform
    source: PointCloud
    target: PointCloud
    match_idx: torch.Tensor  # (..., N) int32
    match_cost: torch.Tensor  # (..., N) squared NN distance (+inf on padding)


def stable_ranks(costs: torch.Tensor) -> torch.Tensor:
    """Stable ascending rank of each cost (ties: the lower index ranks first).

    The test oracle of the trim selection: compare-count
    ``#{j: c_j < c_i} + #{j < i: c_j == c_i}`` up to N = 4096, a stable
    argsort inverted above that.
    """
    n = costs.shape[-1]
    idx = torch.arange(n, device=costs.device)
    if n <= 4096:
        c_i = costs[..., :, None]
        c_j = costs[..., None, :]
        less = (c_j < c_i).sum(-1)
        eq_lower = ((c_j == c_i) & (idx[None, :] < idx[:, None])).sum(-1)
        return (less + eq_lower).to(torch.int32)
    order = torch.argsort(costs, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(-1, order, idx.expand(order.shape))
    return ranks.to(torch.int32)


def trim_weights(
    costs: torch.Tensor,
    valid_count: torch.Tensor,
    overlap_rate: float,
    dtype: torch.dtype,
    selector: str = "auto",
) -> torch.Tensor:
    """0/1 weights selecting the ``max(1, floor(overlap_rate * n))`` smallest costs.

    ``costs`` are +inf at padded slots, so they rank last; ``valid_count`` is
    n per lane.  ``selector``: ``"radix"`` (the default, the bitwise search of
    :mod:`icp_tpu_torch.ops.select`) or ``"rank"`` (:func:`stable_ranks`);
    both select the same set.
    """
    # A Python scalar operand is rounded to ``dtype``, as the JAX package's
    # ``asarray(overlap_rate, dtype)``, and needs no host-to-device copy.
    keep = torch.floor(valid_count.to(dtype) * overlap_rate).to(torch.int32)
    keep = torch.clamp(keep, min=1)  # ``trimmed.cpp:58``
    if selector in ("auto", "radix"):
        selected = select_smallest_weights(costs, keep, dtype)
    elif selector == "rank":
        selected = (stable_ranks(costs) < keep[..., None]).to(dtype)
    else:
        raise ValueError(f"unknown selector {selector!r}")
    # Padded slots (cost +inf) are selected only when a lane has no valid
    # point (keep's floor of 1); zeroing them makes an empty cloud's step
    # the identity instead of pulling a padding point onto the target.
    return selected * torch.isfinite(costs).to(dtype)


def _masked_cost(sq: torch.Tensor, source: PointCloud) -> torch.Tensor:
    return sq.masked_fill(~source.mask, float("inf"))


def create(config: Config) -> Method:
    overlap_rate = config.get("overlap_rate", DEFAULT_OVERLAP_RATE)

    def init(source: PointCloud, target: PointCloud, guess: RigidTransform) -> TrimmedState:
        a_current = geometry.apply(guess, source.points)
        points, mask = lane_targets(target, a_current.shape[:-2])
        sq, idx = nearest_neighbors_pallas(a_current, points, mask)
        return TrimmedState(guess, source, target, idx, _masked_cost(sq, source))

    def iterate(state: TrimmedState) -> TrimmedState:
        src, tgt = state.source, state.target
        a_current = geometry.apply(state.transform, src.points)
        points, mask = lane_targets(tgt, a_current.shape[:-2])
        sq, idx, coords = fused_nearest_neighbors(a_current, points, mask, return_coords=True)
        sq = _masked_cost(sq, src)
        weights = trim_weights(sq, src.count, overlap_rate, src.dtype)
        step = fit_rigid(a_current, coords, weights)
        return dataclasses.replace(
            state,
            transform=geometry.compose(step, state.transform),
            match_idx=idx,
            match_cost=sq,
        )

    def cost(state: TrimmedState) -> torch.Tensor:
        return masked_rms(state.match_cost, state.source)

    return Method(name="trimmed", dim=2, init=init, iterate=iterate, cost=cost)

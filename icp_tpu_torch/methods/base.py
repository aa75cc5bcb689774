"""Method interface and string-keyed registry.

Port of :mod:`icp_tpu.methods.base`.  A method is a bundle of plain
functions over an immutable state (``ICP<Dim>``'s ``setup``/``iterate``/
``calculate_cost``, ``include/icp/icp.h:49-173``):

* ``init(source, target, guess) -> state``
* ``iterate(state) -> state``
* ``cost(state) -> (...,) tensor``

States carry any leading batch dims, so one call registers one pair or
thousands.  The registry mirrors ``from_method`` (``icp.h:95-114``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform
from ..ops.pallas_nn import nearest_neighbors_pallas


@dataclasses.dataclass(frozen=True)
class Method:
    """A registered ICP method: plain init/iterate/cost over a state.

    ``precompute``/``with_precomputed`` (optional) expose per-cloud derived
    data that ``init`` would otherwise recompute (normals, surfel
    covariances): ``precompute(cloud)`` returns it for a (batched) cloud, and
    ``with_precomputed(aux_source, aux_target)`` returns a Method whose
    ``init`` consumes it, so a sequential pipeline computes it once per scan.
    ``precompute_source`` is False for methods that derive data from the
    target only; they accept ``with_precomputed(None, aux_target)``.  The
    five reference methods use none of them; point_to_plane, symmetric,
    gicp and ndt do.
    """

    name: str
    dim: int
    init: Callable[[PointCloud, PointCloud, RigidTransform], Any]
    iterate: Callable[[Any], Any]
    cost: Callable[[Any], torch.Tensor]
    precompute: Callable[[PointCloud], Any] | None = None
    with_precomputed: Callable[[Any, Any], "Method"] | None = None
    precompute_source: bool = True


@dataclasses.dataclass(frozen=True)
class Matches:
    """Per-source-point correspondences (``ICP::get_matches``, ``icp.h:61-70``)
    as arrays; ``valid`` marks real source points."""

    source_idx: torch.Tensor  # (..., N) int32
    target_idx: torch.Tensor  # (..., N) int32
    cost: torch.Tensor  # (..., N)
    valid: torch.Tensor  # (..., N) bool


def get_matches(state) -> Matches | None:
    """The current match set of a method state, or None if it tracks none
    (the 3D methods, whose matches the reference never fills)."""
    idx = getattr(state, "match_idx", None)
    cost = getattr(state, "match_cost", None)
    if idx is None or cost is None:
        return None
    n = idx.shape[-1]
    src = torch.arange(n, dtype=torch.int32, device=idx.device).expand(idx.shape)
    return Matches(source_idx=src, target_idx=idx, cost=cost, valid=state.source.mask)


def lane_targets(target: PointCloud, lead: torch.Size) -> tuple[torch.Tensor, torch.Tensor]:
    """Target points and mask expanded to the queries' leading dims and made
    contiguous, as the NN kernel takes them (one target set per lane)."""
    points = target.points.expand(*lead, *target.points.shape[-2:]).contiguous()
    mask = target.mask.expand(*lead, target.capacity).contiguous()
    return points, mask


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[..., idx, ...]`` per lane: rows ``(..., M, *tail)`` picked by
    ``idx (..., N)`` into ``(..., N, *tail)`` (``take_along_axis`` on the
    row axis); the tail's length is read from ``values``' rank against
    ``idx``'s."""
    lead = idx.shape[:-1]
    tail = values.shape[len(lead) + 1:]
    rows = values.reshape(*values.shape[: len(lead) + 1], -1)
    got = torch.take_along_dim(rows, idx.long()[..., None], dim=-2)
    return got.reshape(*got.shape[:-1], *tail)


def match(a_cur: torch.Tensor, target: PointCloud) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sq, idx)`` of each moved source point's nearest valid target, from
    the 1-NN kernel's K2 wrapper (its plain version on the CPU)."""
    points, mask = lane_targets(target, a_cur.shape[:-2])
    return nearest_neighbors_pallas(a_cur, points, mask)


def masked_rms(match_cost: torch.Tensor, source: PointCloud) -> torch.Tensor:
    """``sqrt(mean)`` of the per-point costs over the valid source points:
    the driver cost of trimmed and of the net-new families."""
    finite = match_cost.masked_fill(~source.mask, 0.0)
    n = torch.clamp(source.count.to(finite.dtype), min=1.0)
    return torch.sqrt(finite.sum(-1) / n)


MethodFactory = Callable[[Config], Method]

_REGISTRY: dict[tuple[str, int], MethodFactory] = {}


def register_method(name: str, dim: int, factory: MethodFactory) -> None:
    """Register a method constructor under ``(name, dim)``."""
    _REGISTRY[(name, dim)] = factory


def from_method(name: str, dim: int, config: Config | None = None) -> Method:
    """Construct a method by name; ``KeyError`` lists the registered ones."""
    key = (name, dim)
    if key not in _REGISTRY:
        raise KeyError(f"unknown {dim}D method {name!r}; registered: {registered_methods(dim)}")
    return _REGISTRY[key](config if config is not None else Config())


def is_method_registered(name: str, dim: int) -> bool:
    return (name, dim) in _REGISTRY


def registered_methods(dim: int) -> list[str]:
    return sorted(n for (n, d) in _REGISTRY if d == dim)

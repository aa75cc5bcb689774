"""Carry state between the JAX package and this port, as numpy arrays.

The JAX package's objects are read out with ``np.asarray`` on its fields and
rebuilt here (and back), so the same numbers enter both implementations.  The
constructors put their tensors on the card unless ``device="cpu"`` is passed,
as the tests that compare with the JAX package do:

* ``PointCloud.points`` / ``.count``
* ``RigidTransform.rotation`` / ``.translation``
* ``DriverConfig`` fields, as a mapping (``dataclasses.asdict`` of either)
* methods' precomputed state (``Method.precompute``): per-point normals
  ``(..., N, D)``, surfel covariances ``(..., N, D, D)``, and an ``NdtMap``'s
  fields (``jax_map._asdict()`` of the JAX package's map), so that
  ``with_precomputed`` can be fed from one source on both sides
* a ``PoseGraph``'s fields (``dataclasses.asdict`` of the JAX package's
  graph): poses, ``edges_ij``, measurements, weights, ``sqrt_information``
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .cloud import PointCloud
from .driver import DriverConfig
from .geometry import RigidTransform, default_dtype
from .ops.ndt import NdtMap
from .pose_graph import PoseGraph


def _tensor(array, dtype, device) -> torch.Tensor:
    dtype = default_dtype(device) if dtype is None else dtype
    return torch.tensor(np.asarray(array), dtype=dtype, device=device)


def cloud_from_numpy(points, count, *, dtype=None, device="cuda") -> PointCloud:
    """A cloud from ``points (..., N, D)`` and ``count (...,)`` arrays."""
    count = torch.tensor(np.asarray(count), dtype=torch.int32, device=device)
    return PointCloud(_tensor(points, dtype, device).contiguous(), count)


def cloud_to_numpy(cloud: PointCloud) -> tuple[np.ndarray, np.ndarray]:
    """``(points, count)`` of a cloud as numpy arrays."""
    return cloud.points.cpu().numpy(), cloud.count.cpu().numpy()


def transform_from_numpy(rotation, translation, *, dtype=None, device="cuda") -> RigidTransform:
    """A transform from ``rotation (..., D, D)`` and ``translation (..., D)`` arrays."""
    return RigidTransform(
        _tensor(rotation, dtype, device).contiguous(), _tensor(translation, dtype, device)
    )


def transform_to_numpy(transform: RigidTransform) -> tuple[np.ndarray, np.ndarray]:
    """``(rotation, translation)`` of a transform as numpy arrays."""
    return transform.rotation.cpu().numpy(), transform.translation.cpu().numpy()


def driver_config_from_fields(fields: Mapping[str, Any]) -> DriverConfig:
    """A :class:`DriverConfig` from a mapping of its field names; unknown
    names raise ``TypeError``."""
    return DriverConfig(**dict(fields))


def driver_config_to_fields(config: DriverConfig) -> dict[str, Any]:
    """The fields of a :class:`DriverConfig` as a dict."""
    return dataclasses.asdict(config)


def normals_from_numpy(normals, *, dtype=None, device="cuda") -> torch.Tensor:
    """Per-point normals ``(..., N, D)`` (point_to_plane, symmetric)."""
    out = _tensor(normals, dtype, device)
    if out.dim() < 2 or out.shape[-1] not in (2, 3):
        raise ValueError(f"normals must be (..., N, D) with D in (2, 3), got {tuple(out.shape)}")
    return out.contiguous()


def covariances_from_numpy(covariances, *, dtype=None, device="cuda") -> torch.Tensor:
    """Per-point surfel covariances ``(..., N, D, D)`` (gicp)."""
    out = _tensor(covariances, dtype, device)
    if out.dim() < 3 or out.shape[-1] not in (2, 3) or out.shape[-2] != out.shape[-1]:
        raise ValueError(f"covariances must be (..., N, D, D), got {tuple(out.shape)}")
    return out.contiguous()


def ndt_map_from_numpy(fields: Mapping[str, Any], *, dtype=None, device="cuda") -> NdtMap:
    """An :class:`~icp_tpu_torch.ops.ndt.NdtMap` from a mapping of its field
    names to arrays: keys as int32, valid and overflowed as bool, the rest
    in ``dtype``.  Missing or unknown names raise ``KeyError``."""
    if set(fields) != set(NdtMap._fields):
        raise KeyError(f"NdtMap fields {sorted(NdtMap._fields)}, got {sorted(fields)}")
    exact = {"keys": torch.int32, "valid": torch.bool, "overflowed": torch.bool}
    return NdtMap(**{
        name: (torch.tensor(np.asarray(fields[name]), dtype=exact[name], device=device)
               if name in exact else _tensor(fields[name], dtype, device)).contiguous()
        for name in NdtMap._fields
    })


def pose_graph_from_numpy(fields: Mapping[str, Any], *, dtype=None, device="cuda") -> PoseGraph:
    """A :class:`~icp_tpu_torch.pose_graph.PoseGraph` from a mapping of its
    field names: ``poses`` and ``measurements`` as mappings of ``rotation``
    and ``translation``, ``edges_ij`` as int32, ``weights`` and the optional
    ``sqrt_information`` in ``dtype``.  ``dataclasses.asdict`` of the JAX
    package's graph is such a mapping, and so is :func:`pose_graph_to_numpy`'s
    result."""
    sqrt_info = fields.get("sqrt_information")
    poses, meas = fields["poses"], fields["measurements"]
    return PoseGraph(
        poses=transform_from_numpy(poses["rotation"], poses["translation"], dtype=dtype,
                                   device=device),
        edges_ij=torch.tensor(np.asarray(fields["edges_ij"]), dtype=torch.int32,
                              device=device).reshape(-1, 2),
        measurements=transform_from_numpy(meas["rotation"], meas["translation"], dtype=dtype,
                                          device=device),
        weights=_tensor(fields["weights"], dtype, device),
        sqrt_information=None if sqrt_info is None else _tensor(sqrt_info, dtype,
                                                                device).contiguous(),
    )


def pose_graph_to_numpy(graph: PoseGraph) -> dict[str, Any]:
    """The fields of a pose graph as numpy arrays, shaped like
    ``dataclasses.asdict`` of the JAX package's graph."""

    def transform(t):
        rotation, translation = transform_to_numpy(t)
        return {"rotation": rotation, "translation": translation}

    return {
        "poses": transform(graph.poses),
        "edges_ij": graph.edges_ij.cpu().numpy(),
        "measurements": transform(graph.measurements),
        "weights": graph.weights.cpu().numpy(),
        "sqrt_information": (None if graph.sqrt_information is None
                             else graph.sqrt_information.cpu().numpy()),
    }

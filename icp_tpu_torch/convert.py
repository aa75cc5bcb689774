"""Carry state between the JAX package and this port, as numpy arrays.

The JAX package's objects are read out with ``np.asarray`` on its fields and
rebuilt here (and back), so the same numbers enter both implementations.  The
constructors put their tensors on the card unless ``device="cpu"`` is passed,
as the tests that compare with the JAX package do:

* ``PointCloud.points`` / ``.count``
* ``RigidTransform.rotation`` / ``.translation``
* ``DriverConfig`` fields, as a mapping (``dataclasses.asdict`` of either)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .cloud import PointCloud
from .driver import DriverConfig
from .geometry import RigidTransform, default_dtype


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

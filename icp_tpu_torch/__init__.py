"""icp_tpu_torch — the PyTorch / CUDA port of :mod:`icp_tpu`.

Batched 2D trimmed ICP on tensors, with the exact masked 1-NN
correspondence as a CUDA kernel for Hopper (``csrc/nn.cu``, built with
``nvcc`` at first use).  The JAX package is the reference each module is
tested against.  The entry points put their tensors on the card unless the
caller passes ``device="cpu"``.  Dtype policy: float64 on the CPU, float32 on
CUDA.

Quick start (on the card, in float32)::

    import icp_tpu_torch as icp

    a = icp.from_points(icp.io.parse_lidar_scan_array("ex_data/scan1/first.csv"))
    b = icp.from_points(icp.io.parse_lidar_scan_array("ex_data/scan1/second.csv"))
    cfg = icp.DriverConfig(max_iterations=50, angle_tolerance=0.1 * 3.14159 / 180,
                           translation_tolerance=0.01)
    result, _ = icp.converge(icp.from_method("trimmed", 2), a, b, icp.identity(2), cfg)
"""

import torch

from . import cloud, convert, driver, geometry, io, methods, multiscale, ops
from .cloud import PointCloud, bucket_capacity, from_points, pad_to, stack, to_numpy
from .config import Config
from .driver import ConvergenceState, DriverConfig, converge
from .geometry import RigidTransform, apply, compose, from_angle_2d, identity, inverse
from .methods import from_method, get_matches, is_method_registered, registered_methods
from .multiscale import converge_multiscale

# Pose math needs full float32 precision: TF32 pushes composed rotations off
# SO(D) and moves converged poses by centimetres.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "Config",
    "ConvergenceState",
    "DriverConfig",
    "PointCloud",
    "RigidTransform",
    "apply",
    "bucket_capacity",
    "cloud",
    "compose",
    "converge",
    "converge_multiscale",
    "convert",
    "driver",
    "from_angle_2d",
    "from_method",
    "from_points",
    "geometry",
    "get_matches",
    "identity",
    "inverse",
    "io",
    "is_method_registered",
    "methods",
    "multiscale",
    "ops",
    "pad_to",
    "registered_methods",
    "stack",
    "to_numpy",
]

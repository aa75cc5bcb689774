"""icp_tpu_torch — the PyTorch / CUDA port of :mod:`icp_tpu`.

Batched ICP on tensors: the five reference methods (2D ``vanilla``,
``trimmed``, ``feature_aware``; 3D ``vanilla``, ``trimmed``) and the
net-new families ``point_to_plane``, ``robust``, ``symmetric``, ``gicp`` and
``ndt`` in 2D and 3D, the SE(2)/SE(3) maps (``lie``), the convergence
drivers, multiscale registration (point decimation, and NDT's cell-size
schedule), the global initializers (``ops.coarse``) and outlier filter
(``ops.filters``), the odometry front end (``odometry``: batched chains and
keyframe streams; ``mapping``: scan-to-map against a voxel map), trajectory
evaluation (``eval``, TUM files in ``io``), a micro-batching registration
server (``serve.BatchingRegistrar``), the pose-graph back end
(``pose_graph``: GN/LM with dense, CG and block-Jacobi PCG solves, robust
kernels and GNC, two-pass robust solves, loop candidates and closure
registration; ``robustness``: the outlier-injection protocol; g2o files in
``io``), Scan Context place recognition (``ops.descriptor``), online and
offline SLAM (``slam``: ``OnlineSlam``, ``run_slam``, ``merge_sessions``,
``relocalize``; ``OnlineSlam(async_refine=True)`` solves on a worker
thread), checkpoints (``checkpoint``, ``resilient``), offline rendering
(``vis``), the profiler and NVTX ranges (``utils.profiling``), the distributed layer
(``parallel``: a ``(data, points)`` device mesh over ``torch.distributed``,
sharded batched registration, split-target and ring NN, big-cloud
registration; ``pose_graph.shard_over_edges``), the
scan/sweep/PLY readers (with the native CSV loader, ``utils.native``), a CLI
(``python -m icp_tpu_torch.cli``: ``register``, ``view``, ``bench``,
``odometry``, ``graph``) and examples (``python -m
icp_tpu_torch.examples.NAME``).  The exact masked 1-NN
correspondence is a CUDA kernel for Hopper (``csrc/nn.cu``, built with
``nvcc`` at first use).  The JAX package is the reference each module is
tested against.  The entry points put their tensors on the card unless the
caller passes ``device="cpu"``.  Dtype policy: float64 on the CPU, float32 on
CUDA.

Quick start (on the card, in float32)::

    import icp_tpu_torch as icp

    a = icp.parse_lidar_scan("ex_data/scan1/first.csv")
    b = icp.parse_lidar_scan("ex_data/scan1/second.csv")
    cfg = icp.DriverConfig(max_iterations=50, angle_tolerance=0.1 * 3.14159 / 180,
                           translation_tolerance=0.01)
    result, _ = icp.converge(icp.from_method("trimmed", 2), a, b, icp.identity(2), cfg)

    # 3D: PLY clouds
    src = icp.from_points(icp.read_ply("ex_data/ply/queen_scale_transformed.ply"))
    dst = icp.from_points(icp.read_ply("ex_data/ply/queen_scale.ply"))
    cfg3 = icp.DriverConfig(max_iterations=100, angle_tolerance=1e-4,
                            translation_tolerance=1e-4)
    result, _ = icp.converge(icp.from_method("trimmed", 3), src, dst, icp.identity(3), cfg3)
"""

import torch

from . import (
    checkpoint,
    cloud,
    convert,
    driver,
    eval,
    geometry,
    io,
    lie,
    mapping,
    methods,
    multiscale,
    odometry,
    ops,
    parallel,
    pose_graph,
    resilient,
    robustness,
    serve,
    slam,
    utils,
)
from .cloud import PointCloud, bucket_capacity, from_points, pad_to, stack, to_numpy
from .config import Config
from .driver import ConvergenceState, DriverConfig, converge, converge_stepped, make_converge_fn
from .geometry import RigidTransform, apply, compose, from_angle_2d, identity, inverse
from .io import parse_lidar_scan, read_ply, write_ply
from .methods import (
    Matches,
    from_method,
    get_matches,
    is_method_registered,
    register_method,
    registered_methods,
)
from .multiscale import converge_multiscale
from .serve import BatchingRegistrar

# Pose math needs full float32 precision: TF32 pushes composed rotations off
# SO(D) and moves converged poses by centimetres.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "BatchingRegistrar",
    "Config",
    "ConvergenceState",
    "DriverConfig",
    "Matches",
    "PointCloud",
    "RigidTransform",
    "apply",
    "bucket_capacity",
    "checkpoint",
    "cloud",
    "compose",
    "converge",
    "converge_multiscale",
    "converge_stepped",
    "convert",
    "driver",
    "eval",
    "from_angle_2d",
    "from_method",
    "from_points",
    "geometry",
    "get_matches",
    "identity",
    "inverse",
    "io",
    "is_method_registered",
    "lie",
    "make_converge_fn",
    "mapping",
    "methods",
    "multiscale",
    "odometry",
    "ops",
    "pad_to",
    "parallel",
    "pose_graph",
    "parse_lidar_scan",
    "read_ply",
    "register_method",
    "registered_methods",
    "resilient",
    "robustness",
    "serve",
    "slam",
    "stack",
    "to_numpy",
    "utils",
    "write_ply",
]

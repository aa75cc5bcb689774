"""Runnable examples of the port, the JAX package's ``examples/`` for the
modules ported so far.  Run one as ``python -m icp_tpu_torch.examples.NAME``
from the repository's root:

* ``register_pair``: one 2D scan pair (the reference README's usage path);
* ``serving_demo``: concurrent clients through the micro-batching server;
* ``slam_pipeline``: odometry, loop closure and a pose-graph solve, rendered;
* ``place_recognition``: Scan Context finds a revisit that pose-radius search
  misses under drift;
* ``odometry_sequence``: the ``ex_data/seq1`` sweeps to an ATE;
* ``odometry_sequence_3d``: the ``ex_data/seq3d`` PLYs, GICP and an SE(3)
  closure;
* ``online_slam``: scans one at a time through ``slam.OnlineSlam``;
* ``multi_session_merge``: two laps mapped apart, merged into one map;
* ``fleet_registration``: a batch of pairs over a device mesh
  (``icp_tpu_torch.parallel``), one rank alone or several under ``torchrun``.

They run on the CUDA card and fail without one.  The environment selects
the rest: ``ICP_EXAMPLES_CPU=1`` runs on the CPU (float64),
``ICP_EXAMPLES_QUICK=1`` at the JAX examples' smoke-test sizes, and images go to
``ICP_EXAMPLES_OUT`` (else the working directory).
"""

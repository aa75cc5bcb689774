"""Fixtures of the PyTorch port's tests (``tests/port/test_torch_*.py``).

The parent ``tests/conftest.py`` already puts JAX on the CPU with float64
enabled.  Tests that need a CUDA card carry the ``cuda`` marker and take the
``cuda_device`` fixture, which skips them where there is no card; whether
there is one is decided here, when the test runs, never at import.

The SLAM tests of several modules share one JAX method object and one
scenario (``trimmed_pair``, ``circle_scans``): the JAX package caches its
compiled programs per method object, so sharing it compiles them once.
"""

import math
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU: python3 chip_smoke.py)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def scan_dir():
    """The in-repo example scans (ex_data/scan{1,2,3})."""
    return os.path.join(REPO, "ex_data")


@pytest.fixture(scope="session")
def trimmed_pair():
    """The 2D trimmed method (overlap 1.0) of the JAX package and of the port."""
    import icp_tpu as J

    import icp_tpu_torch as T

    return (J.from_method("trimmed", 2, J.Config(overlap_rate=1.0)),
            T.from_method("trimmed", 2, T.Config(overlap_rate=1.0)))


@pytest.fixture(scope="session")
def circle_scans():
    """``tests/test_online_slam.py::_circle_scans``: 49 scans of one world
    around a circle of radius 4 m (7.5 degrees a scan, the last at the
    first's place) at capacity 152, float64, as (JAX clouds, port clouds on
    the CPU) from the same arrays."""
    import numpy as np

    import icp_tpu as J
    from icp_tpu_torch import convert

    rng = np.random.default_rng(123)
    world = rng.uniform(-30, 30, (150, 2))
    jax_clouds, port_clouds = [], []
    for k in range(49):
        phi = 2 * math.pi * k / 48
        px, py, th = 4.0 * math.cos(phi), 4.0 * math.sin(phi), phi + math.pi / 2
        c, s = np.cos(th), np.sin(th)
        pts = (world - [px, py]) @ np.array([[c, -s], [s, c]])
        j = J.from_points(pts + rng.normal(0, 0.02, pts.shape), capacity=152, dtype=np.float64)
        jax_clouds.append(j)
        port_clouds.append(convert.cloud_from_numpy(np.asarray(j.points), np.asarray(j.count),
                                                    device="cpu"))
    return jax_clouds, port_clouds

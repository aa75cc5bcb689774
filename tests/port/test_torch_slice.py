"""The whole slice: scan CSV -> clouds -> multiscale trimmed ICP, the port
against the JAX package on the main path's workload cut to B = 4 lanes
(scan1, capacity 1024, the bench's seeded guesses and driver config), in
float64.  Iteration counts must be equal; poses agree at atol 1e-9 and costs
at rtol 1e-9 (the sums are taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu.multiscale import converge_multiscale as jax_converge_multiscale
from icp_tpu_torch import convert
from icp_tpu_torch.ops import fused_nn

BATCH = 4
CAPACITY = 1024


def _bench_guesses(batch):
    """The bench's perturbation fleet (``bench.py::_guesses``), float32 draws."""
    rng = np.random.default_rng(0)
    angles = rng.uniform(-0.05, 0.05, batch).astype(np.float32)
    shifts = rng.uniform(-0.2, 0.2, (batch, 2)).astype(np.float32)
    return angles.astype(np.float64), shifts.astype(np.float64)


def _bench_config():
    return J.DriverConfig(max_iterations=50, angle_tolerance=0.1 * np.pi / 180,
                          translation_tolerance=0.01)


def _port_inputs(scan_dir, batch, device="cpu", dtype=None):
    a = T.io.parse_lidar_scan_array(f"{scan_dir}/scan1/first.csv")
    b = T.io.parse_lidar_scan_array(f"{scan_dir}/scan1/second.csv")
    src = T.from_points(a, capacity=CAPACITY, dtype=dtype, device=device)
    tgt = T.from_points(b, capacity=CAPACITY, dtype=dtype, device=device)
    angles, shifts = _bench_guesses(batch)
    dtype = src.dtype
    guess = T.from_angle_2d(torch.tensor(angles, dtype=dtype, device=device),
                            torch.tensor(shifts, dtype=dtype, device=device))
    return T.stack([src] * batch), T.stack([tgt] * batch), guess


def test_multiscale_slice_matches_jax(scan_dir):
    a = J.io.parse_lidar_scan_array(f"{scan_dir}/scan1/first.csv")
    b = J.io.parse_lidar_scan_array(f"{scan_dir}/scan1/second.csv")
    ja = J.from_points(a, capacity=CAPACITY, dtype=np.float64)
    jb = J.from_points(b, capacity=CAPACITY, dtype=np.float64)
    lanes = lambda c: J.PointCloud(  # noqa: E731
        jnp.broadcast_to(c.points, (BATCH, *c.points.shape)), jnp.full((BATCH,), c.count)
    )
    angles, shifts = _bench_guesses(BATCH)
    guess = J.from_angle_2d(jnp.asarray(angles), jnp.asarray(shifts))
    cfg = _bench_config()
    method = J.from_method("trimmed", 2, J.Config(overlap_rate=0.9))
    run = jax.jit(lambda s, t, g: jax_converge_multiscale(
        method, s, t, g, cfg, factors=(4,), coarse_max_iterations=30))
    want, _ = run(lanes(ja), lanes(jb), guess)

    src, tgt, tguess = _port_inputs(scan_dir, BATCH)
    assert src.dtype == torch.float64 and src.points.shape == (BATCH, CAPACITY, 2)
    got, state = T.converge_multiscale(
        T.from_method("trimmed", 2, T.Config(overlap_rate=0.9)), src, tgt, tguess,
        convert.driver_config_from_fields(dataclasses.asdict(cfg)),
        factors=(4,), coarse_max_iterations=30,
    )
    np.testing.assert_array_equal(got.iteration_count.numpy(), np.asarray(want.iteration_count))
    np.testing.assert_allclose(got.transform.rotation.numpy(), np.asarray(want.transform.rotation),
                               atol=1e-9)
    np.testing.assert_allclose(got.transform.translation.numpy(),
                               np.asarray(want.transform.translation), atol=1e-9)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-9)
    assert state.source is src  # the final level runs at full resolution


@pytest.mark.parametrize("factor", [1, 3, 4])
def test_decimate_matches_jax(factor):
    pts = np.random.default_rng(1).uniform(-1, 1, (2, 64, 2))
    count = np.array([64, 9], dtype=np.int32)
    want = J.multiscale.decimate(J.PointCloud(jnp.asarray(pts), jnp.asarray(count)), factor)
    got = T.multiscale.decimate(convert.cloud_from_numpy(pts, count, device="cpu"), factor)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert got.points.is_contiguous() and got.count.dtype == torch.int32


def test_coarse_level_config_matches_jax():
    for fields in (dict(max_iterations=50, min_iterations=40, stop_cost=0.1),
                   dict(max_iterations=20, stop_cost=0.1), dict(stop_cost=0.1)):
        want = J.multiscale._capped(J.DriverConfig(**fields), 30)
        got = T.multiscale._capped(T.DriverConfig(**fields), 30)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.cuda
def test_main_path_on_card_agrees_with_cpu(cuda_device, scan_dir):
    """A small cut of the main path on the card in float32, through the
    kernel, against the CPU float64 run (the 2e-3 m gate of chip_smoke.py)."""
    cfg = T.DriverConfig(max_iterations=50, angle_tolerance=0.1 * np.pi / 180,
                         translation_tolerance=0.01)
    method = T.from_method("trimmed", 2)
    before = fused_nn.LAUNCHES
    gpu, _ = T.converge_multiscale(method, *_port_inputs(scan_dir, 8, cuda_device), cfg,
                                   factors=(4,), coarse_max_iterations=30)
    assert fused_nn.LAUNCHES > before
    assert gpu.transform.translation.dtype == torch.float32
    cpu, _ = T.converge_multiscale(method, *_port_inputs(scan_dir, 8), cfg,
                                   factors=(4,), coarse_max_iterations=30)
    dt = gpu.transform.translation.double().cpu() - cpu.transform.translation
    assert float(torch.linalg.vector_norm(dt, dim=-1).max()) <= 2e-3

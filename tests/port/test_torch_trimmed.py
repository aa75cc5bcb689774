"""The trimmed method and the driver: the port against the JAX package in
float64, and against the golden pins of ``tests/golden_local.json``.

Poses are compared at atol 1e-12 after one iterate (the sums are taken in
another order); iteration counts and match indices must be equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu_torch import convert

GOLDEN_LOCAL = os.path.join(os.path.dirname(os.path.dirname(__file__)), "golden_local.json")
BENCH = dict(max_iterations=50, angle_tolerance=0.1 * np.pi / 180, translation_tolerance=0.01)


def _pair(scan_dir, scan):
    a = J.io.parse_lidar_scan_array(f"{scan_dir}/scan{scan}/first.csv")
    b = J.io.parse_lidar_scan_array(f"{scan_dir}/scan{scan}/second.csv")
    return a, b


def _lanes(scan_dir, scan, batch, capacity, seed=0):
    """``batch`` lanes of one scan pair under seeded perturbed guesses, as
    (JAX source, target, guess) and (port source, target, guess)."""
    a, b = _pair(scan_dir, scan)
    ja = J.from_points(a, capacity=capacity, dtype=np.float64)
    jb = J.from_points(b, capacity=capacity, dtype=np.float64)
    rng = np.random.default_rng(seed)
    ang, sh = rng.uniform(-0.05, 0.05, batch), rng.uniform(-0.2, 0.2, (batch, 2))
    jax_side = (
        J.PointCloud(jnp.broadcast_to(ja.points, (batch, *ja.points.shape)),
                     jnp.full((batch,), ja.count)),
        J.PointCloud(jnp.broadcast_to(jb.points, (batch, *jb.points.shape)),
                     jnp.full((batch,), jb.count)),
        J.from_angle_2d(jnp.asarray(ang), jnp.asarray(sh)),
    )
    port_side = (
        convert.cloud_from_numpy(np.asarray(jax_side[0].points), np.asarray(jax_side[0].count),
                                 device="cpu"),
        convert.cloud_from_numpy(np.asarray(jax_side[1].points), np.asarray(jax_side[1].count),
                                 device="cpu"),
        convert.transform_from_numpy(np.asarray(jax_side[2].rotation),
                                     np.asarray(jax_side[2].translation), device="cpu"),
    )
    return jax_side, port_side


def _assert_pose(got, want, atol=1e-12):
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=atol)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=atol)


def test_init_and_one_iterate_match_jax(scan_dir):
    (js, jt, jg), (ts, tt, tg) = _lanes(scan_dir, 1, batch=3, capacity=None)
    jm, tm = J.from_method("trimmed", 2), T.from_method("trimmed", 2)
    j0, t0 = jax.jit(jm.init)(js, jt, jg), tm.init(ts, tt, tg)
    np.testing.assert_array_equal(t0.match_idx.numpy(), np.asarray(j0.match_idx))
    np.testing.assert_allclose(t0.match_cost.numpy(), np.asarray(j0.match_cost), rtol=1e-12)
    np.testing.assert_allclose(tm.cost(t0).numpy(), np.asarray(jm.cost(j0)), rtol=1e-12)
    j1, t1 = jax.jit(jm.iterate)(j0), tm.iterate(t0)
    _assert_pose(t1.transform, j1.transform)
    np.testing.assert_array_equal(t1.match_idx.numpy(), np.asarray(j1.match_idx))
    np.testing.assert_allclose(t1.match_cost.numpy(), np.asarray(j1.match_cost), rtol=1e-12)
    np.testing.assert_allclose(tm.cost(t1).numpy(), np.asarray(jm.cost(j1)), rtol=1e-12)
    assert t1.source is ts and t1.target is tt


def test_batched_converge_equals_per_lane_runs(scan_dir):
    _, (ts, tt, tg) = _lanes(scan_dir, 2, batch=4, capacity=None, seed=3)
    method, cfg = T.from_method("trimmed", 2), T.DriverConfig(**BENCH)
    batched, _ = T.converge(method, ts, tt, tg, cfg)
    assert len(set(batched.iteration_count.tolist())) > 1  # lanes stop at different times
    for lane in range(4):
        pick = lambda x: x[lane : lane + 1]  # noqa: E731
        one, _ = T.converge(
            method,
            T.PointCloud(pick(ts.points), pick(ts.count)),
            T.PointCloud(pick(tt.points), pick(tt.count)),
            T.RigidTransform(pick(tg.rotation), pick(tg.translation)),
            cfg,
        )
        assert int(one.iteration_count) == int(batched.iteration_count[lane])
        np.testing.assert_allclose(one.transform.translation[0].numpy(),
                                   batched.transform.translation[lane].numpy(), atol=1e-12)


@pytest.mark.parametrize("scan", [1, 2, 3])
def test_golden_local_trimmed(scan_dir, scan):
    """The pins of ``tests/test_golden.py::test_bench_config_golden_local``."""
    with open(GOLDEN_LOCAL) as f:
        golden = json.load(f)[f"trimmed/scan{scan}"]
    a, b = _pair(scan_dir, scan)
    result, state = T.converge(
        T.from_method("trimmed", 2), T.from_points(a, device="cpu"),
        T.from_points(b, device="cpu"), T.identity(2, device="cpu"),
        T.DriverConfig(**BENCH),
    )
    assert int(result.iteration_count) == golden["iterations"]
    np.testing.assert_allclose(float(result.cost), golden["cost"], rtol=1e-12)
    np.testing.assert_allclose(result.transform.rotation.numpy(), golden["rotation"], atol=1e-12)
    np.testing.assert_allclose(
        result.transform.translation.numpy(), golden["translation"], atol=1e-10
    )
    matches = T.get_matches(state)
    assert matches.target_idx is state.match_idx and int(matches.valid.sum()) == len(a)


CRITERIA = {
    "max_iterations=0": dict(max_iterations=0),
    "min and absolute cost": dict(min_iterations=4, max_iterations=9, absolute_cost_tolerance=1e-3),
    "relative cost": dict(max_iterations=20, relative_cost_tolerance=1e-2),
    "stop cost": dict(max_iterations=30, stop_cost=0.05),
}


@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_converge_criteria_match_jax(scan_dir, name):
    (js, jt, jg), (ts, tt, tg) = _lanes(scan_dir, 3, batch=3, capacity=None, seed=4)
    js, jt = J.multiscale.decimate(js, 4), J.multiscale.decimate(jt, 4)
    ts, tt = T.multiscale.decimate(ts, 4), T.multiscale.decimate(tt, 4)
    jcfg = J.DriverConfig(**CRITERIA[name])
    want, _ = J.make_converge_fn(J.from_method("trimmed", 2), jcfg)(js, jt, jg)
    tcfg = convert.driver_config_from_fields(dataclasses.asdict(jcfg))
    got, _ = T.converge(T.from_method("trimmed", 2), ts, tt, tg, tcfg)
    np.testing.assert_array_equal(got.iteration_count.numpy(), np.asarray(want.iteration_count))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-9)
    _assert_pose(got.transform, want.transform, atol=1e-9)
    if name == "max_iterations=0":
        assert not got.iteration_count.any()
        assert torch.equal(got.transform.translation, tg.translation)


def test_driver_config_validation():
    with pytest.raises(ValueError):
        T.DriverConfig(angle_tolerance=0.1)
    with pytest.raises(ValueError):
        T.DriverConfig(min_iterations=5, max_iterations=2)
    cloud = T.from_points(np.ones((8, 2)), device="cpu")
    ident2, ident3 = T.identity(2, device="cpu"), T.identity(3, device="cpu")
    method = T.from_method("trimmed", 2)
    with pytest.raises(ValueError, match="no termination criterion"):
        T.converge(method, cloud, cloud, ident2, T.DriverConfig(min_iterations=1))
    with pytest.raises(ValueError, match="time_limit"):
        T.converge(method, cloud, cloud, ident2, T.DriverConfig(time_limit=1.0))
    with pytest.raises(ValueError, match="dimension mismatch"):
        T.converge(method, cloud, cloud, ident3, T.DriverConfig(max_iterations=1))


def test_registry():
    """The five reference methods (``icp.cpp:16-27``) and the net-new
    families, as the JAX package registers them."""
    assert T.registered_methods(2) == ["feature_aware", "gicp", "ndt", "point_to_plane", "robust",
                                       "symmetric", "trimmed", "vanilla"]
    assert T.registered_methods(3) == ["gicp", "ndt", "point_to_plane", "robust", "symmetric",
                                       "trimmed", "vanilla"]
    for dim in (2, 3):
        assert T.registered_methods(dim) == J.registered_methods(dim)
    assert T.is_method_registered("trimmed", 2) and not T.is_method_registered("feature_aware", 3)
    with pytest.raises(KeyError, match="registered: \\['gicp', 'ndt', "):
        T.from_method("feature_aware", 3)
    method = T.from_method("trimmed", 2, T.Config(overlap_rate=0.5))
    assert method.name == "trimmed" and method.dim == 2
    assert T.get_matches(object()) is None

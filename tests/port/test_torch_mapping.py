"""``icp_tpu_torch.mapping`` against the JAX package, float64 on the CPU.

* ``voxel_downsample`` (host numpy) equal to JAX's;
* ``voxel_downsample_device``: cell order and count exact, centroids to
  1e-12, padding zeroed, capacity truncation, far cells clamped;
* ``merge_map_device``: equal to JAX's as sets of points (the overflow trim
  orders cells by distance; ties may order differently), and to the host
  ``LocalMap``;
* ``scan_to_map_odometry`` on 10 sweeps of ``ex_data/seq1`` (6 for gicp and
  point_to_plane): poses to 1e-9, keyframe flags and iteration counts
  exact, with the host map, with ``device_map=True``, and through the
  map-aux reuse (gicp; point_to_plane, whose source data is not derived;
  NDT p2d).

The ``cuda``-marked twins run the device filter and scan-to-map on the card
in float32 against the CPU float64 run (cell counts equal; poses within
2e-3 m).
"""

import glob
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu import mapping as jmap
from icp_tpu_torch import convert, mapping
from icp_tpu_torch.utils.metrics import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = dict(max_iterations=50, angle_tolerance=0.1 * np.pi / 180, translation_tolerance=0.01)


def _masked(rng, n, dim, valid, spread=3.0):
    pts = np.zeros((n, dim))
    pts[:valid] = rng.uniform(-spread, spread, (valid, dim))
    return pts, np.arange(n) < valid


def _canon(a):
    return a[np.lexsort(a.T[::-1])]


def test_voxel_downsample_host_matches_jax():
    rng = np.random.default_rng(1)
    for dim in (2, 3):
        pts = rng.uniform(-4, 4, (300, dim))
        np.testing.assert_array_equal(mapping.voxel_downsample(pts, 0.5),
                                      jmap.voxel_downsample(pts, 0.5))
    assert mapping.voxel_downsample(np.zeros((0, 3)), 0.5).shape == (0, 3)


@pytest.mark.parametrize("dim, capacity", [(2, 256), (3, 256), (2, 16), (3, 400)])
def test_voxel_downsample_device_matches_jax(dim, capacity):
    rng = np.random.default_rng(dim + capacity)
    pts, mask = _masked(rng, 256, dim, 201)
    mask = mask & (rng.uniform(size=256) > 0.1)
    # Two cells beyond the cell bound, clamped into one boundary cell.
    pts[3], pts[4], mask[3], mask[4] = 5e4, 6e4, True, True
    got, count = mapping.voxel_downsample_device(torch.tensor(pts), torch.tensor(mask), 0.5,
                                                 capacity)
    want, jcount = jax.jit(jmap.voxel_downsample_device, static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.asarray(mask), 0.5, capacity)
    assert count.dtype == torch.int32 and int(count) == int(jcount)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert not got[int(count):].any()
    if capacity >= 256:  # no truncation: the host filter's cells, in its order
        host = mapping.voxel_downsample(pts[mask], 0.5)
        assert int(count) == len(host) - 1  # the far points merged into one cell
    else:
        assert int(count) == capacity


@pytest.mark.parametrize("capacity", [512, 64])
def test_merge_map_device_matches_jax_as_sets(capacity):
    """Without overflow (512) and with it (64, the cells nearest the scan)."""
    rng = np.random.default_rng(capacity)
    map_pts, scan_pts = rng.uniform(-5, 5, (300, 2)), rng.uniform(-2, 2, (200, 2))
    base = mapping.LocalMap(0.3, capacity, np.zeros((0, 2))).merged_with(map_pts)
    host = base.merged_with(scan_pts)
    base_pts = np.zeros((capacity, 2))
    base_pts[: len(base.points)] = base.points
    center = scan_pts.mean(axis=0)
    got, count = mapping.merge_map_device(
        torch.tensor(base_pts), torch.tensor(len(base.points), dtype=torch.int32),
        torch.tensor(scan_pts), torch.ones(200, dtype=torch.bool), 0.3, capacity,
        torch.tensor(center))
    want, jcount = jax.jit(jmap.merge_map_device, static_argnums=(4, 5))(
        jnp.asarray(base_pts), jnp.int32(len(base.points)), jnp.asarray(scan_pts),
        jnp.ones(200, bool), 0.3, capacity, jnp.asarray(center))
    k = int(count)
    assert k == int(jcount) == len(host.points)
    np.testing.assert_allclose(_canon(got.numpy()[:k]), _canon(np.asarray(want)[:k]), atol=1e-12)
    np.testing.assert_allclose(_canon(got.numpy()[:k]), _canon(host.points), atol=1e-9)
    d = np.linalg.norm(got.numpy()[:k] - center, axis=1)
    assert (np.diff(d) >= 0).all()  # ordered by distance to the center
    assert not got[k:].any()


@pytest.fixture(scope="module")
def sweeps():
    """Ten seq1 sweeps as (points, counts) at one capacity."""
    paths = sorted(glob.glob(os.path.join(REPO, "ex_data", "seq1", "sweep_*.conf")))[:10]
    arrays = [T.io.sweep_to_points(T.io.parse_sweep_conf(p)) for p in paths]
    pts = np.zeros((len(arrays), 544, 2))
    for i, a in enumerate(arrays):
        pts[i, : len(a)] = a
    return pts, np.array([len(a) for a in arrays], dtype=np.int32)


def _run_both(sweeps, name, config, n, **kw):
    pts, counts = sweeps[0][:n], sweeps[1][:n]
    clouds = [convert.cloud_from_numpy(p, c, device="cpu") for p, c in zip(pts, counts)]
    jclouds = [J.cloud.PointCloud(jnp.asarray(p), jnp.asarray(c)) for p, c in zip(pts, counts)]
    sink = io.StringIO()
    with MetricsLogger(sink) as log:
        got = list(mapping.scan_to_map_odometry(
            clouds, T.from_method(name, 2, T.Config(**config)), T.DriverConfig(**BENCH),
            voxel_size=0.1, map_capacity=2048, metrics=log, **kw))
    want = list(jmap.scan_to_map_odometry(
        jclouds, J.from_method(name, 2, J.Config(**config)), J.DriverConfig(**BENCH),
        voxel_size=0.1, map_capacity=2048, **kw))
    return got, want, [json.loads(line) for line in sink.getvalue().splitlines()]


@pytest.mark.parametrize("name, config, device_map, n", [
    ("robust", {}, False, 10), ("robust", {}, True, 10), ("gicp", {}, False, 6),
    ("point_to_plane", {}, True, 6), ("ndt", {"cell_size": 0.5, "cells": 1024}, False, 10)])
def test_scan_to_map_matches_jax(sweeps, name, config, device_map, n):
    got, want, records = _run_both(sweeps, name, config, n, device_map=device_map)
    flags = [bool(f) for _, f, _ in got]
    assert flags == [bool(f) for _, f, _ in want] and flags[0] and not all(flags)
    assert got[0][2] is None
    for (p, _, r), (jp, _, jr) in zip(got[1:], want[1:]):
        np.testing.assert_allclose(p.translation.numpy(), np.asarray(jp.translation), atol=1e-9)
        np.testing.assert_allclose(p.rotation.numpy(), np.asarray(jp.rotation), atol=1e-9)
        assert int(r.iteration_count) == int(jr.iteration_count)
    assert [r["keyframe"] for r in records] == flags[1:]
    assert all(0 < r["map_points"] <= 2048 for r in records)


def test_scan_to_map_first_scan_over_capacity(sweeps):
    """The first map respects ``map_capacity`` on both paths."""
    pts, counts = sweeps
    clouds = [convert.cloud_from_numpy(p, c, device="cpu") for p, c in zip(pts[:3], counts[:3])]
    for device_map in (False, True):
        out = list(mapping.scan_to_map_odometry(
            clouds, T.from_method("robust", 2), T.DriverConfig(**BENCH), voxel_size=0.01,
            map_capacity=128, device_map=device_map))
        assert len(out) == 3 and all(torch.isfinite(p.translation).all() for p, _, _ in out)


# --- on the card -----------------------------------------------------------


@pytest.mark.cuda
def test_voxel_filter_on_card(cuda_device):
    rng = np.random.default_rng(9)
    pts, mask = _masked(rng, 4096, 3, 4000, spread=10.0)
    gpu, count = mapping.voxel_downsample_device(
        torch.tensor(pts, dtype=torch.float32, device=cuda_device),
        torch.tensor(mask, device=cuda_device), 0.5, 4096)
    cpu, ccount = mapping.voxel_downsample_device(torch.tensor(pts), torch.tensor(mask), 0.5,
                                                  4096)
    assert int(count) == int(ccount)
    k = int(count)
    np.testing.assert_allclose(gpu[:k].double().cpu().numpy(), cpu[:k].numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("device_map", [False, True])
def test_scan_to_map_on_card_agrees_with_cpu(cuda_device, sweeps, device_map):
    pts, counts = sweeps
    # Converged tightly: at the bench's 1 cm tolerance, float32 stops robust
    # at another iterate than float64 (6 mm apart by the tenth sweep).
    method = T.from_method("robust", 2)
    cfg = T.DriverConfig(max_iterations=150, angle_tolerance=1e-6, translation_tolerance=1e-6)
    runs = {}
    for dev, dtype in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        clouds = [convert.cloud_from_numpy(p, c, device=dev, dtype=dtype)
                  for p, c in zip(pts, counts)]
        runs[str(dev)] = list(mapping.scan_to_map_odometry(
            clouds, method, cfg, voxel_size=0.1, map_capacity=2048, device_map=device_map))
    gpu, cpu = runs[str(cuda_device)], runs["cpu"]
    assert [f for _, f, _ in gpu] == [f for _, f, _ in cpu]
    for (p, _, _), (q, _, _) in zip(gpu, cpu):
        assert float(torch.linalg.vector_norm(p.translation.double().cpu()
                                              - q.translation)) <= 2e-3

"""The readers: the port's own PLY, sweep (.conf) and scan CSV parsers
against the JAX package's on the in-repo example data.  Parsing is numpy in
both, so results must be equal."""

import glob
import os

import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T

PLY_FILES = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "ex_data", "ply", "*.ply")))


@pytest.mark.parametrize("path", PLY_FILES, ids=os.path.basename)
def test_read_ply_matches_jax(path):
    got = T.read_ply(path)
    assert got.dtype == np.float64 and got.shape[1] == 3
    np.testing.assert_array_equal(got, J.io.read_ply(path))


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_write_ply_round_trip(tmp_path, binary):
    pts = np.random.default_rng(2).uniform(-5, 5, (37, 3))
    path = str(tmp_path / "cloud.ply")
    T.write_ply(path, pts, binary=binary)
    got = T.read_ply(path)
    want = pts.astype(np.float32).astype(np.float64)
    if binary:
        np.testing.assert_array_equal(got, want)
    else:  # "%g" keeps 6 significant digits
        np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got, J.io.read_ply(path))
    jpath = str(tmp_path / "jax.ply")
    J.io.write_ply(jpath, pts, binary=binary)
    np.testing.assert_array_equal(T.read_ply(jpath), got)


def test_read_ply_rejects_bad_input(tmp_path):
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply\n")
    with pytest.raises(ValueError, match="not a PLY"):
        T.read_ply(str(bad))
    big = tmp_path / "big.ply"
    big.write_bytes(b"ply\nformat binary_big_endian 1.0\nelement vertex 0\nend_header\n")
    with pytest.raises(ValueError, match="unsupported PLY format"):
        T.read_ply(str(big))


def test_parse_sweep_matches_jax(scan_dir):
    path = os.path.join(scan_dir, "seq1", "sweep_000.conf")
    sweep, want_sweep = T.io.parse_sweep_conf(path), J.io.parse_sweep_conf(path)
    assert sweep.keys() == want_sweep.keys()
    np.testing.assert_array_equal(sweep["ranges"], want_sweep["ranges"])
    np.testing.assert_array_equal(T.io.sweep_to_points(sweep), J.io.sweep_to_points(want_sweep))
    for capacity in (None, "bucket"):
        want = J.io.parse_sweep(path, capacity=capacity)  # float32, as its default
        got = T.io.parse_sweep(path, capacity=capacity, dtype=torch.float32, device="cpu")
        np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
        assert int(got.count) == int(want.count)
    assert T.io.parse_sweep(path, device="cpu").dtype == torch.float64


@pytest.mark.parametrize("capacity", [None, "bucket", 1024])
def test_parse_lidar_scan_batch_matches_jax(scan_dir, capacity):
    """Scans 1-3; at capacity 1024 scans 1 and 3 only, since the in-repo
    scan2 has 1,090 points (both packages refuse it there)."""
    scans = (1, 3) if capacity == 1024 else (1, 2, 3)
    paths = [f"{scan_dir}/scan{i}/{f}.csv" for i in scans for f in ("first", "second")]
    want = J.io.parse_lidar_scan_batch(paths, capacity=capacity, dtype=np.float64)
    got = T.io.parse_lidar_scan_batch(paths, capacity=capacity, device="cpu")
    assert got.points.dtype == torch.float64 and got.count.dtype == torch.int32
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    want32 = J.io.parse_lidar_scan_batch(paths, capacity=capacity)
    got32 = T.io.parse_lidar_scan_batch(paths, capacity=capacity, dtype=torch.float32,
                                        device="cpu")
    np.testing.assert_array_equal(got32.points.numpy(), np.asarray(want32.points))


def test_parse_lidar_scan_batch_rejects(scan_dir):
    with pytest.raises(ValueError, match="empty path list"):
        T.io.parse_lidar_scan_batch([], device="cpu")
    for capacity in (8, 1024):
        with pytest.raises(ValueError, match="1090 points exceed capacity"):
            T.io.parse_lidar_scan_batch([f"{scan_dir}/scan2/first.csv"], capacity=capacity,
                                        device="cpu")


def test_parse_lidar_scan_matches_jax(scan_dir):
    path = f"{scan_dir}/scan3/first.csv"
    want = J.parse_lidar_scan(path, capacity="bucket", dtype=np.float64)
    got = T.parse_lidar_scan(path, capacity="bucket", device="cpu")
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    assert int(got.count) == int(want.count)

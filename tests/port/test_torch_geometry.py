"""Geometry, clouds, config, the CSV parser and ``convert``: the port against
the JAX package on the same numpy inputs (float64, atol 1e-12 where sums are
taken in another order, exact where nothing is summed).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu.io.scan_csv import parse_lidar_scan_array as jax_parse
from icp_tpu_torch import convert

ATOL = 1e-12


def _transforms(dim, batch=(4,), seed=0):
    """A batch of random rigid transforms as (rotation, translation) arrays."""
    rng = np.random.default_rng(seed)
    if dim == 2:
        a = rng.uniform(-np.pi, np.pi, batch)
        c, s = np.cos(a), np.sin(a)
        rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    else:
        q, r = np.linalg.qr(rng.normal(size=(*batch, 3, 3)))
        rot = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
        rot[np.linalg.det(rot) < 0] *= -1
    return rot, rng.uniform(-3, 3, (*batch, dim))


def _both(rot, trans):
    return (
        J.RigidTransform(jnp.asarray(rot), jnp.asarray(trans)),
        convert.transform_from_numpy(rot, trans, device="cpu"),
    )


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


@pytest.mark.parametrize("dim", [2, 3])
def test_compose_apply_inverse_match_jax(dim):
    ja, ta = _both(*_transforms(dim, seed=1))
    jb, tb = _both(*_transforms(dim, seed=2))
    pts = np.random.default_rng(3).uniform(-5, 5, (4, 30, dim))
    jc, tc = J.compose(ja, jb), T.compose(ta, tb)
    _close(tc.rotation, jc.rotation)
    _close(tc.translation, jc.translation)
    mc = ta @ tb
    assert torch.equal(mc.rotation, tc.rotation) and torch.equal(mc.translation, tc.translation)
    _close(T.apply(ta, torch.from_numpy(pts)), J.apply(ja, jnp.asarray(pts)))
    ji, ti = J.inverse(ja), T.inverse(ta)
    _close(ti.rotation, ji.rotation)
    _close(ti.translation, ji.translation)
    roundtrip = T.compose(ti, ta)
    _close(roundtrip.rotation, np.broadcast_to(np.eye(dim), (4, dim, dim)))
    _close(roundtrip.translation, np.zeros((4, dim)))


@pytest.mark.parametrize("dim", [2, 3])
def test_rotation_angle_matches_jax(dim):
    rot, _ = _transforms(dim, batch=(9,), seed=4)
    near = np.broadcast_to(np.eye(dim), (1, dim, dim)).copy()  # tiny-angle branch
    rot = np.concatenate([rot, near])
    want = J.geometry.rotation_angle(jnp.asarray(rot))
    _close(T.geometry.rotation_angle(torch.from_numpy(rot)), want)
    with pytest.raises(ValueError):
        T.geometry.rotation_angle(torch.eye(4)[None])


def test_from_angle_2d_and_identity_match_jax():
    rng = np.random.default_rng(5)
    ang, sh = rng.uniform(-1, 1, 6), rng.uniform(-1, 1, (6, 2))
    jt = J.from_angle_2d(jnp.asarray(ang), jnp.asarray(sh))
    tt = T.from_angle_2d(torch.from_numpy(ang), torch.from_numpy(sh))
    np.testing.assert_array_equal(tt.rotation.numpy(), np.asarray(jt.rotation))  # no sums
    np.testing.assert_array_equal(tt.translation.numpy(), np.asarray(jt.translation))
    zero = T.from_angle_2d(0.25, device="cpu")
    assert zero.translation.shape == (2,) and zero.dtype == torch.float64
    ident = T.identity(3, (2, 5), device="cpu")
    assert ident.rotation.shape == (2, 5, 3, 3) and ident.dtype == torch.float64
    want = J.identity(3, (2, 5)).rotation
    np.testing.assert_array_equal(ident.rotation.numpy(), np.asarray(want))
    assert T.identity(2, dtype=torch.float32, device="cpu").dtype == torch.float32


def test_centroids_match_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-5, 5, (3, 20, 2))
    mask = rng.uniform(size=(3, 20)) > 0.4
    mask[2] = False  # empty lane: the origin
    w = rng.uniform(0, 1, (3, 20))
    w[1] = 0.0
    tp = torch.from_numpy(pts)
    _close(T.geometry.masked_centroid(tp, torch.from_numpy(mask)),
           J.geometry.masked_centroid(jnp.asarray(pts), jnp.asarray(mask)))
    _close(T.geometry.masked_centroid(tp), J.geometry.masked_centroid(jnp.asarray(pts)))
    _close(T.geometry.weighted_centroid(tp, torch.from_numpy(w)),
           J.geometry.weighted_centroid(jnp.asarray(pts), jnp.asarray(w)))


@pytest.mark.parametrize("capacity", [None, "bucket", 1024])
def test_from_points_drops_nonfinite_rows_like_jax(capacity):
    pts = np.random.default_rng(7).uniform(-5, 5, (37, 2))
    pts[[3, 10, 20]] = [[np.inf, 1.0], [2.0, -np.inf], [np.nan, 0.0]]
    jc = J.from_points(pts, capacity=capacity, dtype=np.float64)
    tc = T.from_points(pts, capacity=capacity, device="cpu")
    assert tc.capacity == jc.capacity and tc.dtype == torch.float64
    assert int(tc.count) == int(jc.count) == 34 and tc.count.dtype == torch.int32
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(T.to_numpy(tc), J.to_numpy(jc))


def test_cloud_helpers_match_jax():
    assert [T.bucket_capacity(n) for n in (0, 64, 65, 953)] == [
        J.bucket_capacity(n) for n in (0, 64, 65, 953)
    ]
    assert T.cloud.round_up(13, 8) == J.cloud.round_up(13, 8) == 16
    a = T.from_points(np.ones((5, 2)), device="cpu")
    b = T.from_points(np.ones((20, 2)), device="cpu")
    st = T.stack([a, b])
    assert st.points.shape == (2, 24, 2) and st.count.tolist() == [5, 20]
    assert st.batch_shape == (2,) and st.dim == 2
    assert T.pad_to(a, 8) is a
    with pytest.raises(ValueError):
        T.pad_to(b, 8)
    with pytest.raises(ValueError):
        T.from_points(np.ones((9, 2)), capacity=8, device="cpu")
    with pytest.raises(ValueError):
        T.from_points(np.ones((2, 9, 2)), device="cpu")
    with pytest.raises(ValueError):
        T.to_numpy(st)


def test_convert_round_trips():
    rng = np.random.default_rng(8)
    pts, count = rng.uniform(-1, 1, (3, 16, 2)), np.array([16, 3, 0], dtype=np.int32)
    jc = J.PointCloud(jnp.asarray(pts), jnp.asarray(count))
    tc = convert.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.count), device="cpu")
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    back_pts, back_count = convert.cloud_to_numpy(tc)
    np.testing.assert_array_equal(back_pts, pts)
    np.testing.assert_array_equal(back_count, count)
    rot, trans = _transforms(2, seed=9)
    r, t = convert.transform_to_numpy(convert.transform_from_numpy(rot, trans, device="cpu"))
    np.testing.assert_array_equal(r, rot)
    np.testing.assert_array_equal(t, trans)
    f32 = convert.transform_from_numpy(rot, trans, dtype=torch.float32, device="cpu")
    assert f32.dtype == torch.float32 and f32.translation.dtype == torch.float32
    jcfg = J.DriverConfig(max_iterations=50, angle_tolerance=0.1, translation_tolerance=0.01)
    tcfg = convert.driver_config_from_fields(dataclasses.asdict(jcfg))
    assert convert.driver_config_to_fields(tcfg) == dataclasses.asdict(jcfg)
    with pytest.raises(TypeError):
        convert.driver_config_from_fields({"max_iters": 3})


def test_config_semantics_match_jax():
    jc, tc = J.Config(overlap_rate=0.5, name="x"), T.Config(overlap_rate=0.5, name="x")
    assert tc.get("overlap_rate", 0.9) == jc.get("overlap_rate", 0.9) == 0.5
    assert tc.get("missing", 3) == 3 and tc.set("k", 2).get("k", 1.0) == 2.0
    assert tc == T.Config({"overlap_rate": 0.5, "name": "x"}) and hash(tc) == hash(jc)
    assert "name" in tc and sorted(tc.keys()) == ["name", "overlap_rate"]
    assert repr(tc) == repr(jc)
    with pytest.raises(TypeError):
        tc.get("name", 1)


def test_parse_lidar_scan_matches_jax(tmp_path, scan_dir):
    for scan in (1, 2, 3):
        for part in ("first", "second"):
            path = f"{scan_dir}/scan{scan}/{part}.csv"
            np.testing.assert_array_equal(T.io.parse_lidar_scan_array(path), jax_parse(path))
    mixed = tmp_path / "mixed.csv"
    mixed.write_text("1.0 2.0\n3.0,4.0,9.9\nnan,1.0\ninf,2.0\n\n5.5,-6.25\nx,1\n-inf,0\n7,8\n")
    got = T.io.parse_lidar_scan_array(str(mixed))
    np.testing.assert_array_equal(got, jax_parse(str(mixed)))
    np.testing.assert_array_equal(got, [[5.5, -6.25], [7.0, 8.0]])
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    assert T.io.parse_lidar_scan_array(str(empty)).shape == (0, 2)


def _default_device_calls():
    """The entry points that make tensors, called with no ``device``."""
    rot, trans = _transforms(2, seed=10)
    return {
        "from_points": lambda: T.from_points(np.ones((5, 2))),
        "identity": lambda: T.identity(2, (3,)),
        "from_angle_2d": lambda: T.from_angle_2d(0.1),
        "cloud_from_numpy": lambda: convert.cloud_from_numpy(np.ones((2, 8, 2)), [8, 3]),
        "transform_from_numpy": lambda: convert.transform_from_numpy(rot, trans),
    }


@pytest.mark.parametrize("name", sorted(_default_device_calls()))
def test_entry_points_raise_without_a_card(name):
    """No CPU fallback: with no card, the card default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present (test_entry_points_default_to_the_card covers it)")
    with pytest.raises((AssertionError, RuntimeError)):
        _default_device_calls()[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_default_device_calls()))
def test_entry_points_default_to_the_card(cuda_device, name):
    out = _default_device_calls()[name]()
    tensors = [getattr(out, f.name) for f in dataclasses.fields(out)]
    assert all(t.device == cuda_device for t in tensors)
    floats = [t for t in tensors if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)

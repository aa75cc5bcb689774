"""Weighted rigid fits: the port against the JAX package in float64, at atol
1e-12 (the sums are taken in another order, so equality is not expected).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.ops import rigid_fit as jrf
from icp_tpu_torch.ops import rigid_fit as trf

ATOL = 1e-12


def _rotation(rng, dim):
    if dim == 2:
        a = rng.uniform(-np.pi, np.pi)
        return np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def _problem(dim, weights, seed=0, batch=3, n=40):
    """Batched source/target with a known rigid motion plus noise."""
    rng = np.random.default_rng(seed + dim)
    src = rng.uniform(-5, 5, (batch, n, dim))
    rot = np.stack([_rotation(rng, dim) for _ in range(batch)])
    tgt = src @ rot.transpose(0, 2, 1) + rng.uniform(-1, 1, (batch, 1, dim))
    tgt += rng.normal(scale=0.01, size=tgt.shape)
    if weights == "binary":
        w = (rng.uniform(size=(batch, n)) > 0.3).astype(np.float64)
    elif weights == "real":
        w = rng.uniform(0, 2, (batch, n))
    else:
        w = np.zeros((batch, n))
    return src, tgt, w


def _assert_transform(got, want):
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=ATOL)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=ATOL)


@pytest.mark.parametrize("weights", ["binary", "real", "zero"])
@pytest.mark.parametrize("dim", [2, 3])
def test_fit_rigid_matches_jax(dim, weights):
    src, tgt, w = _problem(dim, weights)
    want = jrf.fit_rigid(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    got = trf.fit_rigid(*(torch.from_numpy(x) for x in (src, tgt, w)))
    _assert_transform(got, want)
    if weights == "zero":  # degenerate weights give the identity step
        eye = np.broadcast_to(np.eye(dim), (3, dim, dim))
        np.testing.assert_array_equal(got.rotation.numpy(), eye)


@pytest.mark.parametrize("dim", [2, 3])
def test_fit_rigid_indexed_matches_jax_take(dim):
    src, tgt, w = _problem(dim, "binary", seed=5)
    rng = np.random.default_rng(9)
    idx = rng.integers(0, tgt.shape[1], src.shape[:2]).astype(np.int32)
    want = jrf.fit_rigid_indexed(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(idx),
                                 jnp.asarray(w), gather="take")
    got = trf.fit_rigid_indexed(*(torch.from_numpy(x) for x in (src, tgt, idx, w)))
    _assert_transform(got, want)
    # the gather is exact: the same as fitting the gathered points
    matched = np.take_along_axis(tgt, idx[..., None].astype(np.int64), axis=1)
    direct = trf.fit_rigid(*(torch.from_numpy(x) for x in (src, matched, w)))
    assert torch.equal(got.rotation, direct.rotation)
    assert torch.equal(got.translation, direct.translation)


@pytest.mark.parametrize("dim", [2, 3])
def test_cross_covariance_matches_jax(dim):
    src, tgt, w = _problem(dim, "real", seed=2)
    h_j, ca_j, cb_j = jrf.cross_covariance(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    h, ca, cb = trf.cross_covariance(*(torch.from_numpy(x) for x in (src, tgt, w)))
    for got, want in ((h, h_j), (ca, ca_j), (cb, cb_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_rotation_2d_zero_covariance_is_identity():
    got = trf.rotation_from_covariance_2d(torch.zeros(2, 2, 2, dtype=torch.float64))
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.eye(2), (2, 2, 2)))


def test_rotation_3d_svd_fixes_reflection():
    rng = np.random.default_rng(3)
    h = rng.normal(size=(6, 3, 3))
    h[:3] = -h[:3]  # mixed determinant signs
    want = np.asarray(jrf.rotation_from_covariance_3d_svd(jnp.asarray(h)))
    got = trf.rotation_from_covariance_3d_svd(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-12)


def test_rotation_from_h_rejects_other_dimensions():
    with pytest.raises(ValueError):
        trf._rotation_from_h(torch.eye(4, dtype=torch.float64)[None])


def _covariances(kind, dtype):
    """Batched 3x3 cross-covariances: seeded random, rank-deficient (from
    planar points) and zero."""
    rng = np.random.default_rng({"random": 11, "planar": 12, "zero": 13}[kind])
    if kind == "random":
        h = rng.normal(size=(6, 3, 3))
    elif kind == "planar":
        a = rng.uniform(-5, 5, (6, 50, 3))
        a[..., 2] = 0.0  # every source point in the z = 0 plane
        rot = np.stack([_rotation(rng, 3) for _ in range(6)])
        b = a @ rot.transpose(0, 2, 1)
        a_c = a - a.mean(1, keepdims=True)
        b_c = b - b.mean(1, keepdims=True)
        h = a_c.transpose(0, 2, 1) @ b_c
        assert np.allclose(np.linalg.matrix_rank(h), 2)
    else:
        h = np.zeros((3, 3, 3))
    return h.astype(dtype)


QUAT_CASES = [(kind, dtype) for kind in ("random", "planar", "zero")
              for dtype in (np.float64, np.float32)]


@pytest.mark.parametrize("kind,dtype", QUAT_CASES, ids=lambda x: getattr(x, "__name__", x))
def test_jacobi_eigh_matches_jax(kind, dtype):
    """The 4x4 ``K`` matrices of Horn's method through both Jacobi solvers:
    eigenvalues always; eigenvectors (up to sign) where the eigenvalues are
    distinct, since one ulp of atan2/cos between XLA and torch may turn a
    degenerate eigenspace."""
    atol = 1e-12 if dtype == np.float64 else 1e-5
    h = _covariances(kind, dtype)
    k = _horn_k(h)
    want_vals, want_vecs = (np.asarray(x) for x in jrf._jacobi_eigh_sym(jnp.asarray(k)))
    got_vals, got_vecs = trf._jacobi_eigh_sym(torch.from_numpy(k))
    assert got_vals.dtype == torch.from_numpy(k).dtype
    scale = max(1.0, float(np.abs(want_vals).max()))
    np.testing.assert_allclose(got_vals.numpy(), want_vals, atol=atol * scale)
    for lane in range(len(k)):
        vals = np.sort(want_vals[lane])
        if np.min(np.diff(vals)) < 1e-3 * scale:
            continue
        dots = np.abs(np.sum(got_vecs.numpy()[lane] * want_vecs[lane], axis=0))
        np.testing.assert_allclose(dots, 1.0, atol=atol * 10)


def _horn_k(h):
    """Horn's symmetric 4x4 ``K`` of each 3x3 ``H``."""
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = (h[..., i, :].T for i in range(3))
    k = np.array([
        [xx + yy + zz, yz - zy, zx - xz, xy - yx],
        [yz - zy, xx - yy - zz, xy + yx, zx + xz],
        [zx - xz, xy + yx, yy - xx - zz, yz + zy],
        [xy - yx, zx + xz, yz + zy, zz - xx - yy],
    ])
    return np.ascontiguousarray(np.moveaxis(k, -1, 0))


@pytest.mark.parametrize("kind,dtype", QUAT_CASES, ids=lambda x: getattr(x, "__name__", x))
def test_quaternion_rotation_matches_jax(kind, dtype):
    atol = 1e-12 if dtype == np.float64 else 1e-5
    h = _covariances(kind, dtype)
    want = np.asarray(jrf.rotation_from_covariance_3d_quat(jnp.asarray(h)))
    got = trf.rotation_from_covariance_3d_quat(torch.from_numpy(h))
    assert got.dtype == torch.from_numpy(h).dtype
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    np.testing.assert_allclose(np.linalg.det(got.numpy().astype(np.float64)), 1.0, atol=atol * 10)
    if kind == "zero":
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.eye(3), h.shape))
    if kind == "random":  # a unique optimum: quat and svd agree
        svd = trf.rotation_from_covariance_3d_svd(torch.from_numpy(h.astype(np.float64)))
        np.testing.assert_allclose(got.numpy(), svd.numpy(), atol=atol * 10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("solver", ["svd", "quat", "auto"])
def test_solver_choice_matches_jax(solver, dtype):
    """``fit_rigid(..., solver)`` takes the JAX package's path: ``auto`` is
    svd in float64 and quat in float32."""
    src, tgt, w = _problem(3, "binary", seed=7)
    src, tgt, w = (x.astype(dtype) for x in (src, tgt, w))
    want = jrf.fit_rigid(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w), solver=solver)
    got = trf.fit_rigid(*(torch.from_numpy(x) for x in (src, tgt, w)), solver=solver)
    atol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=atol)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation),
                               atol=atol * 10)
    h = trf.cross_covariance(*(torch.from_numpy(x) for x in (src, tgt, w)))[0]
    expect = {"svd": "svd", "quat": "quat",
              "auto": "svd" if dtype == np.float64 else "quat"}[solver]
    direct = getattr(trf, f"rotation_from_covariance_3d_{expect}")(h)
    assert torch.equal(trf._rotation_from_h(h, solver), direct)


def test_unknown_solver_raises():
    with pytest.raises(ValueError, match="unknown solver"):
        trf._rotation_from_h(torch.zeros(1, 3, 3), "eig")

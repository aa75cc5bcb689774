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

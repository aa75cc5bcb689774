"""``icp_tpu_torch.ops.covariance`` against ``icp_tpu.ops.covariance`` in
float64 on the CPU: information matrices at rtol 1e-9, the whitener at
rtol 1e-9, and NaN where the regularized matrix is not positive definite
in the factor's lower triangle (JAX's Cholesky), without raising."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu.ops import covariance as jcov
from icp_tpu_torch.ops import covariance


def _cloud(dim, seed, n=120):
    rng = np.random.default_rng(seed)
    if dim == 2:  # two walls of a corridor and a cross wall
        t = rng.uniform(-4, 4, n)
        pts = np.concatenate([np.stack([t, np.full(n, -1.0)], -1), np.stack([t, np.ones(n)], -1),
                              np.stack([np.full(n // 4, 3.0), t[: n // 4] / 4], -1)])
    else:
        xy = rng.uniform(-3, 3, (n, 2))
        pts = np.column_stack([xy, 0.3 * np.sin(xy[:, 0]) + 0.2 * xy[:, 1]])
    return pts + rng.normal(0, 0.005, pts.shape)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_information_matches_jax(dim, masked):
    rng = np.random.default_rng(dim)
    pts = rng.normal(size=(2, 50, dim))
    normals = rng.normal(size=(2, 50, dim))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    mask = rng.uniform(size=(2, 50)) > 0.3 if masked else None
    got = covariance.scan_matching_information(
        torch.from_numpy(pts), torch.from_numpy(normals),
        None if mask is None else torch.from_numpy(mask), sigma=0.05)
    want = jax.jit(jcov.scan_matching_information)(
        jnp.asarray(pts), jnp.asarray(normals), None if mask is None else jnp.asarray(mask), 0.05)
    assert got.shape == (2, 3 if dim == 2 else 6, 3 if dim == 2 else 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dim", [2, 3])
def test_cloud_information_and_whitener_match_jax(dim):
    pts = _cloud(dim, dim)
    h = covariance.cloud_information(T.from_points(pts, device="cpu"), k=8)
    jh = jax.jit(jcov.cloud_information, static_argnums=1)(J.from_points(pts, dtype=np.float64), 8)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-9, atol=1e-12)
    for eps in (1e-6, 1e-3):
        got = covariance.sqrt_information(h, eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jcov.sqrt_information)(jh, eps)),
                                   rtol=1e-9, atol=1e-12)
        reg = h + eps * h.diagonal().mean() * torch.eye(h.shape[-1], dtype=h.dtype)
        np.testing.assert_allclose((got.T @ got).numpy(), reg.numpy(), rtol=1e-9, atol=1e-12)


def test_sqrt_information_not_positive_definite_is_nan():
    bad = torch.tensor([[[1.0, 0.0], [0.0, -5.0]], [[2.0, 0.5], [0.5, 1.0]]],
                       dtype=torch.float64)
    got = covariance.sqrt_information(bad, 1e-6)
    want = np.asarray(jcov.sqrt_information(jnp.asarray(bad.numpy()), 1e-6))
    assert torch.isnan(got[0]).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)  # NaN where JAX has NaN

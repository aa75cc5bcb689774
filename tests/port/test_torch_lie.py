"""``icp_tpu_torch.lie`` against ``icp_tpu.lie`` on the same seeded twists.

float64 at atol 1e-12, and float32 (whose small-angle cut-off is
``eps ** 0.25`` ~ 1.9e-2) at atol 1e-6, over generic twists, angles on both
sides of the cut-off, zero, and rotations near pi; plus the round trips and
``dof``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu import geometry as jgeometry
from icp_tpu import lie as jlie
from icp_tpu_torch import geometry, lie

TOL = {np.float64: 1e-12, np.float32: 1e-6}
DTYPES = {np.float64: torch.float64, np.float32: torch.float32}


def _twists(dim, kind, dtype, n=24):
    rng = np.random.default_rng(dim * 10 + len(kind))
    dof = 3 if dim == 2 else 6
    xi = rng.uniform(-1.5, 1.5, (n, dof))
    rot = xi[:, 2:] if dim == 2 else xi[:, 3:]
    if kind == "zero":
        rot[:] = 0.0
    elif kind == "small":  # straddle both precisions' cut-offs
        rot *= np.geomspace(1e-9, 3e-2, n)[:, None] / np.abs(rot).max(-1, keepdims=True)
    elif kind == "near_pi":
        rot *= (np.pi - np.geomspace(1e-7, 1e-2, n))[:, None] / np.linalg.norm(
            rot, axis=-1, keepdims=True)
    return xi.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["generic", "small", "zero", "near_pi"])
@pytest.mark.parametrize("dim", [2, 3])
def test_exp_log_match_jax(dim, kind, dtype):
    xi = _twists(dim, kind, dtype)
    got = lie.exp(torch.from_numpy(xi), dim)
    want = jax.jit(jlie.exp, static_argnums=1)(jnp.asarray(xi), dim)
    assert got.rotation.dtype == DTYPES[dtype]
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=TOL[dtype])
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation),
                               atol=TOL[dtype])
    back = lie.log(got)
    want_back = np.asarray(jax.jit(jlie.log)(want))
    if kind == "near_pi" and dtype == np.float32:
        # Within float32 noise of pi the signs of the axis' components
        # come from a skew part at rounding level (in JAX too, and differ
        # between its jitted and eager runs): compare the angle only.
        np.testing.assert_allclose(np.linalg.norm(back.numpy()[:, -3:], axis=-1),
                                   np.linalg.norm(want_back[:, -3:], axis=-1), atol=1e-3)
    else:
        # so3_log near pi is accurate to ~sqrt(eps) by design.
        tol = TOL[dtype] * 10 if kind != "near_pi" else 1e-6
        np.testing.assert_allclose(back.numpy(), want_back, atol=tol)
    if kind != "near_pi" and dtype == np.float64:
        np.testing.assert_allclose(back.numpy(), xi, atol=1e-9)


@pytest.mark.parametrize("dim", [2, 3])
def test_log_of_composed_transforms_matches_jax(dim):
    """``log(exp(a) o exp(b))``: the log of a general group element."""
    a, b = _twists(dim, "generic", np.float64), _twists(dim, "small", np.float64)
    jt = jgeometry.compose(jlie.exp(jnp.asarray(a), dim), jlie.exp(jnp.asarray(b), dim))
    tt = geometry.compose(lie.exp(torch.from_numpy(a), dim), lie.exp(torch.from_numpy(b), dim))
    np.testing.assert_allclose(lie.log(tt).numpy(), np.asarray(jlie.log(jt)), atol=1e-12)


def test_so3_and_dof():
    omega = _twists(3, "generic", np.float64)[:, 3:]
    np.testing.assert_allclose(lie.so3_exp(torch.from_numpy(omega)).numpy(),
                               np.asarray(jlie.so3_exp(jnp.asarray(omega))), atol=1e-12)
    rot = lie.so3_exp(torch.from_numpy(omega))
    np.testing.assert_allclose(lie.so3_log(rot).numpy(), omega, atol=1e-10)
    assert (lie.dof(2), lie.dof(3)) == (jlie.dof(2), jlie.dof(3)) == (3, 6)
    for dtype in (torch.float32, torch.float64):
        assert lie._small_cut(dtype) == jlie._small_cut(DTYPES_J[dtype])
        assert lie._general_cut(dtype) == jlie._general_cut(DTYPES_J[dtype])


DTYPES_J = {torch.float32: jnp.float32, torch.float64: jnp.float64}

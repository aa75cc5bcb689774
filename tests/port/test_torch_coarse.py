"""``icp_tpu_torch.ops.coarse`` against the JAX package, float64 on the CPU.

Within 1e-9: bearing histograms, histogram angles and the 2D and 3D
guesses (the 3D candidates scored by the plain 1-NN, ties to the first
candidate as in JAX).  The inputs are seeded room-like clouds with padding
and per-lane counts.  ``coarse_init=True`` of the NDT schedule is held
against JAX in ``test_torch_ndt.py``.  The ``cuda``-marked twins run on the
card in float32 against the CPU float64 run: the 2D angle within one bin
(cuFFT can move the ``argmax`` to a neighbouring bin where two shifts
score alike), and the 3D scoring through the K2 kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu.ops import coarse as jcoarse
from icp_tpu_torch import convert, geometry
from icp_tpu_torch.ops import coarse, fused_nn

BIN = 2 * np.pi / 180


def _room(rng, n=300, dim=2):
    """An asymmetric room (walls in 2D; three planes of unequal extent in 3D)."""
    if dim == 2:
        k = n // 3
        pts = np.concatenate([
            np.column_stack([np.linspace(-8, 8, k), np.full(k, -5.0)]),
            np.column_stack([np.full(k, 8.0), np.linspace(-5, 2, k)]),
            np.column_stack([np.linspace(-8, 2, n - 2 * k), np.full(n - 2 * k, 6.0)]),
        ])
    else:
        k = n // 3
        u = lambda lo, hi, m: rng.uniform(lo, hi, m)  # noqa: E731
        pts = np.concatenate([
            np.column_stack([u(-6, 6, k), u(-3, 3, k), np.zeros(k)]),
            np.column_stack([u(-6, 6, k), np.full(k, -3.0), u(0, 2, k)]),
            np.column_stack([np.full(n - 2 * k, 6.0), u(-3, 3, n - 2 * k), u(0, 4, n - 2 * k)]),
        ])
    return pts + rng.normal(0, 0.02, pts.shape)


def _pairs(seed, dim, degs, capacity=320):
    """Source/target lanes: the room and the room moved by each angle
    (about z in 3D), counts cut per lane; padding holds zeros."""
    rng = np.random.default_rng(seed)
    base = _room(rng, dim=dim)
    src = np.zeros((len(degs), capacity, dim))
    tgt = np.zeros_like(src)
    counts = np.array([300 - 17 * i for i in range(len(degs))], dtype=np.int32)
    for i, deg in enumerate(degs):
        a = np.deg2rad(deg)
        rot = np.eye(dim)
        rot[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        moved = base @ rot.T + rng.uniform(-2, 2, dim)
        src[i, : counts[i]] = base[: counts[i]]
        tgt[i, : counts[i]] = moved[: counts[i]]
    return src, tgt, counts


def _clouds(src, tgt, counts, device="cpu", dtype=None):
    return (convert.cloud_from_numpy(src, counts, device=device, dtype=dtype),
            convert.cloud_from_numpy(tgt, counts, device=device, dtype=dtype))


def _jax_clouds(src, tgt, counts):
    return (J.cloud.PointCloud(jnp.asarray(src), jnp.asarray(counts)),
            J.cloud.PointCloud(jnp.asarray(tgt), jnp.asarray(counts)))


DEGS = [0.0, 37.0, -120.0, 171.0]


def test_bearing_histogram_matches_jax():
    src, _, counts = _pairs(1, 2, DEGS)
    cloud, _ = _clouds(src, src, counts)
    jcloud, _ = _jax_clouds(src, src, counts)
    for bins in (180, 64):
        got = coarse.bearing_histogram(cloud.points, cloud.mask, bins)
        want = jax.jit(jcoarse.bearing_histogram, static_argnums=2)(jcloud.points, jcloud.mask,
                                                                     bins)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-12)


def test_rotation_from_histograms_matches_jax():
    src, tgt, counts = _pairs(2, 2, DEGS)
    a, b = _clouds(src, tgt, counts)
    h_a = coarse.bearing_histogram(a.points, a.mask, 180)
    h_b = coarse.bearing_histogram(b.points, b.mask, 180)
    got = coarse.rotation_from_histograms(h_a, h_b)
    want = jax.jit(jcoarse.rotation_from_histograms)(jnp.asarray(h_a.numpy()),
                                                     jnp.asarray(h_b.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9)


@pytest.mark.parametrize("seed", [3, 4])
def test_coarse_align_2d_matches_jax(seed):
    src, tgt, counts = _pairs(seed, 2, DEGS)
    got = coarse.coarse_align_2d(*_clouds(src, tgt, counts))
    want = jax.jit(jcoarse.coarse_align_2d)(*_jax_clouds(src, tgt, counts))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-9)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-9)
    # The guess lands inside ICP's basin: within a few degrees of the truth.
    err = np.angle(np.exp(1j * (geometry.rotation_angle_2d(got.rotation).numpy()
                                - np.deg2rad(DEGS))))
    assert np.abs(err).max() < np.deg2rad(6)


@pytest.mark.parametrize("batched", [False, True])
def test_coarse_align_3d_matches_jax(batched):
    src, tgt, counts = _pairs(5, 3, DEGS)
    if not batched:
        src, tgt, counts = src[1], tgt[1], counts[1]
    got = coarse.coarse_align_3d(*_clouds(src, tgt, counts))
    want = jax.jit(jcoarse.coarse_align_3d)(*_jax_clouds(src, tgt, counts))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-9)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-9)
    assert got.rotation.shape == (*np.shape(counts), 3, 3)


def test_coarse_plus_icp_recovers_large_rotation():
    """The guess seeds trimmed ICP into the right basin at 120 degrees, as
    the JAX package's own test shows."""
    src, tgt, counts = _pairs(6, 2, [120.0])
    a, b = _clouds(src[0], tgt[0], counts[0])
    method = T.from_method("trimmed", 2, T.Config(overlap_rate=1.0))
    cfg = T.DriverConfig(max_iterations=60, angle_tolerance=1e-5, translation_tolerance=1e-5)
    result, _ = T.converge(method, a, b, coarse.coarse_align_2d(a, b), cfg)
    assert abs(float(geometry.rotation_angle_2d(result.transform.rotation))
               - np.deg2rad(120)) < 1e-3


# --- on the card -----------------------------------------------------------


@pytest.mark.cuda
def test_coarse_2d_on_card_within_one_bin(cuda_device):
    src, tgt, counts = _pairs(3, 2, DEGS)
    gpu = coarse.coarse_align_2d(*_clouds(src, tgt, counts, cuda_device, torch.float32))
    cpu = coarse.coarse_align_2d(*_clouds(src, tgt, counts))
    d = (geometry.rotation_angle_2d(gpu.rotation).double().cpu()
         - geometry.rotation_angle_2d(cpu.rotation))
    assert float(torch.atan2(torch.sin(d), torch.cos(d)).abs().max()) <= BIN


@pytest.mark.cuda
def test_coarse_3d_on_card_scores_through_k2(cuda_device):
    src, tgt, counts = _pairs(5, 3, DEGS)
    fused_nn.LAUNCHES = fused_nn.COORD_LAUNCHES = 0
    gpu = coarse.coarse_align_3d(*_clouds(src, tgt, counts, cuda_device, torch.float32))
    assert fused_nn.LAUNCHES == 1 and fused_nn.COORD_LAUNCHES == 0
    cpu = coarse.coarse_align_3d(*_clouds(src, tgt, counts))
    np.testing.assert_allclose(gpu.rotation.double().cpu().numpy(), cpu.rotation.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(gpu.translation.double().cpu().numpy(),
                               cpu.translation.numpy(), atol=1e-3)

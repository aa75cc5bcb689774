"""``icp_tpu_torch.ops.filters.remove_statistical_outliers`` against the JAX
package, float64 on the CPU: survivor counts and the compacted points are
exact (the same distances, the same thresholds, the same stable
compaction).  Cases: seeded clouds with planted outliers, batched with
per-lane counts, a lane with fewer points than k (the ``count <= k`` slot
mask), k above the capacity, and a 3D cloud.  The ``cuda`` twin runs the
filter on the card in float32 and keeps the CPU float64 survivors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
from icp_tpu.ops.filters import remove_statistical_outliers as jax_sor
from icp_tpu_torch import convert
from icp_tpu_torch.ops.filters import remove_statistical_outliers


def _clouds(seed, dim=2, lanes=3, capacity=128):
    """Lanes of a noisy line with a few far outliers; counts fall per lane,
    the last lane holding fewer points than k."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((lanes, capacity, dim))
    counts = np.array([capacity - 9 * i for i in range(lanes - 1)] + [5], dtype=np.int32)
    for i, n in enumerate(counts):
        line = np.zeros((n, dim))
        line[:, 0] = np.linspace(-5, 5, n)
        line += rng.normal(0, 0.05, line.shape)
        bad = rng.choice(n, size=min(4, n), replace=False)
        line[bad] += rng.uniform(3, 6, (len(bad), dim))
        pts[i, :n] = line
    return pts, counts


@pytest.mark.parametrize("dim, k, std_ratio", [(2, 8, 2.0), (2, 3, 1.0), (3, 8, 2.0),
                                               (2, 500, 2.0)])
def test_sor_matches_jax(dim, k, std_ratio):
    pts, counts = _clouds(dim * 10 + k, dim)
    got = remove_statistical_outliers(convert.cloud_from_numpy(pts, counts, device="cpu"),
                                      k=k, std_ratio=std_ratio)
    want = jax.jit(jax_sor, static_argnums=(1, 2))(
        J.cloud.PointCloud(jnp.asarray(pts), jnp.asarray(counts)), k, std_ratio)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    assert (got.count.numpy()[:-1] < counts[:-1]).all()  # outliers went


def test_sor_unbatched_and_validation():
    pts, counts = _clouds(7, lanes=2)
    cloud = convert.cloud_from_numpy(pts[0], counts[0], device="cpu")
    got = remove_statistical_outliers(cloud)
    want = jax.jit(jax_sor)(J.cloud.PointCloud(jnp.asarray(pts[0]), jnp.asarray(counts[0])))
    assert int(got.count) == int(want.count)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    with pytest.raises(ValueError, match="k must be positive"):
        remove_statistical_outliers(cloud, k=0)


@pytest.mark.cuda
def test_sor_on_card_keeps_cpu_survivors(cuda_device):
    pts, counts = _clouds(11)
    gpu = remove_statistical_outliers(
        convert.cloud_from_numpy(pts, counts, device=cuda_device, dtype=torch.float32))
    cpu = remove_statistical_outliers(convert.cloud_from_numpy(pts, counts, device="cpu"))
    assert torch.equal(gpu.count.cpu(), cpu.count)
    np.testing.assert_allclose(gpu.points.double().cpu().numpy(), cpu.points.numpy(), atol=1e-5)

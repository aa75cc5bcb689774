"""``icp_tpu_torch.ops.descriptor`` (Scan Context) against the JAX package,
float64 on the CPU, on seeded numpy inputs:

* ``scan_context`` in 2D (bilinear sector splat) and 3D (max height, empty
  bins 0), both centers, with masked points, points past ``max_radius`` and
  points at theta = +pi and -pi, to 1e-12; ``ring_key``;
* ``descriptor_query`` distances to 1e-12 and shifts exact, including a
  constructed tie (a descriptor of period S/2: shifts s and s + S/2 give
  the same distance, and the lower one is kept);
* all-pairs and incremental candidates exact in pairs and order (``exclude``,
  ``max_candidates`` truncation) with the yaws to 1e-12; ``yaw_seeds`` in 2D
  and 3D; the validation errors.

The ``cuda``-marked twin holds ``descriptor_query`` on the card (float32)
against the CPU float64 run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu import cloud as jcloud
from icp_tpu.ops import descriptor as jd
from icp_tpu_torch import convert
from icp_tpu_torch.ops import descriptor as td


def _t(x, device="cpu"):
    return torch.as_tensor(np.asarray(x), device=device)


def _clouds(rng, dim, batch=5, n=200, radius=10.0):
    """Points up to 1.4 radius (some past it), a ragged mask, and rows at
    theta = +pi / -pi and at the origin."""
    pts = rng.uniform(-1.4 * radius, 1.4 * radius, (batch, n, dim))
    if dim == 3:
        pts[..., 2] = rng.uniform(-2, 3, (batch, n))
    pts[:, 0, :2] = [-3.0, 0.0]  # atan2(0, -3) = +pi
    pts[:, 1, :2] = [-3.0, -0.0]  # atan2(-0, -3) = -pi
    pts[:, 2, :2] = [0.0, 0.0]
    mask = rng.uniform(size=(batch, n)) > 0.2
    mask[:, :3] = True
    return pts, mask


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("center", ["origin", "centroid"])
def test_scan_context_matches_jax(rng, dim, center):
    pts, mask = _clouds(rng, dim)
    want = jd.scan_context(jnp.asarray(pts), jnp.asarray(mask), rings=12, sectors=30,
                           max_radius=10.0, center=center)
    got = td.scan_context(_t(pts), _t(mask), rings=12, sectors=30, max_radius=10.0,
                          center=center)
    assert got.shape == (5, 12, 30) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    # Unbatched, and the ring key.
    one = td.scan_context(_t(pts[0]), _t(mask[0]), rings=12, sectors=30, max_radius=10.0,
                          center=center)
    np.testing.assert_allclose(one.numpy(), np.asarray(want)[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(td.ring_key(got).numpy(), np.asarray(jd.ring_key(want)),
                               rtol=0, atol=1e-12)
    if dim == 2:  # each valid point within the radius splats one unit of mass
        assert (got.sum((-1, -2)).numpy() < mask.sum(-1)).all()


def _descs(rng, t=14, n=120):
    """Descriptors of scans of one world seen from poses on a circle, twice
    (revisits), plus noise: realistic distances and yaws."""
    world = rng.uniform(-20, 20, (n, 2))
    out = []
    for k in range(t):
        phi = 2 * np.pi * (k % (t // 2)) / (t // 2)
        c, s = np.cos(phi + np.pi / 2), np.sin(phi + np.pi / 2)
        pts = (world - [4 * np.cos(phi), 4 * np.sin(phi)]) @ np.array([[c, -s], [s, c]])
        out.append(pts + rng.normal(0, 0.02, pts.shape))
    pts = np.stack(out)
    return np.asarray(jd.scan_context(jnp.asarray(pts), jnp.ones(pts.shape[:2], bool),
                                      max_radius=40.0))


@pytest.fixture(scope="module")
def descs():
    return _descs(np.random.default_rng(7))


def test_descriptor_query_matches_jax(descs):
    want_d, want_s = jd.descriptor_query(jnp.asarray(descs[:5]), jnp.asarray(descs))
    got_d, got_s = td.descriptor_query(_t(descs[:5]), _t(descs))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-12)
    assert got_s.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_descriptor_query_tie_keeps_lowest_shift(rng):
    """A database entry of period S/2 matches the query at shift s and at
    s + S/2 with exactly the same products: the lower shift is kept."""
    half = rng.uniform(0, 1, (6, 15))
    periodic = np.concatenate([half, half], axis=-1)[None]  # (1, 6, 30)
    query = np.roll(periodic, 4, axis=-1) + rng.uniform(0, 0.05, periodic.shape)
    db = np.concatenate([periodic, rng.uniform(0, 1, (2, 6, 30))])
    want_d, want_s = jd.descriptor_query(jnp.asarray(query), jnp.asarray(db))
    got_d, got_s = td.descriptor_query(_t(query), _t(db))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # The tie is real: both halves give the same distance bit for bit.
    s = int(got_s[0, 0])
    assert s < 15
    uq = td.descriptor_query(_t(query), _t(np.roll(db[:1], -15, axis=-1)))
    assert float(uq[0][0, 0]) == float(got_d[0, 0])


@pytest.mark.parametrize("max_candidates", [None, 5])
def test_all_pairs_candidates_match_jax(descs, max_candidates):
    want_p, want_y = jd.find_loop_candidates_descriptor(
        jnp.asarray(descs), 0.4, min_separation=3, max_candidates=max_candidates)
    got_p, got_y = td.find_loop_candidates_descriptor(
        _t(descs), 0.4, min_separation=3, max_candidates=max_candidates)
    assert got_p.dtype == torch.int32 and len(got_p) > 0
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-12)
    pairs, _ = td.descriptor_distances(_t(descs))
    assert pairs.shape == (len(descs), len(descs))


@pytest.mark.parametrize("new_start", [0, 5, 7, 13, 14])
def test_incremental_candidates_match_jax(descs, new_start):
    """Pairs and order equal to JAX's (which pads both axes to buckets), with
    an ``exclude`` and a ``max_candidates`` that truncates."""
    t = len(descs)
    exclude = np.zeros((t, t), dtype=bool)
    exclude[0, 7] = exclude[1, 8] = exclude[2, 12] = True
    for ex, cap in ((None, None), (exclude, None), (exclude, 3)):
        want_p, want_y = jd.find_loop_candidates_descriptor_incremental(
            jnp.asarray(descs), new_start, 0.4, min_separation=3, max_candidates=cap,
            exclude=None if ex is None else jnp.asarray(ex))
        got_p, got_y = td.find_loop_candidates_descriptor_incremental(
            _t(descs), new_start, 0.4, min_separation=3, max_candidates=cap,
            exclude=None if ex is None else _t(ex))
        np.testing.assert_array_equal(got_p.numpy().reshape(-1, 2), np.asarray(want_p))
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-12)
        if cap is not None and new_start < 7:
            assert len(got_p) == cap  # the budget truncates


@pytest.mark.parametrize("dim", [2, 3])
def test_yaw_seeds_match_jax(rng, dim):
    pts, mask = _clouds(rng, dim, batch=6, n=64)
    counts = mask.sum(-1)
    packed = np.zeros_like(pts)
    for b in range(len(pts)):
        packed[b, :counts[b]] = pts[b][mask[b]]
    pairs = np.asarray([[0, 3], [1, 5], [2, 4], [0, 1]], dtype=np.int32)
    yaw = rng.uniform(-np.pi, np.pi, len(pairs))
    want = jd.yaw_seeds(jcloud.PointCloud(jnp.asarray(packed), jnp.asarray(counts, jnp.int32)),
                        jnp.asarray(pairs), jnp.asarray(yaw))
    got = td.yaw_seeds(convert.cloud_from_numpy(packed, counts, device="cpu"), _t(pairs),
                       _t(yaw))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-12)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation),
                               atol=1e-12)


def test_validation_errors(descs):
    pts = _t(np.zeros((4, 2)))
    mask = _t(np.ones(4, bool))
    with pytest.raises(ValueError, match="max_radius"):
        td.scan_context(pts, mask)
    with pytest.raises(ValueError, match="center"):
        td.scan_context(pts, mask, max_radius=1.0, center="mean")
    with pytest.raises(ValueError, match="new_start"):
        td.find_loop_candidates_descriptor_incremental(_t(descs), len(descs) + 1, 0.5)
    pairs, yaw = td.find_loop_candidates_descriptor_incremental(_t(descs), len(descs), 0.5)
    assert pairs.shape == (0, 2) and yaw.shape == (0,)


@pytest.mark.cuda
def test_descriptor_query_on_card(cuda_device, descs):
    """The retrieval on the card in float32 against the CPU in float64:
    distances to 1e-5, shifts equal wherever the best shift leads the next
    by more than 1e-5."""
    want_d, want_s = td.descriptor_query(_t(descs), _t(descs))
    got_d, got_s = td.descriptor_query(_t(descs, cuda_device).float(),
                                       _t(descs, cuda_device).float())
    np.testing.assert_allclose(got_d.cpu().double().numpy(), want_d.numpy(), atol=1e-5)
    margin = _shift_margins(descs)
    clear = margin > 1e-5
    np.testing.assert_array_equal(got_s.cpu().numpy()[clear], want_s.numpy()[clear])


def _shift_margins(descs):
    """Per pair, the gap between the best and the second-best shift's
    distance (numpy, float64)."""
    unit = descs / np.maximum(np.linalg.norm(descs, axis=-2, keepdims=True), 1e-300)
    flat = unit.reshape(len(descs), -1)
    sectors = descs.shape[-1]
    per_shift = np.stack([
        1.0 - flat @ np.roll(unit, -s, axis=-1).reshape(len(descs), -1).T / sectors
        for s in range(sectors)])
    per_shift.sort(0)
    return per_shift[1] - per_shift[0]

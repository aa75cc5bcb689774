"""2D ``vanilla`` and ``feature_aware``: the port against the golden pins of
``tests/golden_local.json`` (the JAX package's own pins on the in-repo scans)
and against the JAX package in float64.

Iteration counts and match indices must be equal; costs agree at rtol 1e-9
and poses at atol 1e-9 (sums are taken in another order).  The
``cuda``-marked twins run both methods on the card in float32 against the CPU
float64 run, and hold K1 and K2 exact at the method matrix's shapes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu.methods import feature_aware as jfa
from icp_tpu_torch import convert, geometry
from icp_tpu_torch.methods import feature_aware as tfa
from icp_tpu_torch.ops import fused_nn, pallas_nn

GOLDEN_LOCAL = os.path.join(os.path.dirname(os.path.dirname(__file__)), "golden_local.json")
BENCH = dict(max_iterations=50, angle_tolerance=0.1 * np.pi / 180, translation_tolerance=0.01)


def _pair(scan_dir, scan):
    return (T.io.parse_lidar_scan_array(f"{scan_dir}/scan{scan}/first.csv"),
            T.io.parse_lidar_scan_array(f"{scan_dir}/scan{scan}/second.csv"))


@pytest.mark.parametrize("scan", [1, 2, 3])
@pytest.mark.parametrize("name", ["vanilla", "feature_aware"])
def test_golden_local(scan_dir, name, scan):
    """The pins of ``tests/test_golden.py::test_bench_config_golden_local``."""
    with open(GOLDEN_LOCAL) as f:
        golden = json.load(f)[f"{name}/scan{scan}"]
    a, b = _pair(scan_dir, scan)
    result, state = T.converge(
        T.from_method(name, 2), T.from_points(a, device="cpu"), T.from_points(b, device="cpu"),
        T.identity(2, device="cpu"), T.DriverConfig(**BENCH),
    )
    assert int(result.iteration_count) == golden["iterations"]
    np.testing.assert_allclose(float(result.cost), golden["cost"], rtol=1e-9)
    np.testing.assert_allclose(result.transform.rotation.numpy(), golden["rotation"], atol=1e-9)
    np.testing.assert_allclose(result.transform.translation.numpy(), golden["translation"],
                               atol=1e-9)
    matches = T.get_matches(state)
    assert matches.target_idx is state.match_idx and int(matches.valid.sum()) == len(a)


def _lanes(scan_dir, scan, batch, seed):
    a, b = _pair(scan_dir, scan)
    ja, jb = J.from_points(a, dtype=np.float64), J.from_points(b, dtype=np.float64)
    rng = np.random.default_rng(seed)
    ang, sh = rng.uniform(-0.05, 0.05, batch), rng.uniform(-0.2, 0.2, (batch, 2))
    lanes = lambda c: J.PointCloud(  # noqa: E731
        jnp.broadcast_to(c.points, (batch, *c.points.shape)), jnp.full((batch,), c.count))
    jax_side = (lanes(ja), lanes(jb), J.from_angle_2d(jnp.asarray(ang), jnp.asarray(sh)))
    port_side = tuple(
        convert.cloud_from_numpy(np.asarray(c.points), np.asarray(c.count), device="cpu")
        for c in jax_side[:2]
    ) + (convert.transform_from_numpy(np.asarray(jax_side[2].rotation),
                                      np.asarray(jax_side[2].translation), device="cpu"),)
    return jax_side, port_side


@pytest.mark.parametrize("name", ["vanilla", "feature_aware"])
def test_init_and_iterates_match_jax(scan_dir, name):
    """Three lanes of scan2 under perturbed guesses: the state after init and
    after each of two iterates."""
    (js, jt, jg), (ts, tt, tg) = _lanes(scan_dir, 2, batch=3, seed=5)
    jm, tm = J.from_method(name, 2), T.from_method(name, 2)
    jstate, tstate = jax.jit(jm.init)(js, jt, jg), tm.init(ts, tt, tg)
    step = jax.jit(jm.iterate)
    for it in range(3):
        np.testing.assert_array_equal(tstate.match_idx.numpy(), np.asarray(jstate.match_idx))
        np.testing.assert_allclose(tstate.match_cost.numpy(), np.asarray(jstate.match_cost),
                                   rtol=1e-9)
        np.testing.assert_allclose(tm.cost(tstate).numpy(), np.asarray(jm.cost(jstate)),
                                   rtol=1e-9)
        for got, want in ((tstate.transform.rotation, jstate.transform.rotation),
                          (tstate.transform.translation, jstate.transform.translation)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9,
                                       err_msg=f"after {it} iterates")
        if name == "feature_aware":
            np.testing.assert_allclose(tstate.feature_dists.numpy(),
                                       np.asarray(jstate.feature_dists), atol=1e-12)
        jstate, tstate = step(jstate), tm.iterate(tstate)


def test_feature_dists_pass_through_by_identity(scan_dir):
    """The (N, M) feature distances ride through each iterate as the same
    tensor, so the driver's per-lane freeze never copies them."""
    _, (ts, tt, tg) = _lanes(scan_dir, 1, batch=2, seed=1)
    method = T.from_method("feature_aware", 2)
    state = method.init(ts, tt, tg)
    assert method.iterate(state).feature_dists is state.feature_dists


@pytest.mark.parametrize("sn", [1, 3, 10])
@pytest.mark.parametrize("counts", [(8, 8), (7, 2), (5, 0)])
def test_compute_features_matches_jax(counts, sn):
    """Window edges: scans shorter than the window, a window wider than the
    scan, padding, and an empty lane."""
    rng = np.random.default_rng(sum(counts) + sn)
    pts = rng.uniform(-3, 3, (2, 8, 2))
    count = np.asarray(counts, dtype=np.int32)
    mask = np.arange(8)[None, :] < count[:, None]
    pts = np.where(mask[..., None], pts, 0.0)
    want = np.asarray(jfa.compute_features(jnp.asarray(pts), jnp.asarray(mask),
                                           jnp.asarray(count), sn))
    got = tfa.compute_features(torch.from_numpy(pts), torch.from_numpy(mask),
                               torch.from_numpy(count), sn)
    assert got.shape == (2, 8, 2 * sn)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_pairwise_euclid_and_normalize_match_jax():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(2, 30, 6)), rng.normal(size=(2, 40, 6))
    valid = rng.uniform(size=(2, 30, 40)) > 0.2
    want = jfa._normalize_by_max(jfa.pairwise_euclid(jnp.asarray(a), jnp.asarray(b)),
                                 jnp.asarray(valid))
    got = tfa._normalize_by_max(tfa.pairwise_euclid(torch.from_numpy(a), torch.from_numpy(b)),
                                torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    tiny = tfa._normalize_by_max(torch.full((1, 2, 2), 1e-7, dtype=torch.float64),
                                 torch.ones((1, 2, 2), dtype=torch.bool))
    assert torch.equal(tiny, torch.full((1, 2, 2), 1e-7, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vanilla", "feature_aware"])
def test_2d_methods_on_card_agree_with_cpu(cuda_device, scan_dir, name):
    """Eight lanes of scan1 under the bench's guesses, float32 on the card
    against float64 on the CPU: translation within 2e-3."""
    a, b = _pair(scan_dir, 1)
    rng = np.random.default_rng(0)
    ang = rng.uniform(-0.05, 0.05, 8).astype(np.float32)
    sh = rng.uniform(-0.2, 0.2, (8, 2)).astype(np.float32)
    cfg = T.DriverConfig(**BENCH)
    out = {}
    before = fused_nn.LAUNCHES
    for dev in (cuda_device, torch.device("cpu")):
        src = T.stack([T.from_points(a, capacity=1024, device=dev)] * 8)
        tgt = T.stack([T.from_points(b, capacity=1024, device=dev)] * 8)
        guess = T.from_angle_2d(torch.tensor(ang, dtype=src.dtype, device=dev),
                                torch.tensor(sh, dtype=src.dtype, device=dev))
        out[dev.type], _ = T.make_converge_fn(T.from_method(name, 2), cfg)(src, tgt, guess)
    if name == "vanilla":
        assert fused_nn.LAUNCHES > before  # its init's K2
    dt = out["cuda"].transform.translation.double().cpu() - out["cpu"].transform.translation
    assert float(torch.linalg.vector_norm(dt, dim=-1).max()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("scan", [1, 2])
def test_nn_kernels_exact_at_matrix_shapes(cuda_device, scan_dir, scan):
    """K1 and K2 on the method matrix's inputs, B = 256 lanes under seeded
    guesses: (256, 1024, 1024, 2) on scan1 and (256, 1096, 1096, 2) on
    scan2, whose last block of queries is ragged.  Exact against the plain
    version."""
    a, b = _pair(scan_dir, scan)
    cap = max(1024, -(-max(len(a), len(b)) // 8) * 8)
    f32 = torch.float32
    src, tgt = (T.stack([T.from_points(p, capacity=cap, dtype=f32, device=cuda_device)] * 256)
                for p in (a, b))
    rng = np.random.default_rng(0)
    guess = T.from_angle_2d(
        torch.tensor(rng.uniform(-0.05, 0.05, 256), dtype=f32, device=cuda_device),
        torch.tensor(rng.uniform(-0.2, 0.2, (256, 2)), dtype=f32, device=cuda_device))
    q, t = geometry.apply(guess, src.points).contiguous(), tgt.points
    got = fused_nn.fused_nearest_neighbors(q, t, tgt.mask, return_coords=True)
    got2 = pallas_nn.nearest_neighbors_pallas(q, t, tgt.mask)
    want = fused_nn.plain_fused_nearest_neighbors(q, t, tgt.mask, return_coords=True)
    for k, w in ((got, want), (got2, want[:2])):
        assert torch.equal(k[0].view(torch.int32), w[0].view(torch.int32))
        assert torch.equal(k[1], w[1])
    assert torch.equal(got[2], want[2])

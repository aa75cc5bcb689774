"""The net-new NN families (point_to_plane, robust, symmetric, gicp): the port
against the JAX package in float64 on the CPU.

Exact: iteration counts, match indices, the selected neighbour sets
(``select`` against ``topk`` and ``lax.top_k``, ties included), medians and
the registry.  Within 1e-9: poses (atol), costs, moments, normals and
covariances (rtol).  Inputs are the in-repo scans (scan1 under the bench
driver config; a seeded 300-point subsample of the torus PLY pair in 3D)
or seeded clouds of 64-256 points.  The ``cuda``-marked twins run each
family in float32 on the card against the CPU float64 run (translation
within 2e-3 m) and hold K2 exact on the family's own inputs.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu.methods import gicp as jgicp
from icp_tpu.methods import point_to_plane as jp2l
from icp_tpu.methods import robust as jrobust
from icp_tpu_torch import convert
from icp_tpu_torch.methods import gicp, point_to_plane, robust
from icp_tpu_torch.ops import fused_nn, nn, pallas_nn, select

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = dict(max_iterations=50, angle_tolerance=0.1 * np.pi / 180, translation_tolerance=0.01)
CFG_3D = dict(max_iterations=100, angle_tolerance=1e-4, translation_tolerance=1e-4)
FAMILIES = {
    "point_to_plane": dict(normal_neighbors=10),
    "robust": {},
    "gicp": dict(neighbors=10),
    "symmetric": dict(normal_neighbors=10),
}


def _jax_converge(method, source, target, guess, config):
    """``icp_tpu.converge`` under one ``jax.jit`` (compiles faster than
    its eager entry)."""
    return jax.jit(lambda s, t, g: J.converge(method, s, t, g, config))(source, target, guess)


def _scan1():
    return (T.io.parse_lidar_scan_array(f"{REPO}/ex_data/scan1/first.csv"),
            T.io.parse_lidar_scan_array(f"{REPO}/ex_data/scan1/second.csv"))


@functools.cache
def _torus(n=300):
    ply = os.path.join(REPO, "ex_data", "ply")
    src = T.read_ply(os.path.join(ply, "torus_transformed.ply"))
    dst = T.read_ply(os.path.join(ply, "torus.ply"))
    rng = np.random.default_rng(3)
    return (src[np.sort(rng.choice(len(src), n, replace=False))],
            dst[np.sort(rng.choice(len(dst), n, replace=False))])


def _sides(src_pts, dst_pts, rot, trans, capacity=None):
    """The same lanes on both sides: JAX clouds and transform (float64) and
    the port's, carried over by ``convert``."""
    js = J.from_points(src_pts, capacity=capacity, dtype=np.float64)
    jt = J.from_points(dst_pts, capacity=capacity, dtype=np.float64)
    jg = J.RigidTransform(jnp.asarray(rot), jnp.asarray(trans))
    lead = jg.batch_shape
    lanes = lambda c: J.PointCloud(  # noqa: E731
        jnp.broadcast_to(c.points, (*lead, *c.points.shape)), jnp.full(lead, c.count))
    js, jt = lanes(js), lanes(jt)
    port = tuple(convert.cloud_from_numpy(np.asarray(c.points), np.asarray(c.count), device="cpu")
                 for c in (js, jt))
    return (js, jt, jg), port + (convert.transform_from_numpy(rot, trans, device="cpu"),)


def _assert_results_equal(tres, jres, tstate, jstate):
    np.testing.assert_array_equal(tres.iteration_count.numpy(), np.asarray(jres.iteration_count))
    np.testing.assert_allclose(tres.cost.numpy(), np.asarray(jres.cost), rtol=1e-9)
    np.testing.assert_allclose(tres.transform.rotation.numpy(),
                               np.asarray(jres.transform.rotation), atol=1e-9)
    np.testing.assert_allclose(tres.transform.translation.numpy(),
                               np.asarray(jres.transform.translation), atol=1e-9)
    if hasattr(jstate, "match_idx"):
        np.testing.assert_array_equal(tstate.match_idx.numpy(), np.asarray(jstate.match_idx))


def test_registry_matches_jax():
    for dim in (2, 3):
        assert T.registered_methods(dim) == J.registered_methods(dim)
    assert len(T.registered_methods(2)) + len(T.registered_methods(3)) == 15


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_scan1_converge_matches_jax(name):
    """One scan1 converge from the identity under the bench driver config."""
    a, b = _scan1()
    (js, jt, jg), (ts, tt, tg) = _sides(a, b, np.eye(2), np.zeros(2))
    cfg = FAMILIES[name]
    jres, jstate = _jax_converge(J.from_method(name, 2, J.Config(**cfg)), js, jt, jg,
                              J.DriverConfig(**BENCH))
    tres, tstate = T.converge(T.from_method(name, 2, T.Config(**cfg)), ts, tt, tg,
                              T.DriverConfig(**BENCH))
    _assert_results_equal(tres, jres, tstate, jstate)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_torus_3d_converge_matches_jax(name):
    """3D on a 300-point subsample of the in-repo torus pair, two lanes (the
    identity and a seeded perturbation)."""
    a, b = _torus()
    c, s = np.cos(0.05), np.sin(0.05)
    rot = np.stack([np.eye(3), [[c, -s, 0], [s, c, 0], [0, 0, 1]]])
    trans = np.array([[0.0, 0.0, 0.0], [0.05, -0.03, 0.02]])
    (js, jt, jg), (ts, tt, tg) = _sides(a, b, rot, trans)
    cfg = FAMILIES[name]
    jres, jstate = _jax_converge(J.from_method(name, 3, J.Config(**cfg)), js, jt, jg,
                              J.DriverConfig(**CFG_3D))
    tres, tstate = T.converge(T.from_method(name, 3, T.Config(**cfg)), ts, tt, tg,
                              T.DriverConfig(**CFG_3D))
    _assert_results_equal(tres, jres, tstate, jstate)


def _small_pair(dim, n=128, seed=0):
    """A seeded smooth curve / surface and a moved, noisy copy."""
    rng = np.random.default_rng(seed)
    if dim == 2:
        x = np.linspace(-4, 4, n)
        pts = np.column_stack([x, np.sin(x) + 0.3 * np.cos(2.3 * x)])
    else:
        xy = rng.uniform(-3, 3, (n, 2))
        pts = np.column_stack([xy, 0.4 * np.sin(xy[:, 0]) + 0.3 * np.cos(1.3 * xy[:, 1])])
    moved = pts @ T.from_angle_2d(0.08, device="cpu").rotation.numpy().T if dim == 2 else pts
    return pts, moved + rng.normal(0, 0.01, pts.shape) + 0.1


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_batched_lanes_equal_single_lanes(name, dim):
    """B = 4 lanes under different guesses against four single-lane runs."""
    a, b = _small_pair(dim, 96 if dim == 2 else 128, seed=dim)
    rng = np.random.default_rng(11)
    method = T.from_method(name, dim, T.Config(**FAMILIES[name]))
    cfg = T.DriverConfig(**CFG_3D)
    src = T.stack([T.from_points(a, device="cpu")] * 4)
    tgt = T.stack([T.from_points(b, device="cpu")] * 4)
    if dim == 2:
        guess = T.from_angle_2d(torch.tensor(rng.uniform(-0.1, 0.1, 4)),
                                torch.tensor(rng.uniform(-0.1, 0.1, (4, 2))))
    else:
        guess = T.identity(3, (4,), device="cpu")
        guess = T.RigidTransform(guess.rotation, torch.tensor(rng.uniform(-0.1, 0.1, (4, 3))))
    batched, _ = T.converge(method, src, tgt, guess, cfg)
    for lane in range(4):
        one, _ = T.converge(
            method, T.from_points(a, device="cpu"), T.from_points(b, device="cpu"),
            T.RigidTransform(guess.rotation[lane], guess.translation[lane]), cfg)
        assert int(one.iteration_count) == int(batched.iteration_count[lane])
        np.testing.assert_allclose(batched.transform.translation[lane].numpy(),
                                   one.transform.translation.numpy(), atol=1e-12)
        np.testing.assert_allclose(batched.cost[lane].numpy(), one.cost.numpy(), rtol=1e-12)


@pytest.mark.parametrize("name", ["point_to_plane", "symmetric", "gicp"])
def test_with_precomputed_fed_through_convert(name):
    """The JAX package's precomputed normals / surfel covariances, carried
    over by ``convert``, feed ``with_precomputed`` on both sides."""
    a, b = _small_pair(2, 128, seed=5)
    (js, jt, jg), (ts, tt, tg) = _sides(a, b, np.eye(2)[None].repeat(2, 0),
                                         np.array([[0.0, 0.0], [0.05, -0.04]]))
    cfg = FAMILIES[name]
    jm, tm = J.from_method(name, 2, J.Config(**cfg)), T.from_method(name, 2, T.Config(**cfg))
    ja, jb = jax.jit(jm.precompute)(js), jax.jit(jm.precompute)(jt)
    carry = convert.covariances_from_numpy if name == "gicp" else convert.normals_from_numpy
    ta, tb = (carry(np.asarray(x), device="cpu") for x in (ja, jb))
    np.testing.assert_allclose(tm.precompute(tt).numpy(), tb.numpy(), atol=1e-9)
    drv = dict(CFG_3D, max_iterations=20)
    jres, jstate = _jax_converge(jm.with_precomputed(ja, jb), js, jt, jg, J.DriverConfig(**drv))
    tres, tstate = T.converge(tm.with_precomputed(ta, tb), ts, tt, tg, T.DriverConfig(**drv))
    _assert_results_equal(tres, jres, tstate, jstate)
    with pytest.raises(ValueError):
        carry(np.zeros((4,)), device="cpu")


def _neighbour_cloud(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":  # a grid: many equal distances
        g = np.arange(6, dtype=np.float64)
        pts = np.stack(np.meshgrid(g, g), axis=-1).reshape(-1, 2)
        return pts, np.ones(len(pts), dtype=bool)
    pts = rng.uniform(-3, 3, (2, 80, 3))
    mask = np.ones((2, 80), dtype=bool)
    mask[1, 70:] = False  # padded tail
    return pts, mask


def _jax_top_k(pts, mask, k):
    """``lax.top_k``'s neighbour indices, as the JAX package's ``topk``
    selector takes them."""
    d2 = ((pts[..., :, None, :] - pts[..., None, :, :]) ** 2).sum(-1)
    d2 = jnp.where(mask[..., None, :], d2, jnp.finfo(pts.dtype).max)
    return jax.lax.top_k(-d2, k)[1]


@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("k", [1, 4, 5, 9, 200])
def test_neighbourhood_sets_and_moments_match_jax(kind, k):
    """The radix selection and the stable sort pick the same neighbour
    sets as ``lax.top_k`` (ties to the lower index); both selectors'
    moments equal the JAX package's."""
    pts, mask = _neighbour_cloud(kind, k)
    tp, tmk = torch.from_numpy(pts), torch.from_numpy(mask)
    kk = min(k, pts.shape[-2])
    d2 = nn.pairwise_sq_dists(tp, tp).masked_fill(~tmk[..., None, :], torch.finfo(tp.dtype).max)
    keep = torch.full(d2.shape[:-1], kk, dtype=torch.int32)
    sel = select.select_smallest_weights(d2, keep, torch.float64)
    order = torch.sort(d2, dim=-1, stable=True).indices[..., :kk]
    jidx = jax.jit(_jax_top_k, static_argnums=2)(jnp.asarray(pts), jnp.asarray(mask), kk)
    np.testing.assert_array_equal(np.sort(order.numpy(), -1), np.sort(np.asarray(jidx), -1))
    onehot = torch.zeros_like(sel).scatter_(-1, order, 1.0)
    assert torch.equal(sel, onehot)
    jcov, jsw = jax.jit(jp2l.neighborhood_moments, static_argnums=2)(
        jnp.asarray(pts), jnp.asarray(mask), k)
    for selector in ("select", "topk"):
        cov, sw = point_to_plane.neighborhood_moments(tp, tmk, k, selector=selector)
        np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
        np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-9, atol=1e-12)


def test_neighbourhood_moments_all_masked():
    pts = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 3)))
    for selector in ("select", "topk"):
        cov, sw = point_to_plane.neighborhood_moments(pts, torch.zeros(8, dtype=torch.bool), 4,
                                                      selector=selector)
        assert torch.equal(sw, torch.ones(8, dtype=torch.float64))
        assert torch.equal(cov, torch.zeros((8, 3, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        point_to_plane.neighborhood_moments(pts, torch.ones(8, dtype=torch.bool), 4, "heap")


@pytest.mark.parametrize("dim", [2, 3])
def test_normals_and_surfels_match_jax(dim):
    a, _ = _small_pair(dim, 100, seed=7)
    mask = np.arange(104) < 100
    pts = np.zeros((104, dim))
    pts[:100] = a
    tp, tmk, jpts, jmask = torch.from_numpy(pts), torch.from_numpy(mask), jnp.asarray(pts), \
        jnp.asarray(mask)
    want = jax.jit(jp2l.estimate_normals, static_argnums=2)(jpts, jmask, 8)
    np.testing.assert_allclose(point_to_plane.estimate_normals(tp, tmk, 8).numpy(),
                               np.asarray(want), atol=1e-9)
    want = jax.jit(jgicp.surfel_covariances, static_argnums=(2, 3))(jpts, jmask, 10, 1e-3)
    np.testing.assert_allclose(gicp.surfel_covariances(tp, tmk, 10, 1e-3).numpy(),
                               np.asarray(want), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_gicp_pieces_match_jax(dim):
    rng = np.random.default_rng(dim)
    m = rng.normal(size=(50, dim, dim))
    spd = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(dim)
    np.testing.assert_allclose(gicp._inv_spd(torch.from_numpy(spd)).numpy(),
                               np.asarray(jgicp._inv_spd(jnp.asarray(spd))), rtol=1e-12)
    a = rng.normal(size=(3, 20, dim))
    assert np.array_equal(gicp._jacobian_rows(torch.from_numpy(a), dim).numpy(),
                          np.asarray(jgicp._jacobian_rows(jnp.asarray(a), dim)))
    jac, r, w = rng.normal(size=(4, 30, dim + 1)), rng.normal(size=(4, 30)), rng.uniform(
        size=(4, 30))
    np.testing.assert_allclose(
        point_to_plane.solve_normal_equations(*map(torch.from_numpy, (jac, r, w))).numpy(),
        np.asarray(jp2l.solve_normal_equations(*map(jnp.asarray, (jac, r, w)))), rtol=1e-9)


@pytest.mark.parametrize("case", ["plain", "ties", "one", "empty", "all"])
def test_masked_median_matches_jax(case):
    rng = np.random.default_rng(len(case))
    v = rng.uniform(0, 5, (3, 17))
    mask = rng.uniform(size=(3, 17)) > 0.3
    if case == "ties":
        v = np.round(v)
    elif case == "one":
        mask[:] = False
        mask[:, 4] = True
    elif case == "empty":
        mask[1] = False
    elif case == "all":
        mask[:] = True
    got = robust.masked_median(torch.from_numpy(v), torch.from_numpy(mask))
    want = jrobust.masked_median(jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- on the card -----------------------------------------------------------


def _scan1_lanes(dev, dtype, lanes):
    a, b = _scan1()
    rng = np.random.default_rng(0)
    ang = rng.uniform(-0.05, 0.05, 256)[lanes]
    sh = rng.uniform(-0.2, 0.2, (256, 2))[lanes]
    src = T.stack([T.from_points(a, capacity=1024, dtype=dtype, device=dev)] * len(lanes))
    tgt = T.stack([T.from_points(b, capacity=1024, dtype=dtype, device=dev)] * len(lanes))
    guess = T.from_angle_2d(torch.tensor(ang, dtype=dtype, device=dev),
                            torch.tensor(sh, dtype=dtype, device=dev))
    return src, tgt, guess


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_families_on_card_agree_with_cpu(cuda_device, name):
    """Eight lanes of scan1, float32 on the card against float64 on the
    CPU: translation within 2e-3 m; K2 launched, and exact on the family's
    first query."""
    lanes = np.arange(0, 256, 32)
    method = T.from_method(name, 2, T.Config(**FAMILIES[name]))
    cfg = T.DriverConfig(**BENCH)
    src, tgt, guess = _scan1_lanes(cuda_device, torch.float32, lanes)
    q = T.apply(guess, src.points).contiguous()
    k2 = pallas_nn.nearest_neighbors_pallas(q, tgt.points, tgt.mask)
    want = nn.nearest_neighbors(q, tgt.points, tgt.mask)
    assert torch.equal(k2[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(k2[1], want[1])
    before = fused_nn.LAUNCHES
    gpu, _ = T.converge(method, src, tgt, guess, cfg)
    assert fused_nn.LAUNCHES > before
    cpu, _ = T.converge(method, *_scan1_lanes(torch.device("cpu"), torch.float64, lanes), cfg)
    dt = gpu.transform.translation.double().cpu() - cpu.transform.translation
    assert float(torch.linalg.vector_norm(dt, dim=-1).max()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["point_to_plane", "gicp"])
def test_3d_families_on_card_agree_with_cpu(cuda_device, name):
    """The full 1,800-point torus pair in 3D, float32 on the card against
    float64 on the CPU."""
    ply = os.path.join(REPO, "ex_data", "ply")
    a, b = (T.read_ply(os.path.join(ply, f)) for f in ("torus_transformed.ply", "torus.ply"))
    method = T.from_method(name, 3, T.Config(**FAMILIES[name]))
    cfg = T.DriverConfig(**CFG_3D)
    out = {}
    for dev, dtype in ((cuda_device, torch.float32), (torch.device("cpu"), torch.float64)):
        out[dev.type], _ = T.converge(
            method, T.from_points(a, dtype=dtype, device=dev),
            T.from_points(b, dtype=dtype, device=dev), T.identity(3, dtype=dtype, device=dev), cfg)
    dt = out["cuda"].transform.translation.double().cpu() - out["cpu"].transform.translation
    assert float(torch.linalg.vector_norm(dt)) <= 2e-3

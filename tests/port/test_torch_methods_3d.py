"""3D ``vanilla`` and ``trimmed``: the port against the JAX package.

Lockstep on a seeded 1,500-point subsample of the in-repo queen-scale PLY
pair, B = 2 lanes under different guesses, in float64: after every iterate
the poses agree at atol 1e-9 (as ``tests/test_ply_e2e.py`` holds the JAX
package to its oracle) and the mean neighbour distances at rtol 1e-9.  The
``cuda``-marked twins run the same methods on the card in float32 (Horn's
quaternion solver) against the CPU float64 run (SVD), and hold the NN kernel
exact against its plain version on a D = 3 input of several blocks.
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
from icp_tpu_torch import convert
from icp_tpu_torch.ops import fused_nn, pallas_nn

CFG = dict(max_iterations=100, angle_tolerance=1e-4, translation_tolerance=1e-4)


@functools.cache
def _queen_subsample(n=1500):
    ply = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "ex_data",
                       "ply")
    src = J.io.read_ply(os.path.join(ply, "queen_scale_transformed.ply"))
    dst = J.io.read_ply(os.path.join(ply, "queen_scale.ply"))
    rng = np.random.default_rng(7)
    return (src[rng.choice(len(src), n, replace=False)],
            dst[rng.choice(len(dst), n, replace=False)])


def _guesses():
    """Two lanes: the identity and a small seeded perturbation."""
    rot = np.stack([np.eye(3), _rot_z(0.02)])
    trans = np.array([[0.0, 0.0, 0.0], [0.03, -0.02, 0.01]])
    return rot, trans


def _rot_z(a):
    return np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0, 0, 1.0]])


def _both_sides(src_pts, dst_pts, rot, trans, capacity=1504):
    b = len(rot)
    js = J.from_points(src_pts, capacity=capacity, dtype=np.float64)
    jt = J.from_points(dst_pts, capacity=capacity, dtype=np.float64)
    lanes = lambda c: J.PointCloud(  # noqa: E731
        jnp.broadcast_to(c.points, (b, *c.points.shape)), jnp.full((b,), c.count))
    jax_side = (lanes(js), lanes(jt), J.RigidTransform(jnp.asarray(rot), jnp.asarray(trans)))
    port_side = tuple(
        convert.cloud_from_numpy(np.asarray(c.points), np.asarray(c.count), device="cpu")
        for c in jax_side[:2]
    ) + (convert.transform_from_numpy(rot, trans, device="cpu"),)
    return jax_side, port_side


@pytest.mark.parametrize("name", ["vanilla", "trimmed"])
def test_lockstep_with_jax_on_queen_subsample(name):
    (js, jt, jg), (ts, tt, tg) = _both_sides(*_queen_subsample(), *_guesses())
    config = {"max_distance": 1.0} if name == "trimmed" else {}
    jm, tm = J.from_method(name, 3, J.Config(config)), T.from_method(name, 3, T.Config(config))
    jstate, tstate = jm.init(js, jt, jg), tm.init(ts, tt, tg)
    np.testing.assert_allclose(tstate.c.numpy(), np.asarray(jstate.c), atol=1e-12)
    step = jax.jit(jm.iterate)
    for it in range(6):
        jstate, tstate = step(jstate), tm.iterate(tstate)
        for got, want in ((tstate.transform.rotation, jstate.transform.rotation),
                          (tstate.transform.translation, jstate.transform.translation)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9,
                                       err_msg=f"iteration {it}")
        np.testing.assert_allclose(tstate.mean_nn_dist.numpy(), np.asarray(jstate.mean_nn_dist),
                                   rtol=1e-9)
    assert tstate.source is ts and T.get_matches(tstate) is None


@pytest.mark.parametrize("name", ["vanilla", "trimmed"])
def test_guess_seeding_not_double_counted(name):
    """``tests/test_methods_3d.py::test_3d_guess_seeding_not_double_counted``:
    seeded with the exact solution, a 3D method returns it (the working copy
    starts at ``guess(source)``)."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-10, 10, (60, 3))
    c, s = np.cos(0.2), np.sin(0.2)
    rot = _rot_z(0.1) @ np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    t = np.array([1.0, -2.0, 0.5])
    b = a @ rot.T + t
    cfg = T.DriverConfig(max_iterations=10, angle_tolerance=1e-6, translation_tolerance=1e-6)
    result, _ = T.converge(T.from_method(name, 3), T.from_points(a, device="cpu"),
                           T.from_points(b, device="cpu"),
                           convert.transform_from_numpy(rot, t, device="cpu"), cfg)
    np.testing.assert_allclose(result.transform.translation.numpy(), t, atol=1e-6)
    np.testing.assert_allclose(result.transform.rotation.numpy(), rot, atol=1e-8)


@pytest.mark.parametrize("name", ["vanilla", "trimmed"])
def test_parity_cost(name):
    """Parity mode reports cost 0.0 (the reference's unfilled matches);
    ``parity=False`` reports the mean neighbour distance, as JAX does."""
    (js, jt, jg), (ts, tt, tg) = _both_sides(*_queen_subsample(300), *_guesses(), capacity=304)
    for parity in (1, 0):
        jm = J.from_method(name, 3, J.Config(parity=parity))
        tm = T.from_method(name, 3, T.Config(parity=parity))
        jstate, tstate = jm.iterate(jm.init(js, jt, jg)), tm.iterate(tm.init(ts, tt, tg))
        want, got = np.asarray(jm.cost(jstate)), tm.cost(tstate)
        if parity:
            assert torch.equal(got, torch.zeros(2, dtype=torch.float64))
        else:
            assert (got > 0).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
    init_cost = T.from_method(name, 3, T.Config(parity=0)).cost(tm.init(ts, tt, tg))
    assert (init_cost == torch.finfo(torch.float64).max).all()


def test_trimmed_empty_gate_is_identity_step():
    """No match within ``max_distance``: the step is the identity (the JAX
    package's deviation from the reference's NaN), and the mean distance
    still covers every neighbour."""
    a = np.random.default_rng(5).uniform(-1, 1, (40, 3))
    src = T.from_points(a, device="cpu")
    tgt = T.from_points(a + 100.0, device="cpu")
    guess = T.identity(3, device="cpu")
    for solver in ("svd", "quat"):
        method = T.from_method("trimmed", 3, T.Config(max_distance=1.0, solver=solver))
        state = method.iterate(method.init(src, tgt, guess))
        assert torch.equal(state.transform.rotation, torch.eye(3, dtype=torch.float64))
        assert torch.equal(state.transform.translation, torch.zeros(3, dtype=torch.float64))
        assert torch.equal(state.c, src.points)
        assert float(state.mean_nn_dist) > 1.0
    jm = J.from_method("trimmed", 3, J.Config(max_distance=1.0))
    jstate = jm.iterate(jm.init(J.from_points(a, dtype=np.float64),
                                J.from_points(a + 100.0, dtype=np.float64),
                                J.identity(3, dtype=np.float64)))
    np.testing.assert_allclose(float(state.mean_nn_dist), float(jstate.mean_nn_dist), rtol=1e-12)


def _queen_inputs(device, dtype, n=3000):
    src, dst = _queen_subsample(n)
    return (T.from_points(src, dtype=dtype, device=device),
            T.from_points(dst, dtype=dtype, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vanilla", "trimmed"])
def test_3d_on_card_agrees_with_cpu(cuda_device, name):
    """float32 on the card (K1, Horn's quaternion) against float64 on the CPU
    (plain NN, SVD): translation within 2e-3, rotation columns unit."""
    cfg = T.DriverConfig(**CFG)
    method = T.from_method(name, 3, T.Config(max_distance=1.0))
    before = fused_nn.COORD_LAUNCHES
    gpu, _ = T.converge(method, *_queen_inputs(cuda_device, torch.float32),
                        T.identity(3, device=cuda_device), cfg)
    assert fused_nn.COORD_LAUNCHES > before
    cpu, _ = T.converge(method, *_queen_inputs("cpu", torch.float64),
                        T.identity(3, device="cpu"), cfg)
    dt = gpu.transform.translation.double().cpu() - cpu.transform.translation
    assert float(torch.linalg.vector_norm(dt)) <= 2e-3
    cols = torch.linalg.vector_norm(gpu.transform.rotation.double(), dim=-2)
    assert float((cols - 1).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_nn_kernel_exact_on_queen_subsample(cuda_device):
    """K1 and K2 at a D = 3 shape of several query blocks (N > 512), on PLY
    points, bit-exact against the plain version."""
    src, dst = _queen_inputs(cuda_device, torch.float32)
    q, t = src.points[None].contiguous(), dst.points[None].contiguous()
    mask = dst.mask[None].contiguous()
    got = fused_nn.fused_nearest_neighbors(q, t, mask, return_coords=True)
    got2 = pallas_nn.nearest_neighbors_pallas(q, t, mask)
    want = fused_nn.plain_fused_nearest_neighbors(q, t, mask, return_coords=True)
    for a, b in ((got, want), (got2, want[:2])):
        assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
        assert torch.equal(a[1], b[1])
    assert torch.equal(got[2], want[2])

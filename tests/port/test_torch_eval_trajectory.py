"""``icp_tpu_torch.eval`` and ``icp_tpu_torch.io.trajectory`` against the
JAX package: ATE (every alignment), RPE and the Umeyama fit equal on the
same seeded trajectories (both are host numpy in float64); TUM files
written by the port equal the JAX package's byte for byte, read back to
1e-9, and a file the JAX package wrote reads into the port's poses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
from icp_tpu import eval as jeval
from icp_tpu.io import trajectory as jtraj
from icp_tpu_torch import convert
from icp_tpu_torch import eval as ev
from icp_tpu_torch.io import read_tum, write_tum

RESULTS = ("rmse", "mean", "median", "max", "errors", "rotation", "translation", "scale")


def _trajectory(rng, dim, steps=40):
    """A random-walk trajectory as (rotations, translations)."""
    trans = np.cumsum(rng.normal(0, 0.3, (steps, dim)), axis=0)
    if dim == 2:
        th = np.cumsum(rng.normal(0, 0.1, steps))
        rots = np.stack([[[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]] for t in th])
    else:
        rots = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(steps)])
        rots[np.linalg.det(rots) < 0, :, 0] *= -1
    return rots, trans


def _pair(seed, dim):
    """(port estimate, port ground truth, JAX estimate, JAX ground truth):
    the ground truth moved by a rigid transform plus noise."""
    rng = np.random.default_rng(seed)
    rots, trans = _trajectory(rng, dim)
    gauge_r, _ = _trajectory(rng, dim, 1)
    est_r = np.einsum("ij,tjk->tik", gauge_r[0], rots)
    est_t = trans @ gauge_r[0].T + 2.0 + rng.normal(0, 0.05, trans.shape)
    port = (convert.transform_from_numpy(est_r, est_t, device="cpu"),
            convert.transform_from_numpy(rots, trans, device="cpu"))
    jax = (J.geometry.RigidTransform(jnp.asarray(est_r), jnp.asarray(est_t)),
           J.geometry.RigidTransform(jnp.asarray(rots), jnp.asarray(trans)))
    return (*port, *jax)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("align", ["umeyama", "sim", "first", "none"])
def test_ate_matches_jax(dim, align):
    est, gt, jest, jgt = _pair(dim, dim)
    got, want = ev.ate(est, gt, align=align), jeval.ate(jest, jgt, align=align)
    for name in RESULTS:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    assert got.as_dict() == pytest.approx(want.as_dict(), rel=1e-9)


@pytest.mark.parametrize("dim, delta", [(2, 1), (3, 1), (2, 5)])
def test_rpe_matches_jax(dim, delta):
    est, gt, jest, jgt = _pair(10 + dim, dim)
    got, want = ev.rpe(est, gt, delta=delta), jeval.rpe(jest, jgt, delta=delta)
    for name in ("trans_errors", "rot_errors", "trans_rmse", "rot_rmse_rad", "trans_max"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    assert got.as_dict() == pytest.approx(want.as_dict(), rel=1e-9)


def test_umeyama_and_errors_match_jax():
    rng = np.random.default_rng(7)
    src = rng.normal(size=(30, 3))
    tgt = 1.7 * src @ _trajectory(rng, 3, 1)[0][0].T + 0.4
    for with_scale in (False, True):
        for g, w in zip(ev.umeyama_alignment(src, tgt, with_scale),
                        jeval.umeyama_alignment(src, tgt, with_scale)):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)
    est, gt, _, _ = _pair(3, 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        ev.ate(est.translation[:-1], gt)
    with pytest.raises(ValueError, match="needs rotations"):
        ev.rpe(est.translation, gt)
    with pytest.raises(ValueError, match="delta"):
        ev.rpe(est, gt, delta=0)


@pytest.mark.parametrize("dim", [2, 3])
def test_tum_written_equal_to_jax_and_read_back(tmp_path, dim):
    est, _, jest, _ = _pair(20 + dim, dim)
    stamps = np.linspace(0, 4, est.translation.shape[0])
    write_tum(str(tmp_path / "port.txt"), est, timestamps=stamps)
    jtraj.write_tum(str(tmp_path / "jax.txt"), jest, timestamps=stamps)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    got_stamps, got = read_tum(str(tmp_path / "jax.txt"), dim=dim, device="cpu")
    want_stamps, want = jtraj.read_tum(str(tmp_path / "jax.txt"), dim=dim)
    np.testing.assert_array_equal(got_stamps, want_stamps)
    assert got.rotation.dtype == torch.float64 and got.rotation.device.type == "cpu"
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-12)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-12)
    # The round trip keeps the poses to the file's 9 significant digits.
    np.testing.assert_allclose(got.rotation.numpy(), est.rotation.numpy(), atol=1e-8)
    np.testing.assert_allclose(got.translation.numpy(), est.translation.numpy(), atol=1e-7)


@pytest.mark.cuda
def test_eval_and_tum_on_card(cuda_device, tmp_path):
    est, gt, _, _ = _pair(5, 3)
    on_card = convert.transform_from_numpy(est.rotation.numpy(), est.translation.numpy(),
                                           device=cuda_device)
    assert ev.ate(on_card, gt).rmse == pytest.approx(ev.ate(est, gt).rmse, rel=1e-6)
    write_tum(str(tmp_path / "t.txt"), on_card)
    _, back = read_tum(str(tmp_path / "t.txt"), device=cuda_device)
    assert back.rotation.device.type == "cuda" and back.rotation.dtype == torch.float32

"""``icp_tpu_torch.odometry`` against the JAX package, float64 on the CPU.

* ``compose_chain`` (a doubling scan here, an ``associative_scan`` there)
  to 1e-12;
* ``chain_scans`` on the first 14 sweeps of ``ex_data/seq1``: relative
  poses to 1e-9 and iteration counts exact, plain, with ``coarse=``, with
  ``multiscale=``, and through the per-scan precompute cache (gicp,
  point_to_plane), which also equals the uncached per-pair converge;
* ``select_keyframes`` indices exact;
* ``stream_odometry`` and ``stream_odometry_pipelined``: poses to 1e-9 and
  keyframe flags and iteration counts exact; the pipelined stream also
  equals a serial implementation of its deferred-promotion semantics (the
  JAX package's ``test_stream_pipelined_matches_serial_reference``).

The ``cuda``-marked twins run the chain and both streams on the card in
float32 against the CPU float64 run (gate 2e-3 m, flags equal).
"""

import glob
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu import odometry as jodo
from icp_tpu_torch import convert, geometry, odometry
from icp_tpu_torch.ops import fused_nn
from icp_tpu_torch.utils.metrics import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEQ1 = os.path.join(REPO, "ex_data", "seq1")
CHAIN = dict(max_iterations=150, angle_tolerance=1e-6, translation_tolerance=1e-6)
BENCH = dict(max_iterations=50, angle_tolerance=0.1 * np.pi / 180, translation_tolerance=0.01)
GATE_M = 2e-3


@pytest.fixture(scope="module")
def seq1():
    """The first 14 seq1 sweeps as (points, counts) at one capacity, and the
    ground-truth poses (x, y, theta)."""
    paths = sorted(glob.glob(os.path.join(SEQ1, "sweep_*.conf")))[:14]
    arrays = [T.io.sweep_to_points(T.io.parse_sweep_conf(p)) for p in paths]
    cap = T.cloud.round_up(max(len(a) for a in arrays), 8)
    pts = np.zeros((len(arrays), cap, 2))
    for i, a in enumerate(arrays):
        pts[i, : len(a)] = a
    with open(os.path.join(SEQ1, "groundtruth.json")) as f:
        gt = np.asarray(json.load(f)["poses"])[: len(paths)]
    return pts, np.array([len(a) for a in arrays], dtype=np.int32), gt


def _stacks(pts, counts):
    return (convert.cloud_from_numpy(pts, counts, device="cpu"),
            J.cloud.PointCloud(jnp.asarray(pts), jnp.asarray(counts)))


def _assert_traj(got, want, atol=1e-9):
    np.testing.assert_allclose(got.relative.rotation.numpy(), np.asarray(want.relative.rotation),
                               atol=atol)
    np.testing.assert_allclose(got.relative.translation.numpy(),
                               np.asarray(want.relative.translation), atol=atol)
    np.testing.assert_allclose(got.poses.translation.numpy(), np.asarray(want.poses.translation),
                               atol=atol)
    np.testing.assert_array_equal(got.registration.iteration_count.numpy(),
                                  np.asarray(want.registration.iteration_count))


@pytest.mark.parametrize("dim, steps", [(2, 37), (3, 16), (2, 1)])
def test_compose_chain_matches_jax(dim, steps):
    rng = np.random.default_rng(dim * 100 + steps)
    rots = np.stack([np.linalg.qr(rng.normal(size=(dim, dim)))[0] for _ in range(steps)])
    rots[np.linalg.det(rots) < 0, :, 0] *= -1
    trans = rng.normal(size=(steps, dim))
    rel = convert.transform_from_numpy(rots, trans, device="cpu")
    init = convert.transform_from_numpy(rots[0], trans[0] + 1.0, device="cpu")
    got = odometry.compose_chain(rel, init)
    want = jax.jit(jodo.compose_chain)(
        J.geometry.RigidTransform(jnp.asarray(rots), jnp.asarray(trans)),
        J.geometry.RigidTransform(jnp.asarray(rots[0]), jnp.asarray(trans[0] + 1.0)))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-12)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-12)
    # And the serial definition: poses[t + 1] = poses[t] ∘ inv(relative[t]).
    pose = init
    for t in range(steps):
        step = geometry.inverse(convert.transform_from_numpy(rots[t], trans[t], device="cpu"))
        pose = geometry.compose(pose, step)
    np.testing.assert_allclose(got.translation[-1].numpy(), pose.translation.numpy(), atol=1e-12)


@pytest.mark.parametrize("mode", ["plain", "coarse", "multiscale"])
def test_chain_scans_seq1_matches_jax(seq1, mode):
    pts, counts, gt = seq1
    scans, jscans = _stacks(pts, counts)
    kw = {} if mode == "plain" else {mode: True}
    got = odometry.chain_scans(scans, T.from_method("trimmed", 2), T.DriverConfig(**CHAIN), **kw)
    want = jodo.chain_scans(jscans, J.from_method("trimmed", 2), J.DriverConfig(**CHAIN), **kw)
    _assert_traj(got, want)
    # Each step within 3 cm of the ground-truth motion (the JAX package's
    # tests/test_seq1_odometry.py bound).
    motion = geometry.inverse(got.relative).translation.numpy()
    c, s = np.cos(gt[:-1, 2]), np.sin(gt[:-1, 2])
    dx, dy = np.diff(gt[:, 0]), np.diff(gt[:, 1])
    truth = np.stack([c * dx + s * dy, -s * dx + c * dy], -1)
    assert np.linalg.norm(motion - truth, axis=-1).max() < 0.03


@pytest.mark.parametrize("name", ["gicp", "point_to_plane"])
def test_chain_scans_precompute_cache_matches_jax(seq1, name):
    """One precompute for the stack, sliced into sources and targets: equal
    to JAX's chain and to the uncached per-pair converge."""
    pts, counts, _ = seq1
    scans, jscans = _stacks(pts, counts)
    cfg = dict(CHAIN, max_iterations=30)
    method = T.from_method(name, 2)
    assert method.precompute is not None and method.with_precomputed is not None
    got = odometry.chain_scans(scans, method, T.DriverConfig(**cfg))
    want = jodo.chain_scans(jscans, J.from_method(name, 2), J.DriverConfig(**cfg))
    _assert_traj(got, want)
    sources = T.PointCloud(scans.points[:-1], scans.count[:-1])
    targets = T.PointCloud(scans.points[1:], scans.count[1:])
    uncached, _ = T.converge(method, sources, targets,
                             T.identity(2, (len(counts) - 1,), device="cpu"),
                             T.DriverConfig(**cfg))
    torch.testing.assert_close(got.relative.translation, uncached.transform.translation,
                               atol=1e-12, rtol=0)


def test_select_keyframes_matches_jax(seq1):
    pts, counts, _ = seq1
    scans, jscans = _stacks(pts, counts)
    traj = odometry.chain_scans(scans, T.from_method("trimmed", 2), T.DriverConfig(**BENCH))
    jtraj = jodo.Trajectory(
        poses=J.geometry.RigidTransform(jnp.asarray(traj.poses.rotation.numpy()),
                                        jnp.asarray(traj.poses.translation.numpy())),
        relative=None, registration=None)
    for tt, ta in ((0.3, 0.1), (1.0, 0.05), (100.0, 100.0)):
        got = odometry.select_keyframes(traj, tt, ta)
        np.testing.assert_array_equal(got, jodo.select_keyframes(jtraj, tt, ta))
        assert got[0] == 0 and got[-1] == len(counts) - 1


def _stream_scans(pts, counts):
    clouds = [convert.cloud_from_numpy(p, c, device="cpu") for p, c in zip(pts, counts)]
    jclouds = [J.cloud.PointCloud(jnp.asarray(p), jnp.asarray(c)) for p, c in zip(pts, counts)]
    return clouds, jclouds


@pytest.mark.parametrize("variant", ["stream_odometry", "stream_odometry_pipelined"])
def test_streams_match_jax(seq1, variant):
    pts, counts, _ = seq1
    clouds, jclouds = _stream_scans(pts, counts)
    method, cfg = T.from_method("trimmed", 2, T.Config(overlap_rate=0.9)), T.DriverConfig(**BENCH)
    sink = io.StringIO()
    with MetricsLogger(sink) as log:
        got = list(getattr(odometry, variant)(clouds, method, cfg, 0.5, 0.05, metrics=log))
    want = list(getattr(jodo, variant)(jclouds, J.from_method("trimmed", 2, J.Config(
        overlap_rate=0.9)), J.DriverConfig(**BENCH), 0.5, 0.05))
    flags = [bool(f) for _, f, _ in got]
    assert flags == [bool(f) for _, f, _ in want]
    assert 2 < sum(flags) < len(flags)  # promotions happen, not on every scan
    assert got[0][2] is None and want[0][2] is None
    for (p, _, r), (jp, _, jr) in zip(got[1:], want[1:]):
        np.testing.assert_allclose(p.translation.numpy(), np.asarray(jp.translation), atol=1e-9)
        np.testing.assert_allclose(p.rotation.numpy(), np.asarray(jp.rotation), atol=1e-9)
        assert int(r.iteration_count) == int(jr.iteration_count)
    records = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert [r["keyframe"] for r in records] == flags[1:]
    assert all(r["event"] == "odometry_step" for r in records)


def test_stream_pipelined_matches_serial_reference(seq1):
    """Deferred promotion exactly: a promotion decided at scan t takes
    effect from scan t + 2; the serial reference synchronizes every step
    through ``stream_step`` before it looks at the next scan."""
    pts, counts, _ = seq1
    clouds, _ = _stream_scans(pts, counts)
    method, cfg = T.from_method("trimmed", 2, T.Config(overlap_rate=0.9)), T.DriverConfig(**BENCH)
    tt, ta = 0.5, 0.05
    out = list(odometry.stream_odometry_pipelined(clouds, method, cfg, tt, ta))
    assert len(out) == len(clouds) and out[0][1] is True and out[0][2] is None
    fn = T.make_converge_fn(method, cfg)
    keyframe, kf_pose = clouds[0], T.identity(2, device="cpu")
    ref, pending = [(kf_pose, True, None)], None
    for scan in clouds[1:]:
        pose, is_kf, result = odometry.stream_step(fn, keyframe, kf_pose, scan, tt, ta)
        if pending is not None:
            p_scan, p_pose, p_is_kf, p_result = pending
            if p_is_kf:
                keyframe, kf_pose = p_scan, p_pose
            ref.append((p_pose, p_is_kf, p_result))
        pending = (scan, pose, is_kf, result)
    ref.append(pending[1:])
    for t in range(1, len(clouds)):
        assert torch.equal(out[t][0].translation, ref[t][0].translation), t
        assert torch.equal(out[t][0].rotation, ref[t][0].rotation), t
        assert out[t][1] == ref[t][1], t
        assert int(out[t][2].iteration_count) == int(ref[t][2].iteration_count), t


def test_relative_pose_and_errors(seq1):
    pts, counts, _ = seq1
    scans, _ = _stacks(pts[:4], counts[:4])
    traj = odometry.chain_scans(scans, T.from_method("trimmed", 2), T.DriverConfig(**BENCH))
    rel = odometry.relative_pose(traj.poses, 1, 2)
    torch.testing.assert_close(rel.translation,
                               geometry.inverse(traj.relative).translation[1], atol=1e-12,
                               rtol=0)
    with pytest.raises(ValueError, match="two scans"):
        odometry.chain_scans(T.PointCloud(scans.points[:1], scans.count[:1]),
                             T.from_method("trimmed", 2), T.DriverConfig(**BENCH))


# --- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "coarse", "multiscale"])
def test_chain_scans_on_card_agrees_with_cpu(cuda_device, seq1, mode):
    pts, counts, _ = seq1
    kw = {} if mode == "plain" else {mode: True}
    gpu_scans = convert.cloud_from_numpy(pts, counts, device=cuda_device, dtype=torch.float32)
    fused_nn.LAUNCHES = fused_nn.COORD_LAUNCHES = 0
    gpu = odometry.chain_scans(gpu_scans, T.from_method("trimmed", 2), T.DriverConfig(**CHAIN),
                               **kw)
    assert fused_nn.COORD_LAUNCHES > 0 and fused_nn.LAUNCHES > fused_nn.COORD_LAUNCHES
    cpu = odometry.chain_scans(_stacks(pts, counts)[0], T.from_method("trimmed", 2),
                               T.DriverConfig(**CHAIN), **kw)
    dt = torch.linalg.vector_norm(gpu.poses.translation.double().cpu() - cpu.poses.translation,
                                  dim=-1)
    assert float(dt.max()) <= GATE_M


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["stream_odometry", "stream_odometry_pipelined"])
def test_streams_on_card_agree_with_cpu(cuda_device, seq1, variant):
    pts, counts, _ = seq1
    method, cfg = T.from_method("trimmed", 2, T.Config(overlap_rate=0.9)), T.DriverConfig(**BENCH)
    gpu_clouds = [convert.cloud_from_numpy(p, c, device=cuda_device, dtype=torch.float32)
                  for p, c in zip(pts, counts)]
    gpu = list(getattr(odometry, variant)(gpu_clouds, method, cfg, 0.5, 0.05))
    cpu = list(getattr(odometry, variant)(_stream_scans(pts, counts)[0], method, cfg, 0.5, 0.05))
    assert [f for _, f, _ in gpu] == [f for _, f, _ in cpu]
    for (p, _, _), (q, _, _) in zip(gpu, cpu):
        assert float(torch.linalg.vector_norm(p.translation.double().cpu()
                                              - q.translation)) <= GATE_M
